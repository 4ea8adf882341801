"""Public ops the models call (attention and the SSD scan), dispatched by
the tensors' device.

* a CPU tensor goes to the kernel's plain PyTorch version;
* a CUDA tensor goes to the hand-written CUDA kernel, or the call raises.

No environment variable or flag selects the plain version for a CUDA
tensor.

Tuned-config plumbing (``repro_torch.tune``), as ``repro.kernels.ops``
does it: every tile knob defaults to ``None``, meaning "consult the
persistent best-config cache for this (kernel, shape bucket, dtype,
route), else use the built-in default".  An explicit argument always wins;
a cached value is re-validated by the kernel's own tile check (the one
``repro_torch.tune.space.valid`` calls), so a stale or foreign entry
falls back to the default; a miss, including no cache file at all,
launches exactly what the kernel launched before it had knobs.  The
resolution runs on both devices (the route is part of the key: ``cpu``
entries steer nothing on a card); the plain versions ignore the tiles,
and the SSD scan's plain version takes the chunk.
"""
from __future__ import annotations

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.tune import cache as _tune_cache


def _tuned(kernel: str, shape: dict, t) -> dict:
    """Best-config cache lookup for tensors like ``t`` (empty dict on any
    miss)."""
    return _tune_cache.best_config(kernel, shape, t.dtype, t.device) or {}


def flash_attention(q, k, v, *, causal: bool = True, scale: float | None = None,
                    q_offset: int = 0, block_q: int | None = None,
                    block_k: int | None = None):
    """GQA flash attention. q: [B,Sq,H,D], k/v: [B,Sk,K,D|Dv] -> [B,Sq,H,Dv].

    ``block_q``/``block_k``: explicit value > tuned cache > (64, 64).
    Differentiable on both devices (the backward is a kernel on the card)."""
    if block_q is None or block_k is None:
        B, _, H, D = q.shape
        Sk, K = k.shape[1], k.shape[2]
        cfg = _tuned("flash_attention",
                     {"b": B, "s": Sk, "h": H, "kvh": K, "d": D}, q)
        tile = (cfg.get("block_q", _flash.DEFAULT_BLOCK_Q) if block_q is None
                else block_q,
                cfg.get("block_k", _flash.DEFAULT_BLOCK_K) if block_k is None
                else block_k)
        if not _flash.tiles_ok(D, v.shape[3], q.dtype, *tile):
            # a tuned value the kernel cannot take: its default instead
            tile = (_flash.DEFAULT_BLOCK_Q if block_q is None else block_q,
                    _flash.DEFAULT_BLOCK_K if block_k is None else block_k)
        block_q, block_k = tile
    return _flash.flash_attention(q, k, v, causal=causal, scale=scale,
                                  q_offset=q_offset, block_q=block_q,
                                  block_k=block_k)


def decode_attention(q, k, v, kv_len, *, scale: float | None = None,
                     block_k: int | None = None):
    """Sq=1 GQA decode attention over a ragged KV cache.

    q: [B,H,D], k/v: [B,Sk,K,D|Dv], kv_len: [B] int32 -> [B,H,Dv].
    ``block_k``, the keys of a split: explicit > tuned > ``split_plan``'s."""
    if block_k is None:
        B, H, D = q.shape
        Sk, K = k.shape[1], k.shape[2]
        cfg = _tuned("decode_attention",
                     {"b": B, "sk": Sk, "h": H, "kvh": K, "d": D}, q)
        if "block_k" in cfg and _decode.split_ok(Sk, cfg["block_k"]):
            block_k = cfg["block_k"]
    return _decode.decode_attention(q, k, v, kv_len, scale=scale,
                                    block_k=block_k)


def decode_attention_paged(q, k_pool, v_pool, page_table, kv_len, *,
                           scale: float | None = None):
    """Sq=1 GQA decode attention against a paged KV pool.

    q: [B,H,D], k_pool/v_pool: [P,ps,K,D|Dv], page_table: [B,W] int32,
    kv_len: [B] int32 -> [B,H,Dv].  The page geometry is fixed by the pool
    the caller built: the tuned ``page_size`` is consumed where the pool is
    made (``serve/engine.py``)."""
    return _decode.decode_attention_paged(q, k_pool, v_pool, page_table,
                                          kv_len, scale=scale)


def ssd_scan(x, dt, A, Bm, Cm, *, chunk: int | None = None, h0=None,
             return_final_state: bool = False):
    """Mamba-2 SSD chunked scan (see ``ref.ssd_chunked_ref``).

    x: [B,S,H,P], dt: [B,S,H], A: [H], Bm/Cm: [B,S,G,N], h0: [B,H,P,N]
    -> y [B,S,H,P] (and the fp32 final state if requested).

    ``chunk``: explicit value > tuned cache > 64.  Models pass their
    config's chunk; ``None`` opts into the tuned one.  Differentiable on
    both devices (the backward is a kernel on the card)."""
    if chunk is None:
        B, S, H, P = x.shape
        G, N = Bm.shape[2], Bm.shape[3]
        cfg = _tuned("ssd_scan",
                     {"b": B, "s": S, "h": H, "p": P, "g": G, "n": N}, x)
        chunk = cfg.get("chunk", _ssd.DEFAULT_CHUNK)
        if not _ssd.chunk_ok(chunk):
            chunk = _ssd.DEFAULT_CHUNK
    return _ssd.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, h0=h0,
                         return_final_state=return_final_state)


# every kernel wrapper that counts its launches (``.launches``); a CUDA
# graph replays launches that no wrapper call counts, so the serving
# engine adds each replay's share to these counts itself
COUNTED = (_flash.flash_attention, _flash.flash_attention_bwd,
           _decode.decode_attention, _decode.decode_attention_paged,
           _ssd.ssd_scan, _ssd.ssd_scan_bwd)
