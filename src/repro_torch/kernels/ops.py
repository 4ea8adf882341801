"""Public ops the models call (attention and the SSD scan), dispatched by
the tensors' device.

* a CPU tensor goes to the kernel's plain PyTorch version;
* a CUDA tensor goes to the hand-written CUDA kernel, or the call raises.

No environment variable or flag selects the plain version for a CUDA
tensor.  The block knobs of ``repro.kernels.ops`` (tune-cache lookups)
have no counterpart yet: each kernel uses its built-in tiles, and
``ssd_scan`` takes the chunk its caller passes (the model's
``cfg.ssm.chunk``).
"""
from __future__ import annotations

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import ssd_scan as _ssd


def flash_attention(q, k, v, *, causal: bool = True, scale: float | None = None,
                    q_offset: int = 0):
    """GQA flash attention. q: [B,Sq,H,D], k/v: [B,Sk,K,D|Dv] -> [B,Sq,H,Dv].

    Differentiable on both devices (the backward is a kernel on the card)."""
    return _flash.flash_attention(q, k, v, causal=causal, scale=scale,
                                  q_offset=q_offset)


def decode_attention(q, k, v, kv_len, *, scale: float | None = None):
    """Sq=1 GQA decode attention over a ragged KV cache.

    q: [B,H,D], k/v: [B,Sk,K,D|Dv], kv_len: [B] int32 -> [B,H,Dv]."""
    return _decode.decode_attention(q, k, v, kv_len, scale=scale)


def decode_attention_paged(q, k_pool, v_pool, page_table, kv_len, *,
                           scale: float | None = None):
    """Sq=1 GQA decode attention against a paged KV pool.

    q: [B,H,D], k_pool/v_pool: [P,ps,K,D|Dv], page_table: [B,W] int32,
    kv_len: [B] int32 -> [B,H,Dv]."""
    return _decode.decode_attention_paged(q, k_pool, v_pool, page_table,
                                          kv_len, scale=scale)


def ssd_scan(x, dt, A, Bm, Cm, *, chunk: int, h0=None,
             return_final_state: bool = False):
    """Mamba-2 SSD chunked scan (see ``ref.ssd_chunked_ref``).

    x: [B,S,H,P], dt: [B,S,H], A: [H], Bm/Cm: [B,S,G,N], h0: [B,H,P,N]
    -> y [B,S,H,P] (and the fp32 final state if requested).

    Differentiable on both devices (the backward is a kernel on the card)."""
    return _ssd.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, h0=h0,
                         return_final_state=return_final_state)


# every kernel wrapper that counts its launches (``.launches``); a CUDA
# graph replays launches that no wrapper call counts, so the serving
# engine adds each replay's share to these counts itself
COUNTED = (_flash.flash_attention, _flash.flash_attention_bwd,
           _decode.decode_attention, _decode.decode_attention_paged,
           _ssd.ssd_scan, _ssd.ssd_scan_bwd)
