"""Sq=1 GQA decode attention over a ragged KV cache, dense or paged: the
wrappers around the CUDA kernel ``csrc/decode_attention.cu`` (which
replaces the Pallas TPU kernels ``decode_attention`` and
``decode_attention_paged`` of ``repro/kernels/decode_attention.py``) and
their plain PyTorch versions.

Each wrapper takes its plain version for tensors on the CPU, and only
then; for CUDA tensors it launches the kernel or raises.  The kernel stops
at each slot's ``kv_len``, so no padding is needed, and ``kv_len = 0``
gives 0 (the plain versions give NaN there; the engine always passes
``kv_len >= 1``).  The paged kernel reads only the pages a slot's table
maps below its ``kv_len``, with sentinel entries clamped into the pool.

The kernel splits each slot's key axis across blocks (``split_plan``) and
merges the splits' partials in the same launch: the wrapper hands it an
fp32 scratch for the partials and a per-(slot, KV head) counter buffer,
zeroed once per device and stream and left zeroed by every call.  Inside
a CUDA graph capture the counters are read from this dict only: a caller
that captures on a stream first runs the same call on that stream (the
serving engine's warm-up), so that they are allocated outside the graph's
memory pool.  The scratch is allocated inside the call and so lands in
the graph's pool, which only the graph uses.  A replay launches the kernel
without calling the wrapper, so ``launches`` counts a replay only when the
replaying code adds it (the engine does).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda_build
from repro_torch.kernels.grad_guard import refuse_grad
from repro_torch.kernels.ref import (decode_attention_paged_ref,
                                    decode_attention_ref)

# query heads per KV head: the kernel is instantiated for group caps 8, 16
# and 64 and takes the least that holds G (csrc/decode_attention.cu)
MAX_GROUP = 64
MAX_D = 256
MAX_DV = 128
MAX_PAGES_PER_SLOT = 1024   # page-table width W
SPLIT_TILE = 64    # keys a block stages at a time; a split is a multiple
MAX_SPLITS = 64
TABLE_MAX = 66     # page-table entries one split may span (kTableMax)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_NO_BWD = ("ROADMAP Queue B, B2/B3: the decode kernels are forward-only, "
           "since only serving runs them")
# (device, stream) -> int32 counters, all 0 between calls
_COUNTERS: dict = {}


def split_plan(keys: int) -> tuple[int, int]:
    """(L, S) for a key axis of ``keys`` rows (Sk dense, W * ps paged): L
    keys per split, the least multiple of ``SPLIT_TILE`` that needs no more
    than ``MAX_SPLITS`` splits, and S = ceil(keys / L) splits (at least 1).
    From shapes only, so the caller never reads ``kv_len`` on the host."""
    tiles = max(1, -(-keys // SPLIT_TILE))
    L = -(-tiles // MAX_SPLITS) * SPLIT_TILE
    return L, max(1, -(-keys // L))


def split_ok(keys: int, L: int, ps: int | None = None) -> bool:
    """Whether the kernel takes splits of ``L`` keys over a key axis of
    ``keys`` rows (paged: pages of ``ps`` rows): L a positive multiple of
    ``SPLIT_TILE``, at most ``MAX_SPLITS`` splits, and a split's keys
    spanning at most ``TABLE_MAX`` page-table entries.  The dense knob
    ``block_k`` is this L (``split_plan``'s by default); the wrappers check
    it on both devices and ``repro_torch.tune.space.valid`` mirrors it."""
    L = int(L)
    if L <= 0 or L % SPLIT_TILE or -(-int(keys) // L) > MAX_SPLITS:
        return False
    return ps is None or (L - 1) // int(ps) + 2 <= TABLE_MAX


def pages_ok(sk: int, ps: int) -> bool:
    """Whether the paged kernel takes a pool of ``ps``-row pages for slots
    of ``sk`` rows: 0 < ps <= sk, at most ``MAX_PAGES_PER_SLOT`` pages a
    slot, and ``split_plan``'s splits over them within ``TABLE_MAX``
    entries (the engine's tuned ``page_size`` is held to this)."""
    ps, sk = int(ps), int(sk)
    if not 0 < ps <= sk:
        return False
    w = -(-sk // ps)
    return w <= MAX_PAGES_PER_SLOT and split_ok(w * ps, split_plan(w * ps)[0],
                                                ps)


def _counters(device, n: int):
    """The kernel's per-(slot, KV head) counters on ``device`` for the
    current stream, grown (zeroed) when ``n`` exceeds them."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        size = max(n, 2 * buf.numel() if buf is not None else 0)
        buf = _COUNTERS[key] = torch.zeros(size, dtype=torch.int32,
                                           device=device)
    return buf


def _scratch(q, B: int, K: int, S: int, Dv: int):
    """fp32 partials [B, K, S, G, Dv + 2]; none is needed with one split."""
    G = q.shape[1] // K
    n = B * K * S * G * (Dv + 2) if S > 1 else 1
    return torch.empty(n, dtype=torch.float32, device=q.device)

# the plain PyTorch versions the kernel is held against
decode_attention_plain = decode_attention_ref
decode_attention_paged_plain = decode_attention_paged_ref


def _check_common(what, q, k, v, kv_len, extra=()):
    """Checks both layouts share; k/v are [rows, ..., K, D|Dv]."""
    dev = q.device
    if not (q.is_cuda and all(t.device == dev for t in (k, v, kv_len, *extra))):
        raise ValueError(f"{what} kernel: all inputs must be on one CUDA "
                         "device")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{what} kernel takes float32 or bfloat16 q/k/v of "
                        f"one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if kv_len.dtype != torch.int32:
        raise TypeError(f"{what}: kv_len must be int32, got {kv_len.dtype}")
    B, H, D = q.shape
    K = k.shape[2]
    if tuple(kv_len.shape) != (B,):
        raise ValueError(f"{what}: kv_len {tuple(kv_len.shape)} for B={B}")
    if K == 0 or H % K or H // K > MAX_GROUP:
        raise ValueError(f"{what} kernel: H={H}, K={K} needs "
                         f"H % K == 0 and H // K <= {MAX_GROUP}")
    if D % 8 or D > MAX_D or v.shape[3] > MAX_DV:
        raise ValueError(f"{what} kernel: D={D} (multiple of 8, <= "
                         f"{MAX_D}) and Dv={v.shape[3]} (<= {MAX_DV})")
    if not all(t.is_contiguous() for t in (q, k, v, kv_len, *extra)):
        raise ValueError(f"{what} kernel: inputs must be contiguous")
    if k.data_ptr() % 16:
        raise ValueError(f"{what} kernel: k must be 16-byte aligned")


def _check(q, k, v, kv_len):
    if q.ndim != 3 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("decode_attention: q [B,H,D], k/v [B,Sk,K,D|Dv]")
    B, _, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or v.shape[:3] != (B, Sk, K):
        raise ValueError(f"decode_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    _check_common("decode_attention", q, k, v, kv_len)


def _check_paged(q, k_pool, v_pool, page_table, kv_len):
    if q.ndim != 3 or k_pool.ndim != 4 or v_pool.ndim != 4 \
            or page_table.ndim != 2:
        raise ValueError("decode_attention_paged: q [B,H,D], pools "
                         "[P,ps,K,D|Dv], page_table [B,W]")
    B, _, D = q.shape
    P, ps, K = k_pool.shape[:3]
    if k_pool.shape[3] != D or v_pool.shape[:3] != (P, ps, K) \
            or page_table.shape[0] != B:
        raise ValueError(f"decode_attention_paged: shapes q {tuple(q.shape)},"
                         f" k_pool {tuple(k_pool.shape)}, v_pool "
                         f"{tuple(v_pool.shape)}, page_table "
                         f"{tuple(page_table.shape)} disagree")
    if page_table.dtype != torch.int32:
        raise TypeError(f"decode_attention_paged: page_table must be int32, "
                        f"got {page_table.dtype}")
    if not 0 < page_table.shape[1] <= MAX_PAGES_PER_SLOT:
        raise ValueError(f"decode_attention_paged kernel: W="
                         f"{page_table.shape[1]} pages per slot (1.."
                         f"{MAX_PAGES_PER_SLOT})")
    keys = page_table.shape[1] * ps
    if not split_ok(keys, split_plan(keys)[0], ps):
        raise ValueError(f"decode_attention_paged kernel: a split of "
                         f"{split_plan(keys)[0]} keys spans more than "
                         f"{TABLE_MAX} pages of {ps} rows")
    _check_common("decode_attention_paged", q, k_pool, v_pool, kv_len,
                  (page_table,))


def decode_attention(q, k, v, kv_len, *, scale: float | None = None,
                     block_k: int | None = None):
    """q: [B, H, D]; k: [B, Sk, K, D]; v: [B, Sk, K, Dv]; kv_len: [B] int32
    (position p attended iff p < kv_len) -> [B, H, Dv].  ``block_k``: the
    keys of a split, ``split_plan``'s when None (``split_ok``; refused on
    either device when the kernel cannot take it)."""
    Sk = k.shape[1]
    L = split_plan(Sk)[0] if block_k is None else int(block_k)
    if not split_ok(Sk, L):
        raise ValueError(f"decode_attention: block_k={L} is no split of "
                         f"Sk={Sk} (a multiple of {SPLIT_TILE}, at most "
                         f"{MAX_SPLITS} splits)")
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, kv_len, scale=scale)
    refuse_grad("decode_attention", _NO_BWD, q, k, v)
    _check(q, k, v, kv_len)
    B, H, D = q.shape
    K, Dv = k.shape[2], v.shape[3]
    scale = D ** -0.5 if scale is None else scale
    S = max(1, -(-Sk // L))
    out = torch.empty((B, H, Dv), dtype=q.dtype, device=q.device)
    part = _scratch(q, B, K, S, Dv)
    lib = cuda_build.library()
    with torch.cuda.device(q.device):
        counters = _counters(q.device, B * K)
        err = lib.decode_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
            out.data_ptr(), part.data_ptr(), counters.data_ptr(), B, Sk, H, K,
            D, Dv, float(scale), L, S, _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check(err, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0  # kernel launches (plain-version calls excluded)


def decode_attention_paged(q, k_pool, v_pool, page_table, kv_len, *,
                           scale: float | None = None):
    """q: [B, H, D]; k_pool: [P, ps, K, D]; v_pool: [P, ps, K, Dv];
    page_table: [B, W] int32 (physical page of each logical page; the
    sentinel P marks an unmapped entry); kv_len: [B] int32 -> [B, H, Dv]."""
    if q.device.type == "cpu":
        return decode_attention_paged_plain(q, k_pool, v_pool, page_table,
                                            kv_len, scale=scale)
    refuse_grad("decode_attention_paged", _NO_BWD, q, k_pool, v_pool)
    _check_paged(q, k_pool, v_pool, page_table, kv_len)
    B, H, D = q.shape
    P, ps, K = k_pool.shape[:3]
    Dv, W = v_pool.shape[3], page_table.shape[1]
    scale = D ** -0.5 if scale is None else scale
    L, S = split_plan(W * ps)
    out = torch.empty((B, H, Dv), dtype=q.dtype, device=q.device)
    part = _scratch(q, B, K, S, Dv)
    lib = cuda_build.library()
    with torch.cuda.device(q.device):
        counters = _counters(q.device, B * K)
        err = lib.decode_attention_paged_fwd(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            page_table.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
            part.data_ptr(), counters.data_ptr(), B, P, ps, W, H, K, D, Dv,
            float(scale), L, S, _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check(err, "decode_attention_paged")
    decode_attention_paged.launches += 1
    return out


decode_attention_paged.launches = 0   # kernel launches (plain calls excluded)
