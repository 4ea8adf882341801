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
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda_build
from repro_torch.kernels.ref import (decode_attention_paged_ref,
                                    decode_attention_ref)

MAX_GROUP = 8      # query heads per KV head (csrc/decode_attention.cu)
MAX_D = 256
MAX_DV = 128
MAX_PAGES_PER_SLOT = 1024   # page-table width W the kernel stages in smem
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

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
    _check_common("decode_attention_paged", q, k_pool, v_pool, kv_len,
                  (page_table,))


def decode_attention(q, k, v, kv_len, *, scale: float | None = None):
    """q: [B, H, D]; k: [B, Sk, K, D]; v: [B, Sk, K, Dv]; kv_len: [B] int32
    (position p attended iff p < kv_len) -> [B, H, Dv]."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, kv_len, scale=scale)
    _check(q, k, v, kv_len)
    B, H, D = q.shape
    Sk, K, Dv = k.shape[1], k.shape[2], v.shape[3]
    scale = D ** -0.5 if scale is None else scale
    out = torch.empty((B, H, Dv), dtype=q.dtype, device=q.device)
    lib = cuda_build.library()
    with torch.cuda.device(q.device):
        err = lib.decode_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
            out.data_ptr(), B, Sk, H, K, D, Dv, float(scale),
            _DTYPE_CODE[q.dtype],
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
    _check_paged(q, k_pool, v_pool, page_table, kv_len)
    B, H, D = q.shape
    P, ps, K = k_pool.shape[:3]
    Dv, W = v_pool.shape[3], page_table.shape[1]
    scale = D ** -0.5 if scale is None else scale
    out = torch.empty((B, H, Dv), dtype=q.dtype, device=q.device)
    lib = cuda_build.library()
    with torch.cuda.device(q.device):
        err = lib.decode_attention_paged_fwd(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            page_table.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
            B, P, ps, W, H, K, D, Dv, float(scale), _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check(err, "decode_attention_paged")
    decode_attention_paged.launches += 1
    return out


decode_attention_paged.launches = 0   # kernel launches (plain calls excluded)
