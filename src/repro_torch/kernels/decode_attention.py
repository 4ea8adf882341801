"""Sq=1 GQA decode attention over a ragged dense KV cache: the wrapper
around the CUDA kernel ``csrc/decode_attention.cu`` (which replaces the
Pallas TPU kernel ``repro/kernels/decode_attention.py::decode_attention``)
and its plain PyTorch version.

``decode_attention`` takes the plain version for tensors on the CPU, and
only then; for CUDA tensors it launches the kernel or raises.  The kernel
stops at each slot's ``kv_len``, so no padding of Sk is needed, and
``kv_len = 0`` gives 0 (the plain version gives NaN there; the engine
always passes ``kv_len >= 1``).  The paged variant is not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda_build
from repro_torch.kernels.ref import decode_attention_ref

MAX_GROUP = 8      # query heads per KV head (csrc/decode_attention.cu)
MAX_D = 256
MAX_DV = 128
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# the plain PyTorch version the kernel is held against
decode_attention_plain = decode_attention_ref


def _check(q, k, v, kv_len):
    dev = q.device
    if not (q.is_cuda and k.device == dev and v.device == dev
            and kv_len.device == dev):
        raise ValueError("decode_attention kernel: q, k, v, kv_len must be on "
                         "one CUDA device")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"decode_attention kernel takes float32 or bfloat16 "
                        f"q/k/v of one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if kv_len.dtype != torch.int32:
        raise TypeError(f"decode_attention: kv_len must be int32, got "
                        f"{kv_len.dtype}")
    if q.ndim != 3 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("decode_attention: q [B,H,D], k/v [B,Sk,K,D|Dv]")
    B, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or v.shape[:3] != (B, Sk, K) \
            or tuple(kv_len.shape) != (B,):
        raise ValueError(f"decode_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}, kv_len "
                         f"{tuple(kv_len.shape)} disagree")
    if K == 0 or H % K or H // K > MAX_GROUP:
        raise ValueError(f"decode_attention kernel: H={H}, K={K} needs "
                         f"H % K == 0 and H // K <= {MAX_GROUP}")
    if D % 8 or D > MAX_D or v.shape[3] > MAX_DV:
        raise ValueError(f"decode_attention kernel: D={D} (multiple of 8, <= "
                         f"{MAX_D}) and Dv={v.shape[3]} (<= {MAX_DV})")
    if not all(t.is_contiguous() for t in (q, k, v, kv_len)):
        raise ValueError("decode_attention kernel: inputs must be contiguous")
    if k.data_ptr() % 16:
        raise ValueError("decode_attention kernel: k must be 16-byte aligned")


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
