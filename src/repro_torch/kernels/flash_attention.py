"""GQA flash attention: the wrapper around the CUDA kernel
``csrc/flash_attention.cu`` (which replaces the Pallas TPU kernel
``repro/kernels/flash_attention.py::flash_attention``) and its plain
PyTorch version.

``flash_attention`` takes the plain version for tensors on the CPU, and
only then; for CUDA tensors it launches the kernel or raises: bfloat16
inputs (16-byte aligned) go to its tensor-core body, float32 inputs to its
CUDA-core body.  Unlike the Pallas wrapper it needs no divisibility of Sq
or Sk: the kernel masks ragged tails itself.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda_build
from repro_torch.kernels.ref import attention_ref

# (D, Dv) pairs the kernel is instantiated for (csrc/flash_attention.cu):
# smollm's 64, the reduced configs' 32, the common 128, and D != Dv as the
# reduced MLA widths; another pair is one more line in each file
SUPPORTED_DIMS = frozenset({(32, 32), (48, 32), (64, 64), (128, 128)})
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# the plain PyTorch version the kernel is held against
flash_attention_plain = attention_ref


def _check(q, k, v):
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention kernel: q, k, v must be on one "
                         "CUDA device")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16 "
                        f"q/k/v of one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention: q [B,Sq,H,D], k/v [B,Sk,K,D|Dv]")
    B, _, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or v.shape[:3] != (B, Sk, K):
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if K == 0 or H % K:
        raise ValueError(f"flash_attention: H={H} not a multiple of K={K}")
    if (D, v.shape[3]) not in SUPPORTED_DIMS:
        raise ValueError(f"flash_attention kernel: (D, Dv)=({D}, {v.shape[3]})"
                         f" not in {sorted(SUPPORTED_DIMS)}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention kernel: q, k, v must be contiguous")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention kernel: bf16 q, k, v must be "
                         "16-byte aligned (the tiles are copied in 16-byte "
                         "pieces)")


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: float | None = None, q_offset: int = 0):
    """q: [B, Sq, H, D]; k: [B, Sk, K, D]; v: [B, Sk, K, Dv] -> [B, Sq, H, Dv].

    ``scale`` defaults to D**-0.5; ``q_offset`` shifts the causal diagonal
    (query i sits at position i + q_offset)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                     q_offset=q_offset)
    _check(q, k, v)
    B, Sq, H, D = q.shape
    Sk, K, Dv = k.shape[1], k.shape[2], v.shape[3]
    scale = D ** -0.5 if scale is None else scale
    out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    lib = cuda_build.library()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Sq, Sk, H, K, D, Dv, float(scale), int(bool(causal)),
            int(q_offset), _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0   # kernel launches (plain-version calls excluded)
