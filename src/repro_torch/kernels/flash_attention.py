"""GQA flash attention, forward and backward: the wrappers around the CUDA
kernels ``csrc/flash_attention.cu`` (which replaces the Pallas TPU kernel
``repro/kernels/flash_attention.py::flash_attention``) and
``csrc/flash_attention_bwd.cu`` (the FlashAttention backward of
``repro/kernels/xla_flash.py::_vjp_bwd``; the Pallas kernel has none), with
their plain PyTorch versions.

``flash_attention`` takes the plain version for tensors on the CPU, and
only then; for CUDA tensors it launches the kernel or raises: bfloat16
inputs (16-byte aligned) go to its tensor-core body, float32 inputs to its
CUDA-core body.  Unlike the Pallas wrapper it needs no divisibility of Sq
or Sk: the kernel masks ragged tails itself.

The tensor-core body's tile, ``block_q`` rows a block and ``block_k`` keys
a K/V tile, is the counterpart of the Pallas kernel's block knobs: one of
the instantiations ``TC_TILES`` lists (``tiles_ok``, which the wrapper
checks on both devices and ``repro_torch.tune.space.valid`` mirrors).  The
CUDA-core body has one tile and takes only the default.  The plain
versions ignore the tile.

When autograd would record the call (grad mode on and an input requiring
grad) it goes through ``FlashAttention``, whose forward also writes the
log-sum-exp and whose backward runs ``flash_attention_bwd``, on either
device: the plain versions ``attention_lse_ref`` and
``flash_attention_bwd_ref`` on the CPU, the kernels on the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda_build
from repro_torch.kernels.ref import (attention_lse_ref, attention_ref,
                                    flash_attention_bwd_ref)

# (D, Dv) pairs the backward kernel is instantiated for
# (csrc/flash_attention_bwd.cu): smollm's and musicgen's 64, the reduced
# configs' 32, phi-3-vision's 96, the common 128, D != Dv as the reduced
# MLA widths (48, 32) and the full ones (nope 128 + rope 64, v 128);
# another pair is one more line in the file
SUPPORTED_DIMS_BWD = frozenset({(32, 32), (48, 32), (64, 64), (96, 96),
                                (128, 128), (192, 128)})
# and the forward (csrc/flash_attention.cu): the same pairs
SUPPORTED_DIMS = SUPPORTED_DIMS_BWD
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the tile a call takes when its caller names none (the tensor-core body's
# first design), and the tiles the tensor-core body is instantiated for at
# each (D, Dv) (csrc/flash_attention.cu): every (block_q, block_k) in
# {64, 128}^2 up to (96, 96); 64-key tiles only at (128, 128), where a
# 128-key tile took 255 registers a thread and spilled, and at (192, 128),
# whose 64-key tile already takes 244
DEFAULT_BLOCK_Q = 64
DEFAULT_BLOCK_K = 64
TC_TILES = {dims: (frozenset({(64, 64), (128, 64), (64, 128), (128, 128)})
                   if dims[0] <= 96 else frozenset({(64, 64), (128, 64)}))
            for dims in SUPPORTED_DIMS}


def tiles_ok(D: int, Dv: int, dtype, block_q: int, block_k: int) -> bool:
    """Whether the kernel has a body for this tile at (D, Dv) in ``dtype``
    (a torch dtype or its name): an instantiation of the tensor-core body in
    bfloat16, the default alone in float32 (and at head dims the kernel
    does not take, which ``_check`` refuses on the card)."""
    default = (DEFAULT_BLOCK_Q, DEFAULT_BLOCK_K)
    tiles = (TC_TILES.get((int(D), int(Dv)), {default})
             if str(dtype).removeprefix("torch.") == "bfloat16" else {default})
    return (int(block_q), int(block_k)) in tiles


def _check_tiles(q, v, block_q: int, block_k: int) -> None:
    D, Dv = q.shape[-1], v.shape[-1]
    if not tiles_ok(D, Dv, q.dtype, block_q, block_k):
        raise ValueError(f"flash_attention: no {q.dtype} body for the tile "
                         f"(block_q, block_k)=({block_q}, {block_k}) at "
                         f"(D, Dv)=({D}, {Dv})")

# the plain PyTorch versions the kernels are held against (the forward
# without and with its lse, the backward)
flash_attention_plain = attention_ref
flash_attention_lse_plain = attention_lse_ref
flash_attention_bwd_plain = flash_attention_bwd_ref


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


def _check_bwd(q, v, out, lse, dout):
    B, Sq, H, _ = q.shape
    want = (B, Sq, H, v.shape[3])
    if tuple(out.shape) != want or tuple(dout.shape) != want \
            or tuple(lse.shape) != (B, Sq, H):
        raise ValueError(f"flash_attention_bwd: out {tuple(out.shape)}, dout "
                         f"{tuple(dout.shape)} must be {want}, lse "
                         f"{tuple(lse.shape)} must be {(B, Sq, H)}")
    if out.dtype != q.dtype or dout.dtype != q.dtype \
            or lse.dtype != torch.float32:
        raise TypeError(f"flash_attention_bwd: out/dout must be {q.dtype} and "
                        f"lse float32, got {out.dtype}/{dout.dtype}/"
                        f"{lse.dtype}")
    if not all(t.device == q.device and t.is_contiguous()
               for t in (out, lse, dout)):
        raise ValueError("flash_attention_bwd kernel: out, lse, dout must be "
                         "contiguous on q's device")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16
                                         for t in (out, dout)):
        raise ValueError("flash_attention_bwd kernel: bf16 out and dout must "
                         "be 16-byte aligned")


def _forward(q, k, v, causal: bool, scale: float | None, q_offset: int,
             with_lse: bool, block_q: int = DEFAULT_BLOCK_Q,
             block_k: int = DEFAULT_BLOCK_K):
    """One launch of the forward kernel at the tile (``block_q``,
    ``block_k``): out, and the fp32 lse [B, Sq, H] if ``with_lse`` (else
    None, and the kernel writes none)."""
    _check(q, k, v)
    B, Sq, H, D = q.shape
    Sk, K, Dv = k.shape[1], k.shape[2], v.shape[3]
    scale = D ** -0.5 if scale is None else scale
    out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, Sq, H), dtype=torch.float32, device=q.device)
           if with_lse else None)
    lib = cuda_build.library()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            B, Sq, Sk, H, K, D, Dv, float(scale), int(bool(causal)),
            int(q_offset), int(block_q), int(block_k), _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out, lse


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True,
                        scale: float | None = None, q_offset: int = 0):
    """(dq, dk, dv) of attention from its inputs, output, fp32 lse
    [B, Sq, H] and the output's gradient ``dout`` [B, Sq, H, Dv]."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, dout,
                                         causal=causal, scale=scale,
                                         q_offset=q_offset)
    _check(q, k, v)
    _check_bwd(q, v, out, lse, dout)
    B, Sq, H, D = q.shape
    Sk, K, Dv = k.shape[1], k.shape[2], v.shape[3]
    scale = D ** -0.5 if scale is None else scale
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # Dsum and the log2-domain lse, head-major with the token axis padded
    # to the 128-token tiles (the fp32 body uses the first B*Sq*H)
    dsum = torch.empty(2 * B * H * -(-Sq // 128) * 128, dtype=torch.float32,
                       device=q.device)
    lib = cuda_build.library()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), dout.data_ptr(), dsum.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, Sq, Sk, H, K, D, Dv,
            float(scale), int(bool(causal)), int(q_offset),
            _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check(err, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0   # kernel calls (plain-version calls excluded)


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention: saves (q, k, v, out, lse) and
    recomputes the probabilities in the backward, as ``_vjp_bwd`` does."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, q_offset,
                block_q=DEFAULT_BLOCK_Q, block_k=DEFAULT_BLOCK_K):
        if q.device.type == "cpu":
            out, lse = flash_attention_lse_plain(q, k, v, causal=causal,
                                                 scale=scale,
                                                 q_offset=q_offset)
        else:
            out, lse = _forward(q, k, v, causal, scale, q_offset, True,
                                block_q, block_k)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, scale, q_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, scale, q_offset = ctx.args
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout.contiguous(),
                                         causal=causal, scale=scale,
                                         q_offset=q_offset)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: float | None = None, q_offset: int = 0,
                    block_q: int = DEFAULT_BLOCK_Q,
                    block_k: int = DEFAULT_BLOCK_K):
    """q: [B, Sq, H, D]; k: [B, Sk, K, D]; v: [B, Sk, K, Dv] -> [B, Sq, H, Dv].

    ``scale`` defaults to D**-0.5; ``q_offset`` shifts the causal diagonal
    (query i sits at position i + q_offset).  (``block_q``, ``block_k``):
    the forward kernel's tile (``tiles_ok``), refused on either device when
    the kernel has no body for it."""
    _check_tiles(q, v, block_q, block_k)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, scale, q_offset,
                                    block_q, block_k)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                     q_offset=q_offset)
    return _forward(q, k, v, causal, scale, q_offset, False, block_q,
                    block_k)[0]


flash_attention.launches = 0   # kernel launches (plain-version calls excluded)
