"""Plain PyTorch oracles for the ported kernels (attention half of
``repro/kernels/ref.py``).

They are the compute path for CPU tensors and the versions the CUDA
kernels are held against on the card.  fp32 softmax; fp32 matmuls here
never run in TF32.
"""
from __future__ import annotations

import torch


def _full_fp32(t: torch.Tensor):
    # explicit, not the defaults: the plain versions are the fp32 yardstick
    if t.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def attention_ref(q, k, v, *, causal: bool = True, scale: float | None = None,
                  q_offset: int = 0):
    """Grouped-query attention, fp32 softmax.

    q [B, Sq, H, D], k [B, Sk, K, D], v [B, Sk, K, Dv] -> [B, Sq, H, Dv]."""
    _full_fp32(q)
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    scale = scale if scale is not None else D ** -0.5
    qg = q.reshape(B, Sq, K, G, D).float()
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * scale
    if causal:
        qpos = torch.arange(Sq, device=q.device) + q_offset
        kpos = torch.arange(Sk, device=q.device)
        mask = kpos[None, :] <= qpos[:, None]
        scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.float())
    return out.reshape(B, Sq, H, v.shape[-1]).to(q.dtype)


def decode_attention_ref(q, k, v, kv_len, *, scale: float | None = None):
    """Single-token (Sq=1) GQA decode attention over a ragged KV cache.

    q [B, H, D], k [B, Sk, K, D], v [B, Sk, K, Dv], kv_len [B] int32
    (position p attended iff p < kv_len) -> [B, H, Dv].  Every slot must
    have ``kv_len >= 1`` (an all-masked row softmaxes to NaN; the kernel
    returns 0 there)."""
    _full_fp32(q)
    B, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    scale = D ** -0.5 if scale is None else scale
    qg = q.reshape(B, K, G, D).float()
    scores = torch.einsum("bkgd,bskd->bkgs", qg, k.float()) * scale
    mask = torch.arange(Sk, device=q.device)[None, :] < kv_len[:, None]
    scores = scores.masked_fill(~mask[:, None, None, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", probs, v.float())
    return out.reshape(B, H, v.shape[-1]).to(q.dtype)
