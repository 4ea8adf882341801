"""Rotary position embeddings: full (llama), partial/interleaved (GLM 2d)."""
from __future__ import annotations

import torch


def _angles(positions, rotary_dim: int, theta: float):
    """positions [...,S] -> [..., S, rotary_dim//2] angles (fp32)."""
    half = rotary_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32,
                        device=positions.device) / half
    inv = 1.0 / (theta ** exps)
    return positions.to(torch.float32)[..., None] * inv


def apply_rope(x, positions, *, theta: float = 10000.0,
               rotary_dim: int | None = None, interleaved: bool = False):
    """x: [B, S, H, D] (or [B, S, D] treated as H=1), positions: [S] or [B, S].

    interleaved=True pairs (0,1),(2,3),... (GLM/chatglm 2d-RoPE);
    False uses the llama half-split convention.
    Only the first ``rotary_dim`` features rotate; the rest pass through.
    """
    D = x.shape[-1]
    rotary_dim = D if rotary_dim is None else rotary_dim
    if rotary_dim == 0:
        return x
    ang = _angles(positions, rotary_dim, theta)  # [..., S, half]
    # broadcast to [B, S, 1, half] against x [B, S, H, D]
    while ang.ndim < x.ndim:
        ang = ang[..., None, :] if ang.ndim == x.ndim - 1 else ang[None]
    cos, sin = torch.cos(ang), torch.sin(ang)
    xr, xp = x[..., :rotary_dim].float(), x[..., rotary_dim:]
    if interleaved:
        x1, x2 = xr[..., 0::2], xr[..., 1::2]
        r1 = x1 * cos - x2 * sin
        r2 = x2 * cos + x1 * sin
        rot = torch.stack([r1, r2], dim=-1).reshape(xr.shape)
    else:
        half = rotary_dim // 2
        x1, x2 = xr[..., :half], xr[..., half:]
        rot = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return torch.cat([rot.to(x.dtype), xp], dim=-1) if rotary_dim < D \
        else rot.to(x.dtype)
