"""Shared layers: RMSNorm, dense FFN (SwiGLU / GELU-MLP), embeddings."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.params import Param
from repro_torch.sharding.rules import shard
from repro_torch.sharding.tp import model_axis


def rmsnorm(x, w, eps: float = 1e-5):
    # the reference's order: normalise in fp32, cast to x's dtype, then
    # scale by w (bf16 parity depends on it)
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def make_norm(d: int) -> Param:
    return Param((d,), (None,), init="ones")


def make_dense_ffn(cfg, width: int):
    d = cfg.d_model
    if cfg.act == "silu":  # gated SwiGLU
        return {
            "wi": Param((d, width), ("embed", "ffn"), init="scaled"),
            "wg": Param((d, width), ("embed", "ffn"), init="scaled"),
            "wo": Param((width, d), ("ffn", "embed"), init="scaled"),
        }
    return {  # classic 2-matrix GELU MLP (granite / musicgen)
        "wi": Param((d, width), ("embed", "ffn"), init="scaled"),
        "wo": Param((width, d), ("ffn", "embed"), init="scaled"),
    }


def apply_dense_ffn(cfg, p, x, width: int | None = None):
    """The FFN of ``width`` columns (default the config's dense width).
    Under a model axis that splits the columns (``sharding/tp.py``):
    ``wi``/``wg`` hold this rank's columns, ``wo`` its rows, and the
    ranks' outputs are summed."""
    tp = model_axis()
    if tp is not None and not tp.splits("ffn", width or cfg.d_ff_dense
                                        or cfg.d_ff):
        tp = None
    if tp is not None:
        x = tp.enter(x)
    h = x @ p["wi"]
    # jax.nn.gelu defaults to the tanh approximation
    h = F.silu(x @ p["wg"]) * h if "wg" in p else F.gelu(h, approximate="tanh")
    h = shard(h, "batch", None, "ffn")
    out = h @ p["wo"]
    return out if tp is None else tp.leave(out)


def make_embedding(vocab: int, d: int) -> Param:
    return Param((vocab, d), ("vocab", "embed"), init="normal", scale=0.02)


def embed_lookup(table, ids):
    return table[ids]
