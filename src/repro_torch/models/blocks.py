"""Residual blocks: (mixer, ffn) = (attn, dense) in this port so far, plus
the stacking helpers for layer stacks.

Other mixers and ffns raise ``NotImplementedError`` naming the ROADMAP item
that ports them: MLA and MoE are Queue A item 5, Mamba and the Jamba
super-block item 6.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import (apply_dense_ffn, make_dense_ffn,
                                       make_norm, rmsnorm)
from repro_torch.models.params import Param, tree_map

_TODO = {
    "mla": "MLA is ROADMAP Queue A item 5",
    "mamba": "Mamba-2 is ROADMAP Queue A item 6",
    "moe": "MoE is ROADMAP Queue A item 5",
    "none": "ffn-less (SSM) blocks are ROADMAP Queue A item 6",
}


def _require(mixer: str, ffn: str):
    for part, allowed in ((mixer, "attn"), (ffn, "dense")):
        if part != allowed:
            if part in _TODO:
                raise NotImplementedError(f"{part!r} is not ported yet: "
                                          f"{_TODO[part]}")
            raise ValueError(part)


def _require_dense(page_table):
    if page_table is not None:
        raise NotImplementedError("the paged KV layout is not ported yet: "
                                  "ROADMAP slice 2 (Queue A item 3, paged)")


# ---------------------------------------------------------------------------
# single block
# ---------------------------------------------------------------------------
def make_block(cfg, mixer: str, ffn: str):
    _require(mixer, ffn)
    return {
        "ln1": make_norm(cfg.d_model),
        "mixer": attn_mod.make_attention(cfg),
        "ln2": make_norm(cfg.d_model),
        "ffn": make_dense_ffn(cfg, cfg.d_ff_dense or cfg.d_ff),
    }


def _ffn_residual(cfg, p, h):
    return h + apply_dense_ffn(cfg, p["ffn"], rmsnorm(h, p["ln2"], cfg.norm_eps))


def apply_block(cfg, p, h, positions, mixer: str, ffn: str):
    """Full-sequence residual block. Returns (h, aux_loss)."""
    h, _, _ = apply_block_collect(cfg, p, h, positions, mixer, ffn)
    return h, torch.zeros((), device=h.device)


def apply_block_collect(cfg, p, h, positions, mixer: str, ffn: str):
    """Like apply_block but also returns the prefill cache {k, v}."""
    _require(mixer, ffn)
    x = rmsnorm(h, p["ln1"], cfg.norm_eps)
    r, (k, v) = attn_mod.apply_attention(cfg, p["mixer"], x, positions)
    h = _ffn_residual(cfg, p, h + r)
    return h, torch.zeros((), device=h.device), {"k": k, "v": v}


def make_block_cache(cfg, mixer: str, batch: int, max_seq: int,
                     stack: tuple = ()):
    _require(mixer, "dense")
    return attn_mod.make_kv_cache(cfg, batch, max_seq, stack)


def apply_block_decode(cfg, p, h, cache, pos, mixer: str, ffn: str,
                       active=None, page_table=None):
    """One-token decode; the cache is updated in place.
    Returns (h, cache)."""
    _require(mixer, ffn)
    _require_dense(page_table)
    x = rmsnorm(h, p["ln1"], cfg.norm_eps)
    r, cache = attn_mod.apply_attention_decode(cfg, p["mixer"], x, cache, pos,
                                               active)
    return _ffn_residual(cfg, p, h + r), cache


def apply_block_prefill_chunk(cfg, p, h, cache, start, mixer: str, ffn: str,
                              active=None, page_table=None):
    """Chunked prefill through one block. h: [B, C, d]; start: [B] int32
    per-slot cache offset of the chunk; the cache is updated in place.
    Returns (h, cache)."""
    _require(mixer, ffn)
    _require_dense(page_table)
    x = rmsnorm(h, p["ln1"], cfg.norm_eps)
    r, cache = attn_mod.apply_attention_prefill_chunk(cfg, p["mixer"], x,
                                                      cache, start, active)
    return _ffn_residual(cfg, p, h + r), cache


# ---------------------------------------------------------------------------
# stacking (a leading layer axis on every leaf)
# ---------------------------------------------------------------------------
def stack_descr(tree, n: int):
    """Prepend a stacked 'layers' dim of size n to every Param descriptor."""
    return tree_map(
        lambda p: Param((n, *p.shape), ("layers", *p.logical), p.init,
                        p.dtype, p.scale),
        tree,
    )


def take_layer(tree, i: int):
    """Layer ``i`` of a stacked tree (views: writes reach the stack)."""
    return tree_map(lambda x: x[i], tree)
