"""Residual blocks: (mixer in {attn, mamba}) + (ffn in {dense, none}), plus
the stacking helpers for layer stacks.

MLA and MoE raise ``NotImplementedError`` naming the ROADMAP item that
ports them (Queue A item 5), as does the Jamba super-block (``HybridPlan``,
Queue A item 6, in ``lm.segments``).
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba as mamba_mod
from repro_torch.models.layers import (apply_dense_ffn, make_dense_ffn,
                                       make_norm, rmsnorm)
from repro_torch.models.params import Param, tree_map

_TODO = {
    "mla": "MLA is ROADMAP Queue A item 5",
    "moe": "MoE is ROADMAP Queue A item 5",
}


def _require(mixer: str, ffn: str):
    for part, allowed in ((mixer, ("attn", "mamba")), (ffn, ("dense", "none"))):
        if part not in allowed:
            if part in _TODO:
                raise NotImplementedError(f"{part!r} is not ported yet: "
                                          f"{_TODO[part]}")
            raise ValueError(part)


# ---------------------------------------------------------------------------
# single block
# ---------------------------------------------------------------------------
def make_block(cfg, mixer: str, ffn: str):
    _require(mixer, ffn)
    p = {"ln1": make_norm(cfg.d_model)}
    p["mixer"] = (attn_mod.make_attention(cfg) if mixer == "attn"
                  else mamba_mod.make_mamba(cfg))
    if ffn == "dense":
        p["ln2"] = make_norm(cfg.d_model)
        p["ffn"] = make_dense_ffn(cfg, cfg.d_ff_dense or cfg.d_ff)
    return p


def _ffn_residual(cfg, p, h, ffn: str):
    if ffn == "none":
        return h
    return h + apply_dense_ffn(cfg, p["ffn"], rmsnorm(h, p["ln2"], cfg.norm_eps))


def apply_block(cfg, p, h, positions, mixer: str, ffn: str):
    """Full-sequence residual block. Returns (h, aux_loss)."""
    h, _, _ = apply_block_collect(cfg, p, h, positions, mixer, ffn)
    return h, torch.zeros((), device=h.device)


def apply_block_collect(cfg, p, h, positions, mixer: str, ffn: str):
    """Like apply_block but also returns the prefill cache (attn: {k, v},
    mamba: {conv, ssm})."""
    _require(mixer, ffn)
    x = rmsnorm(h, p["ln1"], cfg.norm_eps)
    if mixer == "attn":
        r, (k, v) = attn_mod.apply_attention(cfg, p["mixer"], x, positions)
        cache = {"k": k, "v": v}
    else:
        r, (conv, ssm) = mamba_mod.apply_mamba(cfg, p["mixer"], x, positions)
        cache = {"conv": conv, "ssm": ssm}
    h = _ffn_residual(cfg, p, h + r, ffn)
    return h, torch.zeros((), device=h.device), cache


def make_block_cache(cfg, mixer: str, batch: int, max_seq: int,
                     stack: tuple = ()):
    _require(mixer, "dense")
    if mixer == "attn":
        return attn_mod.make_kv_cache(cfg, batch, max_seq, stack)
    return mamba_mod.make_mamba_cache(cfg, batch, stack)


def make_block_cache_paged(cfg, mixer: str, batch: int, num_pages: int,
                           page_size: int, stack: tuple = ()):
    """Paged-layout block cache: attention KV rides the shared page pool;
    mamba slots keep their O(1) dense per-slot state (no sequence axis to
    page)."""
    _require(mixer, "dense")
    if mixer == "attn":
        return attn_mod.make_kv_cache_paged(cfg, num_pages, page_size, stack)
    return mamba_mod.make_mamba_cache(cfg, batch, stack)


def apply_block_decode(cfg, p, h, cache, pos, mixer: str, ffn: str,
                       active=None, page_table=None):
    """One-token decode; the cache is updated in place.  ``page_table``
    not None selects the paged layout for attention (mamba state is dense
    either way).  Returns (h, cache)."""
    _require(mixer, ffn)
    x = rmsnorm(h, p["ln1"], cfg.norm_eps)
    if mixer == "mamba":
        r, cache = mamba_mod.apply_mamba_decode(cfg, p["mixer"], x, cache,
                                                pos, active)
    elif page_table is not None:
        r, cache = attn_mod.apply_attention_decode_paged(
            cfg, p["mixer"], x, cache, pos, page_table, active)
    else:
        r, cache = attn_mod.apply_attention_decode(cfg, p["mixer"], x, cache,
                                                   pos, active)
    return _ffn_residual(cfg, p, h + r, ffn), cache


def apply_block_prefill_chunk(cfg, p, h, cache, start, mixer: str, ffn: str,
                              active=None, page_table=None):
    """Chunked prefill through one block. h: [B, C, d]; start: [B] int32
    per-slot cache offset of the chunk; the cache is updated in place;
    ``page_table`` not None selects the paged layout for attention.
    Returns (h, cache)."""
    _require(mixer, ffn)
    x = rmsnorm(h, p["ln1"], cfg.norm_eps)
    if mixer == "mamba":
        r, cache = mamba_mod.apply_mamba_prefill_chunk(cfg, p["mixer"], x,
                                                       cache, start, active)
    elif page_table is not None:
        r, cache = attn_mod.apply_attention_prefill_chunk_paged(
            cfg, p["mixer"], x, cache, start, page_table, active)
    else:
        r, cache = attn_mod.apply_attention_prefill_chunk(
            cfg, p["mixer"], x, cache, start, active)
    return _ffn_residual(cfg, p, h + r, ffn), cache


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
