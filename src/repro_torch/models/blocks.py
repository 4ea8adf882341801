"""Residual blocks: (mixer in {attn, mla, mamba}) + (ffn in {dense, moe,
none}), the stacking helpers for layer stacks, and the Jamba super-block
(``HybridPlan``): a fixed interleave of attention and Mamba mixers with
dense and MoE FFNs, whose layers of one (mixer, ffn) kind are stacked in
a group.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import mla as mla_mod
from repro_torch.models.layers import (apply_dense_ffn, make_dense_ffn,
                                       make_norm, rmsnorm)
from repro_torch.models.moe import apply_moe, make_moe
from repro_torch.models.params import Param, tree_map

_MIXERS = ("attn", "mla", "mamba")
_FFNS = ("dense", "moe", "none")


def _require(mixer: str, ffn: str):
    if mixer not in _MIXERS:
        raise ValueError(mixer)
    if ffn not in _FFNS:
        raise ValueError(ffn)


# ---------------------------------------------------------------------------
# single block
# ---------------------------------------------------------------------------
def make_block(cfg, mixer: str, ffn: str):
    _require(mixer, ffn)
    p = {"ln1": make_norm(cfg.d_model)}
    p["mixer"] = {"attn": attn_mod.make_attention,
                  "mla": mla_mod.make_mla,
                  "mamba": mamba_mod.make_mamba}[mixer](cfg)
    if ffn == "dense":
        p["ln2"] = make_norm(cfg.d_model)
        p["ffn"] = make_dense_ffn(cfg, cfg.d_ff_dense or cfg.d_ff)
    elif ffn == "moe":
        p["ln2"] = make_norm(cfg.d_model)
        p["ffn"] = make_moe(cfg)
    return p


def _ffn_residual(cfg, p, h, ffn: str):
    """(h + the block's FFN of rmsnorm(h), the MoE aux loss or None for
    the other FFNs)."""
    if ffn == "none":
        return h, None
    x = rmsnorm(h, p["ln2"], cfg.norm_eps)
    if ffn == "moe":
        B, S, d = x.shape
        y, aux = apply_moe(cfg, p["ffn"], x.reshape(B * S, d))
        return h + y.reshape(B, S, d), aux
    return h + apply_dense_ffn(cfg, p["ffn"], x), None


def apply_block(cfg, p, h, positions, mixer: str, ffn: str):
    """Full-sequence residual block. Returns (h, aux_loss)."""
    h, aux, _ = apply_block_collect(cfg, p, h, positions, mixer, ffn)
    return h, aux


def apply_block_collect(cfg, p, h, positions, mixer: str, ffn: str):
    """Like apply_block but also returns the prefill cache (attn: {k, v},
    mla: {ckv, kpe}, mamba: {conv, ssm})."""
    _require(mixer, ffn)
    x = rmsnorm(h, p["ln1"], cfg.norm_eps)
    if mixer == "attn":
        r, (k, v) = attn_mod.apply_attention(cfg, p["mixer"], x, positions)
        cache = {"k": k, "v": v}
    elif mixer == "mla":
        r, (ckv, kpe) = mla_mod.apply_mla(cfg, p["mixer"], x, positions)
        cache = {"ckv": ckv, "kpe": kpe}
    else:
        r, (conv, ssm) = mamba_mod.apply_mamba(cfg, p["mixer"], x, positions)
        cache = {"conv": conv, "ssm": ssm}
    h, aux = _ffn_residual(cfg, p, h + r, ffn)
    if aux is None:
        aux = torch.zeros((), device=h.device)
    return h, aux, cache


def make_block_cache(cfg, mixer: str, batch: int, max_seq: int,
                     stack: tuple = ()):
    _require(mixer, "dense")
    if mixer == "attn":
        return attn_mod.make_kv_cache(cfg, batch, max_seq, stack)
    if mixer == "mla":
        return mla_mod.make_mla_cache(cfg, batch, max_seq, stack)
    return mamba_mod.make_mamba_cache(cfg, batch, stack)


def make_block_cache_paged(cfg, mixer: str, batch: int, num_pages: int,
                           page_size: int, stack: tuple = ()):
    """Paged-layout block cache: attention KV and the MLA latents ride the
    shared page pool; mamba slots keep their O(1) dense per-slot state (no
    sequence axis to page)."""
    _require(mixer, "dense")
    if mixer == "attn":
        return attn_mod.make_kv_cache_paged(cfg, num_pages, page_size, stack)
    if mixer == "mla":
        return mla_mod.make_mla_cache_paged(cfg, num_pages, page_size, stack)
    return mamba_mod.make_mamba_cache(cfg, batch, stack)


def apply_block_decode(cfg, p, h, cache, pos, mixer: str, ffn: str,
                       active=None, page_table=None, read_table=None):
    """One-token decode; the cache is updated in place.  ``page_table``
    not None selects the paged layout for attention and MLA (mamba state
    is dense either way); it takes the writes, ``read_table`` (its
    ``attention.clamped_table``) the reads.  Returns (h, cache)."""
    _require(mixer, ffn)
    x = rmsnorm(h, p["ln1"], cfg.norm_eps)
    if mixer == "mamba":
        r, cache = mamba_mod.apply_mamba_decode(cfg, p["mixer"], x, cache,
                                                pos, active)
    elif mixer == "mla":
        r, cache = (mla_mod.apply_mla_decode_paged(
                        cfg, p["mixer"], x, cache, pos, page_table,
                        read_table, active)
                    if page_table is not None
                    else mla_mod.apply_mla_decode(cfg, p["mixer"], x, cache,
                                                  pos, active))
    elif page_table is not None:
        r, cache = attn_mod.apply_attention_decode_paged(
            cfg, p["mixer"], x, cache, pos, page_table, read_table, active)
    else:
        r, cache = attn_mod.apply_attention_decode(cfg, p["mixer"], x, cache,
                                                   pos, active)
    return _ffn_residual(cfg, p, h + r, ffn)[0], cache


def apply_block_prefill_chunk(cfg, p, h, cache, start, mixer: str, ffn: str,
                              active=None, page_table=None, read_table=None):
    """Chunked prefill through one block. h: [B, C, d]; start: [B] int32
    per-slot cache offset of the chunk; the cache is updated in place;
    ``page_table`` not None selects the paged layout for attention and
    MLA, with ``read_table`` as in ``apply_block_decode``.  Returns (h,
    cache)."""
    _require(mixer, ffn)
    x = rmsnorm(h, p["ln1"], cfg.norm_eps)
    if mixer == "mamba":
        r, cache = mamba_mod.apply_mamba_prefill_chunk(cfg, p["mixer"], x,
                                                       cache, start, active)
    elif mixer == "mla":
        r, cache = (mla_mod.apply_mla_prefill_chunk_paged(
                        cfg, p["mixer"], x, cache, start, page_table,
                        read_table, active)
                    if page_table is not None
                    else mla_mod.apply_mla_prefill_chunk(
                        cfg, p["mixer"], x, cache, start, active))
    elif page_table is not None:
        r, cache = attn_mod.apply_attention_prefill_chunk_paged(
            cfg, p["mixer"], x, cache, start, page_table, read_table,
            active)
    else:
        r, cache = attn_mod.apply_attention_prefill_chunk(
            cfg, p["mixer"], x, cache, start, active)
    return _ffn_residual(cfg, p, h + r, ffn)[0], cache


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


# ---------------------------------------------------------------------------
# Jamba super-block
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class HybridPlan:
    """Layer plan within one super-block: (group, index_within_group,
    mixer, ffn) per in-block position."""
    entries: tuple  # of (group, idx, mixer, ffn)
    group_sizes: dict

    @staticmethod
    def build(cfg) -> HybridPlan:
        hb = cfg.hybrid_block
        if not hb or cfg.num_layers % hb:
            raise ValueError(f"num_layers={cfg.num_layers} is not a multiple "
                             f"of hybrid_block={hb}")
        if cfg.moe is not None and hb % cfg.moe.every:
            raise ValueError("MoE period must divide the super-block")
        entries, sizes = [], {}
        for i in range(hb):
            mixer = "attn" if i == cfg.hybrid_attn_index else "mamba"
            ffn = "moe" if cfg.is_moe_layer(i) else "dense"
            group = f"{mixer}_{ffn}"
            idx = sizes.get(group, 0)
            sizes[group] = idx + 1
            entries.append((group, idx, mixer, ffn))
        return HybridPlan(tuple(entries), sizes)


def make_super_block(cfg, plan: HybridPlan):
    return {group: stack_descr(make_block(cfg, *group.split("_")), n)
            for group, n in plan.group_sizes.items()}


def plan_layers(plan: HybridPlan, p, cache=None):
    """(mixer, ffn, layer params, layer cache or None) per in-block
    position, in the plan's order; the cache entries are views, so writes
    reach the group's stack."""
    for group, idx, mixer, ffn in plan.entries:
        yield (mixer, ffn, take_layer(p[group], idx),
               None if cache is None else take_layer(cache[group], idx))


def apply_super_block(cfg, p, h, positions, plan: HybridPlan):
    """Full-sequence super-block.  Returns (h, aux_loss)."""
    aux = torch.zeros((), device=h.device)
    for mixer, ffn, layer_p, _ in plan_layers(plan, p):
        h, a = apply_block(cfg, layer_p, h, positions, mixer, ffn)
        aux = aux + a
    return h, aux


def apply_super_block_collect(cfg, p, h, positions, plan: HybridPlan):
    """Like apply_super_block but also returns the prefill cache, each
    group's layers' caches stacked along a leading axis."""
    aux = torch.zeros((), device=h.device)
    per_group = {g: [None] * n for g, n in plan.group_sizes.items()}
    for group, idx, mixer, ffn in plan.entries:
        h, a, cache = apply_block_collect(cfg, take_layer(p[group], idx), h,
                                          positions, mixer, ffn)
        aux = aux + a
        per_group[group][idx] = cache
    return h, aux, {g: {name: torch.stack([c[name] for c in caches])
                        for name in caches[0]}
                    for g, caches in per_group.items()}


def make_super_block_cache(cfg, plan: HybridPlan, batch: int, max_seq: int,
                           stack: tuple = ()):
    return {group: make_block_cache(cfg, group.split("_")[0], batch, max_seq,
                                    stack=(*stack, n))
            for group, n in plan.group_sizes.items()}


def make_super_block_cache_paged(cfg, plan: HybridPlan, batch: int,
                                 num_pages: int, page_size: int,
                                 stack: tuple = ()):
    return {group: make_block_cache_paged(cfg, group.split("_")[0], batch,
                                          num_pages, page_size,
                                          stack=(*stack, n))
            for group, n in plan.group_sizes.items()}


def apply_super_block_prefill_chunk(cfg, p, h, cache, start,
                                    plan: HybridPlan, active=None,
                                    page_table=None, read_table=None):
    """Chunked prefill through one super-block, as
    ``apply_block_prefill_chunk`` layer by layer in the plan's order; each
    group's cache stack is updated in place.  Returns (h, cache)."""
    for mixer, ffn, layer_p, layer_c in plan_layers(plan, p, cache):
        h, _ = apply_block_prefill_chunk(cfg, layer_p, h, layer_c, start,
                                         mixer, ffn, active, page_table,
                                         read_table)
    return h, cache


def apply_super_block_decode(cfg, p, h, cache, pos, plan: HybridPlan,
                             active=None, page_table=None, read_table=None):
    """One-token decode through one super-block, as ``apply_block_decode``
    layer by layer in the plan's order; each group's cache stack is
    updated in place.  Returns (h, cache)."""
    for mixer, ffn, layer_p, layer_c in plan_layers(plan, p, cache):
        h, _ = apply_block_decode(cfg, layer_p, h, layer_c, pos, mixer, ffn,
                                  active, page_table, read_table)
    return h, cache
