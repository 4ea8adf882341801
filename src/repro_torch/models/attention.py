"""GQA/MQA attention with qk-norm, partial/interleaved RoPE, and decode
paths against a pre-allocated KV cache: a dense [B, max_seq] stripe per
slot, or a paged pool shared by every slot through per-slot page tables.

The cache is updated in place where the JAX package donated its buffers
(``repro/serve/engine.py`` donates the cache to every step), and only the
rows of active slots are written: an out-of-range scatter, which XLA drops,
is a device-side assert in CUDA, so no index here ever leaves the cache.

Paged pools carry one page more than the allocator hands out: the last
page is a sink, at the index the allocator uses as its unmapped-entry
sentinel.  Writes that must not land (inactive slots, positions past the
table) go to the sink's first row, and a write through an unmapped entry
lands in the sink by construction; no table maps the sink and no read
within a slot's kv_len reaches it.  Writing back what
was read, as the dense path does, is not safe here: an inactive slot's
(stale or clamped) table can point at a page another slot writes in the
same ``index_put_``, and duplicate indices in one CUDA ``index_put_`` have
no defined winner.  Reads go through the step's ``clamped_table``, made
once per step by ``lm``: an unmapped entry reads the last real page, as
the reference's clamp of the sentinel does, not the sink.  A live slot never attends to what it reads there; an
inactive slot's rows are garbage either way, but an MoE routes them with
the live rows of the same call, where they take expert capacity, so they
must be the reference's garbage.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import gather_pages
from repro_torch.models.layers import rmsnorm
from repro_torch.models.params import Param
from repro_torch.models.rope import apply_rope
from repro_torch.sharding.rules import shard
from repro_torch.sharding.tp import heads_split, local_kv, model_axis


def make_attention(cfg):
    d = cfg.d_model
    p = {
        "wq": Param((d, cfg.q_dim), ("embed", "heads"), init="scaled"),
        "wk": Param((d, cfg.kv_dim), ("embed", "kv_heads"), init="scaled"),
        "wv": Param((d, cfg.kv_dim), ("embed", "kv_heads"), init="scaled"),
        "wo": Param((cfg.q_dim, d), ("heads", "embed"), init="scaled"),
    }
    if cfg.qk_norm:
        p["q_norm"] = Param((cfg.head_dim,), (None,), init="ones")
        p["k_norm"] = Param((cfg.head_dim,), (None,), init="ones")
    return p


def _qkv(cfg, p, x, positions):
    """q, k, v at the heads ``p`` holds (this rank's under a model axis)."""
    B, S, _ = x.shape
    q = (x @ p["wq"]).reshape(B, S, -1, cfg.head_dim)
    k = (x @ p["wk"]).reshape(B, S, -1, cfg.head_dim)
    v = (x @ p["wv"]).reshape(B, S, -1, cfg.head_dim)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    rd = cfg.rotary_dim
    if rd:
        q = apply_rope(q, positions, theta=cfg.rope_theta, rotary_dim=rd,
                       interleaved=cfg.rope_interleaved)
        k = apply_rope(k, positions, theta=cfg.rope_theta, rotary_dim=rd,
                       interleaved=cfg.rope_interleaved)
    return q, k, v


def apply_attention(cfg, p, x, positions):
    """Full-sequence causal attention (train / prefill).

    x: [B, S, d]; positions: [S] or [B, S]. Returns ([B, S, d], (k, v)).

    Under a model axis that splits the heads (``sharding/tp.py``) this
    rank runs its query heads and the KV heads they read: its own KV
    heads where those split too, else its run of the replicated ones
    (``local_kv``; granite-20b's one KV head under 24 query heads a rank
    at 2 ranks), and the ranks' outputs of ``wo`` are summed."""
    tp = model_axis()
    q_split = kv_split = False
    if tp is not None:
        q_split, kv_split = heads_split(cfg, tp.size)
    if q_split:
        x = tp.enter(x)
        p = dict(p)
        shared = ("q_norm", "k_norm") + (() if kv_split else ("wk", "wv"))
        for name in shared:
            if name in p:
                p[name] = tp.enter(p[name])
        if not kv_split:
            lo, hi = local_kv(cfg, tp.size, tp.rank)
            cols = slice(lo * cfg.head_dim, hi * cfg.head_dim)
            p["wk"], p["wv"] = p["wk"][:, cols], p["wv"][:, cols]
    q, k, v = _qkv(cfg, p, x, positions)
    q = shard(q, "batch", "seq", None, None)
    k = shard(k, "batch", "seq_kv", None, None)
    out = ops.flash_attention(q, k, v, causal=True)
    out = out.reshape(*x.shape[:2], -1)
    out = shard(out, "batch", "seq", "heads")
    out = out @ p["wo"]
    return (tp.leave(out) if q_split else out), (k, v)


def make_kv_cache(cfg, batch: int, max_seq: int, stack: tuple = ()):
    """Descriptor tree for the KV cache (materialise with init_params)."""
    lead = tuple(stack)
    lead_logical = (None,) * len(lead)
    shape = (*lead, batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
    logical = (*lead_logical, "batch", "seq_kv", "kv_heads", None)
    return {
        "k": Param(shape, logical, init="zeros", dtype=cfg.dtype),
        "v": Param(shape, logical, init="zeros", dtype=cfg.dtype),
    }


def make_kv_cache_paged(cfg, num_pages: int, page_size: int,
                        stack: tuple = ()):
    """Descriptor tree for a paged KV cache: a pool of ``num_pages`` pages
    of ``page_size`` token rows shared by every slot, plus the sink page
    (index ``num_pages``, also the allocator's unmapped-entry sentinel).
    No batch axis: resident memory does not scale with slots x max_seq."""
    lead = tuple(stack)
    lead_logical = (None,) * len(lead)
    shape = (*lead, num_pages + 1, page_size, cfg.num_kv_heads, cfg.head_dim)
    logical = (*lead_logical, None, "seq_kv", "kv_heads", None)
    return {
        "k": Param(shape, logical, init="zeros", dtype=cfg.dtype),
        "v": Param(shape, logical, init="zeros", dtype=cfg.dtype),
    }


def _paged_flat_rows(pool, page_table, positions, active):
    """Flat pool row (page * ps + offset) of each of ``positions``; rows of
    inactive slots and positions outside [0, W*ps) go to the sink's first
    row.  The same for the K and the V pool, so computed once per layer."""
    P, ps = pool.shape[0] - 1, pool.shape[1]
    B, W = page_table.shape
    b_idx = torch.arange(B, device=pool.device)
    keep = (positions >= 0) & (positions < W * ps)
    if positions.ndim == 2:
        b_idx = b_idx[:, None]
    if active is not None:
        keep = keep & (active if positions.ndim == 1 else active[:, None])
    logical = positions.div(ps, rounding_mode="floor").clamp(0, W - 1)
    phys = page_table[b_idx, logical]      # the sentinel P is the sink page
    return torch.where(keep, phys * ps + positions.remainder(ps), P * ps)


def clamped_table(page_table, num_pages: int):
    """The page table the paged reads go through: the sentinel
    ``num_pages`` (unmapped) clamped to the last real page, as the
    reference's ``gather_pages`` clamps it (its pool has no sink).  Every
    layer's pool has the same pages, so one a step serves them all."""
    return page_table.clamp(max=num_pages - 1)


def _put_rows(pool, flat, values):
    rows = pool.view(-1, *pool.shape[2:])
    rows[flat.reshape(-1)] = values.reshape(-1, *pool.shape[2:]).to(pool.dtype)


def paged_write_rows(pool, page_table, positions, values, active=None):
    """In place: scatter per-token rows through a page table.

    pool: [P+1, ps, ...] (the last page is the sink); page_table: [B, W]
    int32 (the sentinel P marks an unmapped entry); positions: [B] or
    [B, C] int32 logical token positions; values: rows matching
    ``positions`` with the pool's trailing dims; active: optional [B] bool.
    Rows of inactive slots, positions outside [0, W*ps) and unmapped
    entries go to the sink, so no index ever reaches a live row it does not
    own.  Returns ``pool``."""
    _put_rows(pool, _paged_flat_rows(pool, page_table, positions, active),
              values)
    return pool


def _write_rows(buf, b_idx, rows, mask, new):
    """In place: ``buf[b, rows[b, c]] = new[b, c]`` where ``mask[b, c]``.

    ``rows`` must already lie in [0, Smax) and be distinct within a slot;
    masked-off entries write back what they read, so no sync and no
    out-of-range index is needed to skip them."""
    old = buf[b_idx, rows]
    m = mask.reshape(*mask.shape, *([1] * (old.ndim - mask.ndim)))
    buf[b_idx, rows] = torch.where(m, new.to(buf.dtype), old)


def apply_attention_prefill_chunk(cfg, p, x, cache, start, active=None):
    """Batched prefill of a C-token chunk into the KV cache (in place).

    x: [B, C, d]; cache: {k,v: [B, Smax, K, hd]}; start: [B] int32 (cache
    position of the chunk's first token, per slot); active: optional [B]
    bool — inactive slots leave the cache untouched and their outputs are
    garbage (callers must ignore them).  Rows at or past Smax are dropped.

    Chunk queries attend to the whole cache under a kpos <= start+q mask,
    in plain torch (the reference does this inline, not in a kernel).
    Returns (out [B, C, d], cache)."""
    B, C, _ = x.shape
    smax = cache["k"].shape[1]
    if C > smax:
        raise ValueError(f"prefill chunk {C} longer than the cache {smax}")
    positions = start[:, None] + torch.arange(C, device=x.device)[None, :]
    q, k_new, v_new = _qkv(cfg, p, x, positions)
    keep = positions < smax
    if active is not None:
        keep = keep & active[:, None]
    # C consecutive positions are distinct modulo smax (C <= smax)
    rows = positions.remainder(smax)
    b_idx = torch.arange(B, device=x.device)[:, None]
    _write_rows(cache["k"], b_idx, rows, keep, k_new)
    _write_rows(cache["v"], b_idx, rows, keep, v_new)
    k, v = cache["k"], cache["v"]
    K = k.shape[2]
    G = cfg.num_heads // K
    qg = q.reshape(B, C, K, G, cfg.head_dim).float()
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float())
    scores = scores * (cfg.head_dim ** -0.5)
    mask = torch.arange(smax, device=x.device)[None, None, :] \
        <= positions[:, :, None]
    scores = scores.masked_fill(~mask[:, None, None, :, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.float())
    out = out.reshape(B, C, cfg.q_dim).to(x.dtype)
    return out @ p["wo"], cache


def apply_attention_decode(cfg, p, x, cache, pos, active=None):
    """One-token decode. x: [B, 1, d]; cache: {k,v: [B, Smax, K, hd]},
    written in place; pos: [B] int32 (index of the new token); active:
    optional [B] bool — inactive slots leave the cache untouched
    (continuous batching).  Returns (out, cache)."""
    B = x.shape[0]
    q, k_new, v_new = _qkv(cfg, p, x, pos[:, None])
    smax = cache["k"].shape[1]
    keep = (pos >= 0) & (pos < smax)
    if active is not None:
        keep = keep & active
    rows = pos.clamp(0, smax - 1)
    b_idx = torch.arange(B, device=x.device)
    _write_rows(cache["k"], b_idx, rows, keep, k_new[:, 0])
    _write_rows(cache["v"], b_idx, rows, keep, v_new[:, 0])
    # position p attended iff p <= pos, i.e. p < pos + 1 == kv_len
    kv_len = (pos + 1).to(torch.int32)
    out = ops.decode_attention(q[:, 0], cache["k"], cache["v"], kv_len,
                               scale=cfg.head_dim ** -0.5)
    out = out.reshape(B, 1, cfg.q_dim)
    return out @ p["wo"], cache


def apply_attention_decode_paged(cfg, p, x, cache, pos, page_table,
                                 read_table, active=None):
    """One-token decode against the paged pool.  x: [B, 1, d]; cache:
    {k,v: [P+1, ps, K, hd]}, written in place; pos: [B] int32; page_table:
    [B, W] int32 (constant within a fused sync, extended by the engine's
    allocator between syncs), the writes' table; read_table: its
    ``clamped_table``, the reads'; active: optional [B] bool.
    Returns (out, cache)."""
    B = x.shape[0]
    q, k_new, v_new = _qkv(cfg, p, x, pos[:, None])
    flat = _paged_flat_rows(cache["k"], page_table, pos, active)
    _put_rows(cache["k"], flat, k_new[:, 0])
    _put_rows(cache["v"], flat, v_new[:, 0])
    kv_len = (pos + 1).to(torch.int32)
    out = ops.decode_attention_paged(q[:, 0], cache["k"], cache["v"],
                                     read_table, kv_len,
                                     scale=cfg.head_dim ** -0.5)
    out = out.reshape(B, 1, cfg.q_dim)
    return out @ p["wo"], cache


def apply_attention_prefill_chunk_paged(cfg, p, x, cache, start, page_table,
                                        read_table, active=None):
    """Batched C-token prefill through the page table (in place).  Same
    contract as ``apply_attention_prefill_chunk`` with the dense stripe
    replaced by the pool: KV rows scatter to ``table[b, pos//ps]*ps +
    pos%ps`` and the chunk attends to the slot's gathered pages under the
    kpos <= start+q mask, in plain torch as the reference does.
    Returns (out [B, C, d], cache)."""
    B, C, _ = x.shape
    positions = start[:, None] + torch.arange(C, device=x.device)[None, :]
    q, k_new, v_new = _qkv(cfg, p, x, positions)
    flat = _paged_flat_rows(cache["k"], page_table, positions, active)
    _put_rows(cache["k"], flat, k_new)
    _put_rows(cache["v"], flat, v_new)
    kg = gather_pages(cache["k"], read_table)          # [B, W*ps, K, hd]
    vg = gather_pages(cache["v"], read_table)
    smax, K = kg.shape[1], kg.shape[2]
    G = cfg.num_heads // K
    qg = q.reshape(B, C, K, G, cfg.head_dim).float()
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, kg.float())
    scores = scores * (cfg.head_dim ** -0.5)
    mask = torch.arange(smax, device=x.device)[None, None, :] \
        <= positions[:, :, None]
    scores = scores.masked_fill(~mask[:, None, None, :, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, vg.float())
    out = out.reshape(B, C, cfg.q_dim).to(x.dtype)
    return out @ p["wo"], cache
