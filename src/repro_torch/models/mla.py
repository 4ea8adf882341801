"""Multi-head Latent Attention (DeepSeek-V2/V3), as ``repro/models/mla.py``.

Prefill/train: per-head K/V are materialised from the compressed latent
and go through the flash kernel with (D, Dv) = (nope + rope, v_head_dim)
and the scale (nope + rope)**-0.5; the rope part of the keys is shared
by every head.
Decode and chunked prefill: *weight-absorbed* — queries are projected
into the latent space, so attention runs directly against the cached
(ckv, kpe), (kv_lora_rank + qk_rope_head_dim) values a token instead of
2 * H * head_dim.  Scores, softmax and the latent output are fp32 torch
ops, as the reference's einsums are (no Pallas kernel there).

Caches are written in place.  Dense: rows of inactive slots and positions
at or past max_seq write back what they read (``attention._write_rows``),
where the reference drops them.  Paged: the pools carry the sink page of
``attention.py``, which takes every write that must not land, and reads
go through the step's ``attention.clamped_table``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import gather_pages
from repro_torch.models.attention import _write_rows, paged_write_rows
from repro_torch.models.layers import rmsnorm
from repro_torch.models.params import Param
from repro_torch.models.rope import apply_rope
from repro_torch.sharding.rules import shard


def make_mla(cfg):
    d, m, H = cfg.d_model, cfg.mla, cfg.num_heads
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wdq": Param((d, m.q_lora_rank), ("embed", "q_lora"), init="scaled"),
        "q_norm": Param((m.q_lora_rank,), (None,), init="ones"),
        "wuq": Param((m.q_lora_rank, H * qk_head), ("q_lora", "heads"),
                     init="scaled"),
        "wdkv": Param((d, m.kv_lora_rank), ("embed", "kv_lora"), init="scaled"),
        "wkr": Param((d, m.qk_rope_head_dim), ("embed", None), init="scaled"),
        "kv_norm": Param((m.kv_lora_rank,), (None,), init="ones"),
        "wuk": Param((m.kv_lora_rank, H * m.qk_nope_head_dim),
                     ("kv_lora", "heads"), init="scaled"),
        "wuv": Param((m.kv_lora_rank, H * m.v_head_dim),
                     ("kv_lora", "heads"), init="scaled"),
        "wo": Param((H * m.v_head_dim, d), ("heads", "embed"), init="scaled"),
    }


def _scale(m) -> float:
    return (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5


def _queries(cfg, p, x, positions):
    B, S, _ = x.shape
    m, H = cfg.mla, cfg.num_heads
    cq = rmsnorm(x @ p["wdq"], p["q_norm"], cfg.norm_eps)
    q = (cq @ p["wuq"]).reshape(B, S, H, m.qk_nope_head_dim
                                + m.qk_rope_head_dim)
    q_nope, q_pe = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    q_pe = apply_rope(q_pe, positions, theta=cfg.rope_theta)
    return q_nope, q_pe


def _latent_kv(cfg, p, x, positions):
    ckv = rmsnorm(x @ p["wdkv"], p["kv_norm"], cfg.norm_eps)   # [B, S, r]
    k_pe = apply_rope((x @ p["wkr"])[:, :, None, :], positions,
                      theta=cfg.rope_theta)[:, :, 0]           # [B, S, rope]
    return ckv, k_pe


def apply_mla(cfg, p, x, positions):
    """Full-sequence MLA (train/prefill). Returns (out, (ckv, k_pe))."""
    B, S, _ = x.shape
    m, H = cfg.mla, cfg.num_heads
    q_nope, q_pe = _queries(cfg, p, x, positions)
    ckv, k_pe = _latent_kv(cfg, p, x, positions)
    k_nope = (ckv @ p["wuk"]).reshape(B, S, H, m.qk_nope_head_dim)
    v = (ckv @ p["wuv"]).reshape(B, S, H, m.v_head_dim)
    q = torch.cat([q_nope, q_pe], dim=-1)
    k = torch.cat([k_nope, k_pe[:, :, None].expand(B, S, H,
                                                   m.qk_rope_head_dim)],
                  dim=-1)
    q = shard(q, "batch", "seq", None, None)
    k = shard(k, "batch", "seq_kv", None, None)
    out = ops.flash_attention(q, k, v, causal=True, scale=_scale(m))
    out = out.reshape(B, S, H * m.v_head_dim)
    out = shard(out, "batch", "seq", "heads")
    return out @ p["wo"], (ckv, k_pe)


def make_mla_cache(cfg, batch: int, max_seq: int, stack: tuple = ()):
    m = cfg.mla
    lead = tuple(stack)
    ll = (None,) * len(lead)
    return {
        "ckv": Param((*lead, batch, max_seq, m.kv_lora_rank),
                     (*ll, "batch", "seq_kv", None), init="zeros",
                     dtype=cfg.dtype),
        "kpe": Param((*lead, batch, max_seq, m.qk_rope_head_dim),
                     (*ll, "batch", "seq_kv", None), init="zeros",
                     dtype=cfg.dtype),
    }


def make_mla_cache_paged(cfg, num_pages: int, page_size: int,
                         stack: tuple = ()):
    """Paged latent cache: (ckv, kpe) pools of ``num_pages`` pages of
    ``page_size`` rows shared by every slot through per-slot page tables,
    plus the sink page (index ``num_pages``; see ``attention.py``)."""
    m = cfg.mla
    lead = tuple(stack)
    ll = (None,) * len(lead)
    return {
        "ckv": Param((*lead, num_pages + 1, page_size, m.kv_lora_rank),
                     (*ll, None, "seq_kv", None), init="zeros",
                     dtype=cfg.dtype),
        "kpe": Param((*lead, num_pages + 1, page_size, m.qk_rope_head_dim),
                     (*ll, None, "seq_kv", None), init="zeros",
                     dtype=cfg.dtype),
    }


def _absorbed(cfg, p, q_nope, q_pe, ckv, kpe, positions, dtype):
    """Weight-absorbed attention of the chunk's queries against the latent
    rows: q_nope/q_pe [B, C, H, *], ckv [B, S, r], kpe [B, S, rope],
    positions [B, C] (key s is live for the query at p iff s <= p) ->
    [B, C, H * v_head_dim] in ``dtype``.  fp32 throughout, as the
    reference's einsums."""
    B, C = positions.shape
    m, H = cfg.mla, cfg.num_heads
    smax = ckv.shape[1]
    wuk = p["wuk"].reshape(m.kv_lora_rank, H, m.qk_nope_head_dim).float()
    ckv32 = ckv.float()
    q_lat = torch.einsum("bqhd,rhd->bqhr", q_nope.float(), wuk)
    scores = torch.einsum("bqhr,bsr->bhqs", q_lat, ckv32)
    scores = scores + torch.einsum("bqhd,bsd->bhqs", q_pe.float(),
                                   kpe.float())
    scores = scores * _scale(m)
    mask = torch.arange(smax, device=ckv.device)[None, None, :] \
        <= positions[:, :, None]
    scores = scores.masked_fill(~mask[:, None, :, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    o_lat = torch.einsum("bhqs,bsr->bqhr", probs, ckv32)
    wuv = p["wuv"].reshape(m.kv_lora_rank, H, m.v_head_dim).float()
    out = torch.einsum("bqhr,rhd->bqhd", o_lat, wuv)
    return out.reshape(B, C, H * m.v_head_dim).to(dtype)


def _write_dense(cache, positions, ckv_new, kpe_new, active):
    """In place: the chunk's latent rows at ``positions`` [B, C] of each
    active slot; positions at or past max_seq are dropped."""
    B = positions.shape[0]
    smax = cache["ckv"].shape[1]
    keep = (positions >= 0) & (positions < smax)
    if active is not None:
        keep = keep & active[:, None]
    # the chunk's positions are consecutive, so distinct modulo smax
    rows = positions.remainder(smax)
    b_idx = torch.arange(B, device=positions.device)[:, None]
    _write_rows(cache["ckv"], b_idx, rows, keep, ckv_new)
    _write_rows(cache["kpe"], b_idx, rows, keep, kpe_new)


def apply_mla_prefill_chunk(cfg, p, x, cache, start, active=None):
    """Weight-absorbed prefill of a C-token chunk into the latent cache.

    x: [B, C, d]; cache {ckv: [B, S, r], kpe: [B, S, rope]}, written in
    place; start: [B] int32 (per-slot cache position of the chunk's first
    token); active: optional [B] bool (inactive slots leave the cache
    untouched, their outputs are garbage).  Returns (out [B, C, d],
    cache)."""
    B, C, _ = x.shape
    if C > cache["ckv"].shape[1]:
        raise ValueError(f"prefill chunk {C} longer than the cache "
                         f"{cache['ckv'].shape[1]}")
    positions = start[:, None] + torch.arange(C, device=x.device)[None, :]
    q_nope, q_pe = _queries(cfg, p, x, positions)
    ckv_new, kpe_new = _latent_kv(cfg, p, x, positions)
    _write_dense(cache, positions, ckv_new, kpe_new, active)
    out = _absorbed(cfg, p, q_nope, q_pe, cache["ckv"], cache["kpe"],
                    positions, x.dtype)
    return out @ p["wo"], cache


def apply_mla_decode(cfg, p, x, cache, pos, active=None):
    """Weight-absorbed one-token decode.  x: [B, 1, d]; cache {ckv: [B, S,
    r], kpe: [B, S, rope]}, written in place; pos: [B] int32; active:
    optional [B] bool (inactive slots leave the cache untouched).
    Returns (out [B, 1, d], cache)."""
    positions = pos[:, None]
    q_nope, q_pe = _queries(cfg, p, x, positions)
    ckv_new, kpe_new = _latent_kv(cfg, p, x, positions)
    _write_dense(cache, positions, ckv_new, kpe_new, active)
    out = _absorbed(cfg, p, q_nope, q_pe, cache["ckv"], cache["kpe"],
                    positions, x.dtype)
    return out @ p["wo"], cache


def apply_mla_prefill_chunk_paged(cfg, p, x, cache, start, page_table,
                                  read_table, active=None):
    """Weight-absorbed chunk prefill into the paged latent pools (in
    place).  Same contract as ``apply_mla_prefill_chunk`` with the dense
    stripe replaced by page-table scatter and gather (stale rows sit past
    the causal mask).  cache {ckv: [P+1, ps, r], kpe: [P+1, ps, rope]};
    page_table: [B, W] int32, the writes' table; read_table: its
    ``attention.clamped_table``, the reads'."""
    B, C, _ = x.shape
    positions = start[:, None] + torch.arange(C, device=x.device)[None, :]
    q_nope, q_pe = _queries(cfg, p, x, positions)
    ckv_new, kpe_new = _latent_kv(cfg, p, x, positions)
    paged_write_rows(cache["ckv"], page_table, positions, ckv_new, active)
    paged_write_rows(cache["kpe"], page_table, positions, kpe_new, active)
    out = _absorbed(cfg, p, q_nope, q_pe,
                    gather_pages(cache["ckv"], read_table),
                    gather_pages(cache["kpe"], read_table), positions, x.dtype)
    return out @ p["wo"], cache


def apply_mla_decode_paged(cfg, p, x, cache, pos, page_table, read_table,
                           active=None):
    """Weight-absorbed one-token decode against the paged latent pools.
    x: [B, 1, d]; cache {ckv: [P+1, ps, r], kpe: [P+1, ps, rope]}, written
    in place; pos: [B]; page_table: [B, W] int32 and read_table as in
    ``apply_mla_prefill_chunk_paged``; active: optional [B] bool.  Returns (out [B, 1, d], cache)."""
    positions = pos[:, None]
    q_nope, q_pe = _queries(cfg, p, x, positions)
    ckv_new, kpe_new = _latent_kv(cfg, p, x, positions)
    paged_write_rows(cache["ckv"], page_table, pos, ckv_new[:, 0], active)
    paged_write_rows(cache["kpe"], page_table, pos, kpe_new[:, 0], active)
    out = _absorbed(cfg, p, q_nope, q_pe,
                    gather_pages(cache["ckv"], read_table),
                    gather_pages(cache["kpe"], read_table), positions, x.dtype)
    return out @ p["wo"], cache
