"""Mamba-2 block (SSD formulation): full-sequence and chunked prefill
through the chunked scan, and O(1)-state decode.

The chunk length is the config's (``cfg.ssm.chunk``, or the prefill chunk
when that is shorter), with no switch to change it.  The decode caches
({conv, ssm}) are updated in place, where the JAX package donates them;
inactive slots keep their conv and SSM state unchanged.  The decode step
is plain torch (``ssd_decode_step_ref``): the JAX package has no kernel for
it either.

Under a model axis that splits the SSD heads
(``sharding/tp.py::ssm_heads_split``), in training, prefill, the chunked
prefill and decode alike, each rank runs its heads (``on_rank``): it reads
its columns [z_r | x_r | B | C | dt_r] of the whole ``in_proj`` and its
channels x_r, B, C of the whole depthwise conv, scans its heads, sums the
gated RMSNorm's square sum over the group, and sums its rows of
``out_proj``'s product over the group; its decode cache holds those conv
channels and its heads' SSM state (``tp.cache_layout``).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.ref import ssd_decode_step_ref
from repro_torch.models.layers import rmsnorm
from repro_torch.models.params import Param
from repro_torch.sharding.rules import shard
from repro_torch.sharding.tp import local_groups, model_axis, ssm_heads_split


def _dims(cfg):
    s = cfg.ssm
    d_in = s.d_inner(cfg.d_model)
    nheads = s.n_heads(cfg.d_model)
    conv_ch = d_in + 2 * s.n_groups * s.d_state
    return s, d_in, nheads, conv_ch


@dataclass(frozen=True)
class Dims:
    """The widths a rank runs: its d_inner columns, SSD heads and B/C
    groups (all of them where the mixer is whole), and the whole d_inner,
    the gated RMSNorm's width."""
    d_in: int
    nheads: int
    groups: int
    d_in_all: int


def make_mamba(cfg):
    s, d_in, nheads, conv_ch = _dims(cfg)
    d = cfg.d_model
    proj_out = 2 * d_in + 2 * s.n_groups * s.d_state + nheads
    return {
        "in_proj": Param((d, proj_out), ("embed", "ffn"), init="scaled"),
        "conv_w": Param((s.d_conv, conv_ch), (None, "ffn"), init="scaled"),
        "conv_b": Param((conv_ch,), ("ffn",), init="zeros"),
        "A_log": Param((nheads,), (None,), init="const", scale=0.5,
                       dtype="float32"),
        "D": Param((nheads,), (None,), init="ones", dtype="float32"),
        "dt_bias": Param((nheads,), (None,), init="zeros", dtype="float32"),
        "norm": Param((d_in,), (None,), init="ones"),
        "out_proj": Param((d_in, d), ("ffn", "embed"), init="scaled"),
    }


def on_rank(cfg, p, x):
    """(x, p, dims, tp): the mixer's input, weights and widths as this rank
    runs them, and the model axis where it splits the SSD heads (else
    None, and everything whole).  Split: ``in_proj``, ``conv_w``/``conv_b``,
    ``A_log``, ``D``, ``dt_bias`` and ``norm`` are whole and enter the
    region (each rank's gradient of them is the part its heads make), and
    each rank takes its columns [z_r | x_r | B_g | C_g | dt_r] of
    ``in_proj``, its channels [x_r | B_g | C_g] of the conv, its heads of
    the per-head vectors and its columns of ``norm``; ``out_proj`` already
    holds its rows.  B_g and C_g are the groups its heads read
    (``tp.local_groups``)."""
    s, d_in, nheads, _ = _dims(cfg)
    tp = model_axis()
    if tp is None or not ssm_heads_split(cfg, tp.size):
        return x, p, Dims(d_in, nheads, s.n_groups, d_in), None
    P, N, gs = s.head_dim, s.d_state, s.n_groups * s.d_state
    h_loc = nheads // tp.size
    g_lo, g_hi = local_groups(cfg, tp.size, tp.rank)
    heads = slice(tp.rank * h_loc, (tp.rank + 1) * h_loc)
    cols = slice(heads.start * P, heads.stop * P)
    # this rank's channels of xbc: its x columns, its groups' B and C
    chans = (cols, slice(d_in + g_lo * N, d_in + g_hi * N),
             slice(d_in + gs + g_lo * N, d_in + gs + g_hi * N))
    w = tp.enter(p["in_proj"])
    dt0 = 2 * d_in + 2 * gs
    cw, cb = tp.enter(p["conv_w"]), tp.enter(p["conv_b"])
    local = {
        "in_proj": torch.cat(
            [w[:, cols]] + [w[:, c.start + d_in:c.stop + d_in]
                            for c in chans]
            + [w[:, dt0 + heads.start:dt0 + heads.stop]], dim=1),
        "conv_w": torch.cat([cw[:, c] for c in chans], 1),
        "conv_b": torch.cat([cb[c] for c in chans]),
        "A_log": tp.enter(p["A_log"])[heads],
        "D": tp.enter(p["D"])[heads],
        "dt_bias": tp.enter(p["dt_bias"])[heads],
        "norm": tp.enter(p["norm"])[cols],
        "out_proj": p["out_proj"],
    }
    return (tp.enter(x), local,
            Dims(h_loc * P, h_loc, g_hi - g_lo, d_in), tp)


def _split_proj(cfg, dims, proj):
    gs = dims.groups * cfg.ssm.d_state
    return (proj[..., :dims.d_in], proj[..., dims.d_in: 2 * dims.d_in + 2 * gs],
            proj[..., 2 * dims.d_in + 2 * gs:])


def _causal_conv(p, xbc):
    """Depthwise causal conv as K shifted adds (K = d_conv is tiny)."""
    K, S = p["conv_w"].shape[0], xbc.shape[1]
    out = xbc * p["conv_w"][K - 1]
    for i in range(1, K):
        shifted = F.pad(xbc, (0, 0, i, 0))[:, :S]
        out = out + shifted * p["conv_w"][K - 1 - i]
    return F.silu(out + p["conv_b"])


def _ssd_inputs(cfg, dims, p, xbc, dt_raw):
    """Split the conv output into x, B, C heads; dt and A in fp32."""
    s = cfg.ssm
    gs = dims.groups * s.d_state
    lead = xbc.shape[:-1]
    xs = xbc[..., :dims.d_in].reshape(*lead, dims.nheads, s.head_dim)
    Bm = xbc[..., dims.d_in: dims.d_in + gs].reshape(*lead, dims.groups,
                                                     s.d_state)
    Cm = xbc[..., dims.d_in + gs:].reshape(*lead, dims.groups, s.d_state)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    return xs, Bm, Cm, dt, A


def _gate_out(cfg, dims, p, y, xs, z, tp):
    """D skip, gated RMSNorm and the output projection.  Under the model
    axis ``tp`` the norm's square sum over this rank's columns is summed
    over the group forward and backward (``enter(leave(.))``) and divided
    by the whole d_inner, and the rows' products are summed."""
    y = y + xs * p["D"].to(y.dtype)[:, None]
    g = y.reshape(*y.shape[:-2], -1) * F.silu(z)
    if tp is None:
        y = rmsnorm(g, p["norm"], cfg.norm_eps)
    else:
        gf = g.float()
        ss = tp.enter(tp.leave(gf.square().sum(dim=-1, keepdim=True)))
        y = (gf * torch.rsqrt(ss / dims.d_in_all + cfg.norm_eps)).to(
            g.dtype) * p["norm"]
    y = shard(y, "batch", "seq", "ffn")
    out = y @ p["out_proj"]
    return out if tp is None else tp.leave(out)


def apply_mamba(cfg, p, x, positions=None):
    """Full-sequence Mamba-2 (train / prefill).  x: [B, S, d] -> (y [B, S,
    d], (conv_state [B, d_conv-1, conv_ch], ssm_state [B, H, P, N] fp32)),
    under a model axis this rank's heads and channels (``on_rank``)."""
    s = cfg.ssm
    S = x.shape[1]
    x, p, dims, tp = on_rank(cfg, p, x)
    proj = shard(x @ p["in_proj"], "batch", "seq", "ffn")
    z, xbc, dt_raw = _split_proj(cfg, dims, proj)
    conv_state = xbc[:, S - (s.d_conv - 1):, :]   # the last d_conv-1 inputs
    xs, Bm, Cm, dt, A = _ssd_inputs(cfg, dims, p, _causal_conv(p, xbc),
                                    dt_raw)
    y, h_final = ops.ssd_scan(xs.contiguous(), dt.contiguous(), A,
                              Bm.contiguous(), Cm.contiguous(),
                              chunk=s.chunk, return_final_state=True)
    return _gate_out(cfg, dims, p, y, xs, z, tp), (conv_state, h_final)


def make_mamba_cache(cfg, batch: int, stack: tuple = ()):
    s, _, nheads, conv_ch = _dims(cfg)
    lead = tuple(stack)
    ll = (None,) * len(lead)
    return {
        "conv": Param((*lead, batch, s.d_conv - 1, conv_ch),
                      (*ll, "batch", None, "ffn"), init="zeros",
                      dtype=cfg.dtype),
        "ssm": Param((*lead, batch, nheads, s.head_dim, s.d_state),
                     (*ll, "batch", None, None, None), init="zeros",
                     dtype="float32"),
    }


def _store_state(cache, new_conv, h_new, active):
    """In place: the new conv window and SSM state, for active slots only."""
    if active is not None:
        B = active.shape[0]
        h_new = torch.where(active.reshape(B, 1, 1, 1), h_new, cache["ssm"])
        new_conv = torch.where(active.reshape(B, 1, 1),
                               new_conv.to(cache["conv"].dtype), cache["conv"])
    cache["ssm"].copy_(h_new)
    cache["conv"].copy_(new_conv)


def apply_mamba_prefill_chunk(cfg, p, x, cache, start=None, active=None):
    """Prefill a C-token chunk, carrying conv + SSM state across chunks.

    x: [B, C, d]; cache {conv: [B, d_conv-1, ch], ssm: [B, H, P, N]},
    updated in place; start is unused (the state is position-free) and kept
    for the attention variants' signature; active: optional [B] bool —
    inactive slots keep their state, their outputs are garbage.  The conv
    left context is the cached last d_conv-1 raw inputs, so chunked prefill
    matches ``apply_mamba``.  Returns (out [B, C, d], cache)."""
    s = cfg.ssm
    C = x.shape[1]
    x, p, dims, tp = on_rank(cfg, p, x)
    z, xbc_raw, dt_raw = _split_proj(cfg, dims, x @ p["in_proj"])
    K = s.d_conv
    window = torch.cat([cache["conv"].to(xbc_raw.dtype), xbc_raw], dim=1)
    new_conv = window[:, -(K - 1):]
    xbc = _causal_conv(p, window)[:, K - 1:]        # real left context only
    xs, Bm, Cm, dt, A = _ssd_inputs(cfg, dims, p, xbc, dt_raw)
    y, h_final = ops.ssd_scan(xs.contiguous(), dt.contiguous(), A,
                              Bm.contiguous(), Cm.contiguous(),
                              chunk=min(s.chunk, C), h0=cache["ssm"],
                              return_final_state=True)
    _store_state(cache, new_conv, h_final, active)
    return _gate_out(cfg, dims, p, y, xs, z, tp).to(x.dtype), cache


def apply_mamba_decode(cfg, p, x, cache, pos=None, active=None):
    """One-token decode.  x: [B, 1, d]; cache {conv, ssm}, updated in
    place; active: optional [B] bool — inactive slots keep their state.
    Returns (out [B, 1, d], cache)."""
    x, p, dims, tp = on_rank(cfg, p, x)
    z, xbc_new, dt_raw = _split_proj(cfg, dims, x[:, 0] @ p["in_proj"])
    window = torch.cat([cache["conv"].to(xbc_new.dtype), xbc_new[:, None, :]],
                       dim=1)                        # [B, K, ch]
    xbc = F.silu(torch.einsum("bkc,kc->bc", window, p["conv_w"])
                 + p["conv_b"])
    xs, Bm, Cm, dt, A = _ssd_inputs(cfg, dims, p, xbc, dt_raw)
    y, h_new = ssd_decode_step_ref(xs, dt, A, Bm, Cm, cache["ssm"])
    _store_state(cache, window[:, 1:], h_new, active)
    # keep the residual stream's dtype even when the conv cache is fp32
    out = _gate_out(cfg, dims, p, y, xs, z, tp)
    return out[:, None, :].to(x.dtype), cache
