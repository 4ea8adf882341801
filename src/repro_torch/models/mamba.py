"""Mamba-2 block (SSD formulation): full-sequence and chunked prefill
through the chunked scan, and O(1)-state decode.

The chunk length is the config's (``cfg.ssm.chunk``, or the prefill chunk
when that is shorter), with no switch to change it.  The decode caches
({conv, ssm}) are updated in place, where the JAX package donates them;
inactive slots keep their conv and SSM state unchanged.  The decode step
is plain torch (``ssd_decode_step_ref``): the JAX package has no kernel for
it either.

Training under a model axis that splits the SSD heads
(``sharding/tp.py::ssm_heads_split``) runs each rank's heads: it reads its
columns [z_r | x_r | B | C | dt_r] of the whole ``in_proj`` and its
channels x_r, B, C of the whole depthwise conv, scans its heads, sums the
gated RMSNorm's square sum over the group, and sums its rows of
``out_proj``'s product over the group.  Serving runs on one device, as in
the reference.
"""
from __future__ import annotations

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


def _split_proj(cfg, proj):
    s, d_in, _, _ = _dims(cfg)
    gs = s.n_groups * s.d_state
    return (proj[..., :d_in], proj[..., d_in: 2 * d_in + 2 * gs],
            proj[..., 2 * d_in + 2 * gs:])


def _causal_conv(p, xbc):
    """Depthwise causal conv as K shifted adds (K = d_conv is tiny)."""
    K, S = p["conv_w"].shape[0], xbc.shape[1]
    out = xbc * p["conv_w"][K - 1]
    for i in range(1, K):
        shifted = F.pad(xbc, (0, 0, i, 0))[:, :S]
        out = out + shifted * p["conv_w"][K - 1 - i]
    return F.silu(out + p["conv_b"])


def _ssd_inputs(cfg, p, xbc, dt_raw):
    """Split the conv output into x, B, C heads; dt and A in fp32."""
    s, d_in, nheads, _ = _dims(cfg)
    gs = s.n_groups * s.d_state
    lead = xbc.shape[:-1]
    xs = xbc[..., :d_in].reshape(*lead, nheads, s.head_dim)
    Bm = xbc[..., d_in: d_in + gs].reshape(*lead, s.n_groups, s.d_state)
    Cm = xbc[..., d_in + gs:].reshape(*lead, s.n_groups, s.d_state)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    return xs, Bm, Cm, dt, A


def _gate_out(cfg, p, y, xs, z):
    """D skip, gated RMSNorm and the output projection."""
    y = y + xs * p["D"].to(y.dtype)[:, None]
    y = y.reshape(*y.shape[:-2], -1)
    y = rmsnorm(y * F.silu(z), p["norm"], cfg.norm_eps)
    y = shard(y, "batch", "seq", "ffn")
    return y @ p["out_proj"]


def apply_mamba(cfg, p, x, positions=None):
    """Full-sequence Mamba-2 (train / prefill).  x: [B, S, d] -> (y [B, S,
    d], (conv_state [B, d_conv-1, conv_ch], ssm_state [B, H, P, N] fp32));
    under a model axis that splits the SSD heads, ``_apply_mamba_split``
    (the states then this rank's channels and heads)."""
    tp = model_axis()
    if tp is not None and ssm_heads_split(cfg, tp.size):
        return _apply_mamba_split(cfg, p, x, tp)
    s = cfg.ssm
    S = x.shape[1]
    proj = shard(x @ p["in_proj"], "batch", "seq", "ffn")
    z, xbc, dt_raw = _split_proj(cfg, proj)
    conv_state = xbc[:, S - (s.d_conv - 1):, :]   # the last d_conv-1 inputs
    xs, Bm, Cm, dt, A = _ssd_inputs(cfg, p, _causal_conv(p, xbc), dt_raw)
    y, h_final = ops.ssd_scan(xs.contiguous(), dt.contiguous(), A,
                              Bm.contiguous(), Cm.contiguous(),
                              chunk=s.chunk, return_final_state=True)
    return _gate_out(cfg, p, y, xs, z), (conv_state, h_final)


def _apply_mamba_split(cfg, p, x, tp):
    """``apply_mamba`` on this rank's SSD heads of a model axis ``tp``:
    ``in_proj``, ``conv_w``/``conv_b``, ``A_log``, ``D``, ``dt_bias`` and
    ``norm`` are whole and enter the region (each rank's gradient of them
    is the part its heads make), ``out_proj`` holds this rank's rows.  The
    gated RMSNorm's square sum over the rank's ``d_inner / m`` columns is
    summed over the group forward and backward (``enter(leave(.))``) and
    divided by the whole ``d_inner``."""
    s, d_in, nheads, _ = _dims(cfg)
    P, N, G = s.head_dim, s.d_state, s.n_groups
    gs = G * N
    Bsz, S, _ = x.shape
    h_loc = nheads // tp.size
    d_loc = h_loc * P
    g_lo, g_hi = local_groups(cfg, tp.size, tp.rank)
    g_loc = g_hi - g_lo
    heads = slice(tp.rank * h_loc, (tp.rank + 1) * h_loc)
    cols = slice(heads.start * P, heads.stop * P)
    # this rank's channels of xbc: its x columns, its groups' B and C
    chans = (cols, slice(d_in + g_lo * N, d_in + g_hi * N),
             slice(d_in + gs + g_lo * N, d_in + gs + g_hi * N))
    w = tp.enter(p["in_proj"])
    dt0 = 2 * d_in + 2 * gs
    w_loc = torch.cat(
        [w[:, cols]] + [w[:, c.start + d_in:c.stop + d_in] for c in chans]
        + [w[:, dt0 + heads.start:dt0 + heads.stop]], dim=1)
    proj = tp.enter(x) @ w_loc
    z, xbc, dt_raw = proj.split([d_loc, d_loc + 2 * g_loc * N, h_loc],
                                dim=-1)
    conv_state = xbc[:, S - (s.d_conv - 1):, :]
    cw, cb = tp.enter(p["conv_w"]), tp.enter(p["conv_b"])
    xbc = _causal_conv({"conv_w": torch.cat([cw[:, c] for c in chans], 1),
                        "conv_b": torch.cat([cb[c] for c in chans])}, xbc)
    xs = xbc[..., :d_loc].reshape(Bsz, S, h_loc, P)
    Bm = xbc[..., d_loc:d_loc + g_loc * N].reshape(Bsz, S, g_loc, N)
    Cm = xbc[..., d_loc + g_loc * N:].reshape(Bsz, S, g_loc, N)
    dt = F.softplus(dt_raw.float() + tp.enter(p["dt_bias"])[heads])
    A = -torch.exp(tp.enter(p["A_log"])[heads])
    y, h_final = ops.ssd_scan(xs.contiguous(), dt.contiguous(), A,
                              Bm.contiguous(), Cm.contiguous(),
                              chunk=s.chunk, return_final_state=True)
    y = y + xs * tp.enter(p["D"])[heads].to(y.dtype)[:, None]
    g = y.reshape(Bsz, S, d_loc) * F.silu(z)
    # ``rmsnorm`` over the whole d_inner: its square sum over the group
    gf = g.float()
    ss = tp.enter(tp.leave(gf.square().sum(dim=-1, keepdim=True)))
    y = (gf * torch.rsqrt(ss / d_in + cfg.norm_eps)).to(g.dtype) \
        * tp.enter(p["norm"])[cols]
    y = shard(y, "batch", "seq", "ffn")
    return tp.leave(y @ p["out_proj"]), (conv_state, h_final)


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
    z, xbc_raw, dt_raw = _split_proj(cfg, x @ p["in_proj"])
    K = s.d_conv
    window = torch.cat([cache["conv"].to(xbc_raw.dtype), xbc_raw], dim=1)
    new_conv = window[:, -(K - 1):]
    xbc = _causal_conv(p, window)[:, K - 1:]        # real left context only
    xs, Bm, Cm, dt, A = _ssd_inputs(cfg, p, xbc, dt_raw)
    y, h_final = ops.ssd_scan(xs.contiguous(), dt.contiguous(), A,
                              Bm.contiguous(), Cm.contiguous(),
                              chunk=min(s.chunk, C), h0=cache["ssm"],
                              return_final_state=True)
    _store_state(cache, new_conv, h_final, active)
    return _gate_out(cfg, p, y, xs, z).to(x.dtype), cache


def apply_mamba_decode(cfg, p, x, cache, pos=None, active=None):
    """One-token decode.  x: [B, 1, d]; cache {conv, ssm}, updated in
    place; active: optional [B] bool — inactive slots keep their state.
    Returns (out [B, 1, d], cache)."""
    z, xbc_new, dt_raw = _split_proj(cfg, x[:, 0] @ p["in_proj"])
    window = torch.cat([cache["conv"].to(xbc_new.dtype), xbc_new[:, None, :]],
                       dim=1)                        # [B, K, ch]
    xbc = F.silu(torch.einsum("bkc,kc->bc", window, p["conv_w"])
                 + p["conv_b"])
    xs, Bm, Cm, dt, A = _ssd_inputs(cfg, p, xbc, dt_raw)
    y, h_new = ssd_decode_step_ref(xs, dt, A, Bm, Cm, cache["ssm"])
    _store_state(cache, window[:, 1:], h_new, active)
    # keep the residual stream's dtype even when the conv cache is fp32
    out = _gate_out(cfg, p, y, xs, z)
    return out[:, None, :].to(x.dtype), cache
