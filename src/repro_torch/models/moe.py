"""Mixture-of-Experts FFN: the gather dispatch of ``repro/models/moe.py``.

Sorted-capacity dispatch: the T*k (token, expert) assignments are sorted
by expert id (stably, so ties keep token order), ranked within their
expert, and copied into per-expert buffers [E, C, d]; an assignment
ranked at or past the capacity C is dropped.  The three expert products
run as batched matmuls over E, and the outputs are weighted back onto
their tokens.  The capacity couples the tokens of one call: whether an
assignment is dropped depends on the other rows of the same ``x2d``.

Scoring: 'softmax' (classic top-k, switch-style aux loss) or 'sigmoid'
(DeepSeek-V3: sigmoid scores, the bias steers only the selection, the
top-k weights are re-normalised).

Every step is a fixed-shape tensor op: no boolean-mask indexing, no
``nonzero`` and nothing that waits for the device, so the decode step
and the train step that run it can be captured as CUDA graphs.  Where the
reference drops an out-of-range scatter (``mode="drop"``), the buffer here
has a sink row past its last slot that takes every dropped assignment and
is sliced off (an out-of-range index faults on CUDA); the combine reads a
dropped assignment from a zero row past the experts' outputs.

The backward is torch's, and deterministic: no gather that carries a
gradient reads one row twice, except the discarded zero row (a repeated
index would sum its gradient rows by index), the ``gather`` of the top-k
scores and the ``topk`` itself write each gradient element once, and the
routing's ``index_add_`` carries no gradient (it adds equal shares, in
any order the same sum).  Only the routing weights, and through
``frac_probs`` the aux loss, carry gradient into the router; the
selection bias of sigmoid scoring gets none.

Under a model axis (``sharding/tp.py``) whose size divides the experts,
each rank holds its run of experts and dispatches only the assignments
they take; the combine weights this rank's expert outputs, the ranks'
results are summed, and the routing weights' gradient is summed over the
ranks (each rank's part of it comes from its own experts).  Two
dispatches, as in the reference:

  * ``gather`` (the default) keeps the reference's global semantics on
    any mesh: the routing and the capacity rank the global token set, so
    where the data axes split the batch the rows are gathered over the
    data group first (``distributed.gather_rows``; backward, each rank's
    rows of the summed gradient) and each rank keeps its rows of the
    result;
  * ``REPRO_MOE=ep`` (``apply_moe_ep``, the reference's ``shard_map``):
    each data shard routes and ranks capacity over its own tokens, and its
    aux loss enters the global loss as the mean over the data shards
    (``lm.train_loss`` weights each rank's share).
"""
from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from repro_torch import distributed
from repro_torch.models.layers import apply_dense_ffn, make_dense_ffn
from repro_torch.models.params import Param
from repro_torch.sharding.rules import QUEUE_A9B, current_rules, shard
from repro_torch.sharding.tp import data_rows, model_axis


def make_moe(cfg):
    d, m = cfg.d_model, cfg.moe
    p = {
        "router": Param((d, m.num_experts), ("embed", None), init="scaled",
                        dtype="float32"),
        "wi": Param((m.num_experts, d, m.d_ff_expert),
                    ("experts", "embed", None), init="scaled"),
        "wg": Param((m.num_experts, d, m.d_ff_expert),
                    ("experts", "embed", None), init="scaled"),
        "wo": Param((m.num_experts, m.d_ff_expert, d),
                    ("experts", None, "embed"), init="scaled"),
    }
    if m.num_shared_experts:
        p["shared"] = make_dense_ffn(
            cfg.replace(act="silu"), m.num_shared_experts * m.d_ff_expert)
    if m.scoring == "sigmoid":
        p["bias"] = Param((m.num_experts,), (None,), init="zeros",
                          dtype="float32")
    return p


def _route(cfg, p, x2d):
    """x2d: [T, d] -> (weights [T, k] fp32, ids [T, k] int32, aux fp32).

    ``torch.topk`` returns the k ids in descending order of score, as
    ``lax.top_k`` does; that order decides each assignment's rank in its
    expert, and so which are dropped."""
    m = cfg.moe
    logits = x2d.float() @ p["router"]                      # [T, E]
    if m.scoring == "sigmoid":
        scores = torch.sigmoid(logits)
        sel = scores + p["bias"][None, :]   # the bias only steers selection
        ids = torch.topk(sel, m.top_k, dim=-1).indices
        w = scores.gather(1, ids)
        w = w / (w.sum(dim=1, keepdim=True) + 1e-20)
        probs = scores / (scores.sum(dim=1, keepdim=True) + 1e-20)
    else:
        probs = torch.softmax(logits, dim=-1)
        w, ids = torch.topk(probs, m.top_k, dim=-1)
    # switch-style load-balance loss: E * sum_e f_e * p_e
    T = x2d.shape[0]
    ones = torch.full((T * m.top_k,), 1.0 / (T * m.top_k),
                      dtype=torch.float32, device=x2d.device)
    frac_tokens = torch.zeros(m.num_experts, dtype=torch.float32,
                              device=x2d.device).index_add_(
                                  0, ids.reshape(-1), ones)
    frac_probs = probs.mean(dim=0)
    aux = m.num_experts * (frac_tokens * frac_probs).sum()
    return w, ids.int(), aux


def _capacity(cfg, T: int) -> int:
    """Slots per expert: T*k*capacity_factor/E rounded up to 8, at least 8
    (the capacity factor is the config's; where the reference's sweeps
    set the environment override ``REPRO_MOE_CF``, the port's dry-run
    variant ``moe_cf`` replaces the config's ``moe.capacity_factor``,
    ``launch/dryrun.py::cell_config``, with no environment variable)."""
    m = cfg.moe
    c = int(T * m.top_k * m.capacity_factor / m.num_experts)
    return max(8, -(-c // 8) * 8)


def expert_ffn(p, buf):
    """The experts' SwiGLU on their buffers: buf [E, C, d] -> [E, C, d],
    three batched matmuls over E.  Each expert's rows meet only its own
    weights."""
    h = torch.bmm(buf, p["wi"])
    g = torch.bmm(buf, p["wg"])
    h = shard(F.silu(g) * h, "experts", None, None)
    return torch.bmm(h, p["wo"])


def _dispatch(ids, E: int, C: int, base: int = 0):
    """The sorted-capacity plan of ``ids`` [T, k] over the experts [base,
    base + E): (order [T*k], the assignments in expert order, those of
    other experts last; keep [T*k] bool, an assignment of these experts
    ranked below C; slot [T*k], the buffer row of each kept assignment
    and the sink row E*C of every other)."""
    flat_ids = ids.reshape(-1).long() - base
    flat_ids = torch.where((flat_ids >= 0) & (flat_ids < E), flat_ids,
                           torch.full_like(flat_ids, E))
    order = torch.argsort(flat_ids, stable=True)
    sorted_eid = flat_ids[order]
    # first sorted position of each expert: the exclusive prefix of counts
    offsets = torch.searchsorted(
        sorted_eid, torch.arange(E + 1, device=ids.device, dtype=torch.long))
    rank = torch.arange(ids.numel(), device=ids.device) - offsets[sorted_eid]
    keep = (rank < C) & (sorted_eid < E)
    slot = torch.where(keep, sorted_eid * C + rank,
                       torch.full_like(rank, E * C))
    return order, keep, slot


def _experts(p, x2d, w, ids, E: int, C: int, base: int = 0):
    """The assignments of ``ids`` to the experts [base, base + E) (``p``'s
    stacks), dispatched, run and weighted back onto their tokens: y [T, d]
    (the other experts' shares left out)."""
    T, d = x2d.shape
    k = ids.shape[1]
    # ---- sorted-capacity dispatch (row E*C is the sink) ----------------
    # the assignments in expert order: a permutation of the k copies of
    # each token, so the backward sums each token's copies in a fixed
    # order (a gather of x2d by token id would accumulate its k gradient
    # rows by duplicate index)
    # (the plan over every expert keeps the three-argument call that the
    # routing recorders of chip_smoke.py and the tests wrap)
    order, _, slot = (_dispatch(ids, E, C) if base == 0
                      else _dispatch(ids, E, C, base))
    buf = x2d.new_zeros((E * C + 1, d))
    buf[slot] = x2d[:, None].expand(T, k, d).reshape(T * k, d)[order]
    buf = shard(buf[:E * C].reshape(E, C, d), "experts", None, None)

    # ---- expert compute (batched over E) -------------------------------
    y_buf = expert_ffn(p, buf).reshape(E * C, d)

    # ---- combine back --------------------------------------------------
    # a dropped assignment reads the zero row E*C, whose gradient is
    # discarded: every kept slot is read once
    y_sorted = torch.cat([y_buf, y_buf.new_zeros((1, d))])[slot]
    y_flat = torch.empty((T * k, d), dtype=x2d.dtype, device=x2d.device)
    y_flat[order] = y_sorted          # a permutation: every row written once
    return torch.einsum("tkd,tk->td", y_flat.reshape(T, k, d),
                        w.to(x2d.dtype))


def _split_experts(cfg, p, x2d, w, ids, C: int):
    """``_experts`` over every expert: this rank's run of them and the sum
    over the model axis where it splits the experts (the routing weights
    and the tokens enter the region, so their gradients sum over the
    ranks), else all of them here."""
    E = cfg.moe.num_experts
    tp = model_axis()
    if tp is None or not tp.splits("experts", E):
        return _experts(p, x2d, w, ids, E, C)
    e_loc = E // tp.size
    y = _experts(p, tp.enter(x2d), tp.enter(w), ids, e_loc, C,
                 tp.rank * e_loc)
    return tp.leave(y)


def _shared(cfg, p, x2d, y):
    m = cfg.moe
    if m.num_shared_experts:
        y = y + apply_dense_ffn(cfg, p["shared"], x2d,
                                width=m.num_shared_experts * m.d_ff_expert)
    return y


def apply_moe_gather(cfg, p, x2d):
    """x2d: [T, d] -> (y [T, d], aux_loss * aux_loss_coef).  Routed and
    capacity-ranked over the global token set: where the data axes split
    the batch (``tp.data_rows``) the ranks' rows are gathered first and
    this rank's rows of the result kept."""
    m = cfg.moe
    rows = data_rows()
    x_all = x2d if rows is None else distributed.gather_rows(x2d, 0, rows)
    C = _capacity(cfg, x_all.shape[0])
    w, ids, aux = _route(cfg, p, x_all)
    y = _split_experts(cfg, p, x_all, w, ids, C)
    if rows is not None:
        n = x2d.shape[0]
        i = torch.distributed.get_rank(rows)
        y = y[i * n:(i + 1) * n]
    return _shared(cfg, p, x2d, y), aux * m.aux_loss_coef


def apply_moe_ep(cfg, p, x2d):
    """The reference's expert-parallel dispatch: this rank's tokens (its
    data shard's, the same on every rank of its model group) routed and
    capacity-ranked among themselves, its run of experts run, one sum over
    the model axis; the aux loss is this data shard's (its mean over the
    shards is ``lm.train_loss``'s)."""
    m = cfg.moe
    if data_rows() is None and distributed.world(
            distributed.data_group(current_rules().mesh)) > 1:
        raise NotImplementedError(
            "REPRO_MOE=ep where the data axes hold the whole batch on "
            "every rank: the reference splits the token rows across the "
            f"shards unaligned to the sequences: {QUEUE_A9B}")
    C = _capacity(cfg, x2d.shape[0])
    w, ids, aux = _route(cfg, p, x2d)
    y = _split_experts(cfg, p, x2d, w, ids, C)
    return _shared(cfg, p, x2d, y), aux * m.aux_loss_coef


def apply_moe(cfg, p, x2d):
    """x2d: [T, d]. Returns (y [T, d], aux_loss scalar): the expert-parallel
    dispatch with ``REPRO_MOE=ep`` under rules whose mesh has a model
    axis, as the reference picks it, else the gather dispatch."""
    rules = current_rules()
    if os.environ.get("REPRO_MOE", "gather") == "ep" and rules is not None \
            and distributed.MODEL_AXIS in distributed.mesh_axes(
                rules.mesh)[0]:
        return apply_moe_ep(cfg, p, x2d)
    return apply_moe_gather(cfg, p, x2d)
