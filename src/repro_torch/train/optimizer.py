"""Optimizers in plain torch ops (a port of ``repro/train/optimizer.py``):
AdamW with fp32 master weights, and Adafactor (factored second moment).

The state is a plain tree of tensors with the JAX tree's keys (AdamW
``m``, ``v``, ``master``, ``count``; Adafactor ``v/<path>/vr|vc|v`` and
``count``), so the checkpointer writes it in the JAX package's layout and
a checkpoint crosses frameworks.  ``update`` writes the new parameters
and state into the tensors it was given (JAX's ``donate_argnums``: a
captured train step reads and writes them at fixed addresses) and returns
those same trees.  It keeps the reference's arithmetic op for op, each
result written with ``copy_``, so the bits equal a functional update's; a
caller that needs the old values clones them first.

A leaf above ``params.SLICED_UPDATE_ELEMS`` (jamba-v0.1-52b's expert
stacks) goes through the global norm and Adafactor's update one stack
slice at a time (``params.stack_slices``), so no fp32 temporary of the
whole leaf exists: the same arithmetic, with the sums over the leaf (its
square sum, Adafactor's update RMS) taken over the slices' sums.  Every
other leaf keeps the whole-leaf ops and their bits.

ZeRO-1 (data-parallel ranks, ``layout``): each rank keeps only its slice
of the state, as ``sharding/zero.py::opt_state_shardings`` lays it out
(``layout`` reads it: a ``rules.Part`` a sliced leaf, None a whole one).
``update`` then takes the rank's slice of the reduced gradients (every
rank holds them whole), updates its state slice and its slice of the
params, and all-gathers the params.  AdamW's arithmetic is elementwise,
so its bits are the whole leaf's.  Adafactor's is not: a factored
statistic that reduces over the sliced dim is all-reduced before use
(the row mean ``vr`` where the columns are sliced, the column mean ``vc``
where the rows are), the update direction reads whole rows and columns
of the moments (each rank's slices of ``vr`` and ``vc`` are gathered: the
row normaliser ``vr.mean(-1)`` reduces over the rows), and the update's
RMS is summed over the ranks.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from repro_torch import distributed
from repro_torch.models.params import (stack_slices, tree_leaves, tree_map,
                                       tree_map2)
from repro_torch.sharding.rules import QUEUE_A9B, NamedSharding
from repro_torch.sharding.zero import opt_state_shardings, zero1_spec


def _zip_each(fn, tree, *others):
    """``fn(leaf, *matching)`` for each leaf of ``tree`` (dicts and lists),
    with the sub-trees of ``others`` at the same paths; a matching sub-tree
    may itself be a dict (Adafactor's per-leaf state)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            _zip_each(fn, v, *(o[k] for o in others))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _zip_each(fn, v, *(o[i] for o in others))
    else:
        fn(tree, *others)


def _nones(params):
    return tree_map(lambda _: None, params)


def _take(part, x):
    return x if part is None else part.take(x)


def _to_part(x, have, want):
    """``x``, laid out as ``have`` (a Part, or None for whole), as
    ``want`` lays it out."""
    if have == want:
        return x
    if have is not None:
        x = have.gather(x)
    return _take(want, x)


def _square_sum(x) -> torch.Tensor:
    """sum(x^2) in fp32, slice by slice for a leaf that ``stack_slices``
    cuts."""
    sums = [torch.sum(torch.square(x[i].float())) for i in stack_slices(x.shape)]
    return sum(sums[1:], sums[0])


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(_square_sum(x) for x in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    """Scales ``grads`` to a global norm of at most ``max_norm``, in place
    (the bits of the reference's ``g * scale``, without a second copy of
    the gradients, nor an fp32 one of a large leaf), and returns (grads,
    their norm before)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    for g in tree_leaves(grads):
        g.mul_(scale.to(g.dtype))
    return grads, norm


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class AdamW:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1

    @staticmethod
    def layout(descr, rules, zero1: bool = True):
        """This rank's ``Part`` of each leaf's m, v and master (None for a
        whole leaf), from ``opt_state_shardings``."""
        sh = opt_state_shardings("adamw", descr, rules, zero1=zero1)
        return tree_map(NamedSharding.part, sh["m"])

    def init(self, params, layout=None):
        layout = _nones(params) if layout is None else layout

        def f32(p, part):
            return torch.zeros(_take(part, p).shape, dtype=torch.float32,
                               device=p.device)

        return {
            "m": tree_map2(f32, params, layout),
            "v": tree_map2(f32, params, layout),
            "master": tree_map2(lambda p, part: _take(part, p).detach()
                               .float().clone(), params, layout),
            "count": torch.zeros((), dtype=torch.int32,
                                 device=tree_leaves(params)[0].device),
        }

    @torch.no_grad()
    def update(self, grads, state, params, lr, layout=None):
        c = state["count"] + 1
        b1c = 1 - self.b1 ** c.float()
        b2c = 1 - self.b2 ** c.float()

        def upd(g, m, v, master, p, part):
            g = _take(part, g).float()
            m.copy_(self.b1 * m + (1 - self.b1) * g)
            v.copy_(self.b2 * v + (1 - self.b2) * torch.square(g))
            mh, vh = m / b1c, v / b2c
            step = mh / (torch.sqrt(vh) + self.eps) + self.weight_decay * master
            master.copy_(master - lr * step)
            p.copy_(master if part is None
                    else part.gather(master.to(p.dtype)))

        _zip_each(upd, grads, state["m"], state["v"], state["master"], params,
                  _nones(params) if layout is None else layout)
        state["count"].copy_(c)
        return params, state


# ---------------------------------------------------------------------------
# Adafactor (factored v; no master copy -> ~4 bytes/param state)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Adafactor:
    decay: float = 0.8
    eps: float = 1e-30
    clip_threshold: float = 1.0
    weight_decay: float = 0.0

    @staticmethod
    def layout(descr, rules, zero1: bool = True):
        """This rank's parts of each leaf: ``vr`` / ``vc`` (or ``v``) from
        ``opt_state_shardings``, and ``p``, the slice of the param it
        updates: its spec with ZeRO-1's data axes added (AdamW's moment
        spec; None for a whole leaf)."""
        sh = opt_state_shardings("adafactor", descr, rules, zero1=zero1)

        def per(p, moments):
            spec = rules.spec(p.logical, p.shape)
            if zero1:
                spec = zero1_spec(spec, p.shape, rules)
            return {"p": NamedSharding(rules.mesh, spec).part(),
                    **{k: s.part() for k, s in moments.items()}}

        return tree_map2(per, descr, sh["v"])

    def init(self, params, layout=None):
        layout = _nones(params) if layout is None else layout

        def per(p, parts):
            def z(shape, key):
                shape = list(shape)
                part = None if parts is None else parts[key]
                if part is not None:
                    shape[part.dim] //= part.parts
                return torch.zeros(shape, dtype=torch.float32, device=p.device)

            if p.ndim >= 2:
                return {"vr": z(p.shape[:-1], "vr"),
                        "vc": z(p.shape[:-2] + p.shape[-1:], "vc")}
            return {"v": z(p.shape, "v")}

        return {"v": tree_map2(per, params, layout),
                "count": torch.zeros((), dtype=torch.int32,
                                     device=tree_leaves(params)[0].device)}

    @torch.no_grad()
    def update(self, grads, state, params, lr, layout=None):
        c = state["count"] + 1
        rho = 1.0 - c.float() ** -self.decay

        def upd(g, v, p, parts_of):
            parts = stack_slices(g.shape)
            if parts_of is not None and any(parts_of.values()):
                if len(parts) > 1:
                    raise NotImplementedError(
                        f"ZeRO-1 over a leaf of {tuple(g.shape)} cut into "
                        f"stack slices (the MoE expert stacks): {QUEUE_A9B}")
                self._zero_update(g, v, p, parts_of, rho, lr)
                return
            if len(parts) == 1:
                u = self._moments(g.float(), v, rho)
                rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-30)
                self._apply(p, u, rms, lr)
                return
            # two passes over the slices: the moments and the square sum of
            # u, then u again from the stored moments (the same bits) and
            # the update clipped by the RMS over the whole leaf
            sums = [torch.sum(torch.square(self._moments(
                        g[i].float(), {k: m[i] for k, m in v.items()}, rho)))
                    for i in parts]
            rms = torch.sqrt(sum(sums[1:], sums[0]) / g.numel() + 1e-30)
            for i in parts:
                self._apply(p[i], _factored_u(g[i].float(), v["vr"][i],
                                              v["vc"][i]), rms, lr)

        _zip_each(upd, grads, state["v"], params,
                  _nones(params) if layout is None else layout)
        state["count"].copy_(c)
        return params, state

    def _zero_update(self, g, v, p, parts, rho, lr):
        """One leaf's update from this rank's slices (ZeRO-1): the
        whole-leaf arithmetic of ``_moments`` and ``_apply`` on the rank's
        slice ``parts["p"]`` of the param, with what reduces over the
        sliced dim summed over the ranks (module docstring)."""
        zp = parts["p"]
        gs = _take(zp, g).float()
        if "vr" in v:
            nd = g.ndim
            g2 = torch.square(gs) + self.eps
            r, r_part = _mean(g2, nd - 1, zp)
            c, c_part = _mean(g2, nd - 2, zp)
            v["vr"].copy_(rho * v["vr"]
                          + (1 - rho) * _to_part(r, r_part, parts["vr"]))
            v["vc"].copy_(rho * v["vc"]
                          + (1 - rho) * _to_part(c, c_part, parts["vc"]))
            vr = _to_part(v["vr"], parts["vr"], None)
            vc = _to_part(v["vc"], parts["vc"], None)
            rows = torch.sqrt(vr / vr.mean(dim=-1, keepdim=True))[..., None]
            cols = torch.sqrt(vc)[..., None, :]
            if zp is not None and zp.dim != nd - 1:
                rows = zp.take(rows)
            if zp is not None and zp.dim != nd - 2:
                cols = zp.take(cols)
            u = gs / rows / cols
        else:
            v["v"].copy_(rho * v["v"] + (1 - rho) * (torch.square(gs)
                                                      + self.eps))
            u = gs / torch.sqrt(v["v"])
        sq = torch.sum(torch.square(u))
        if zp is not None:
            distributed.all_reduce(sq, "sum", zp.group)
        rms = torch.sqrt(sq / g.numel() + 1e-30)
        u = u / torch.clamp(rms / self.clip_threshold, min=1.0)
        pf = _take(zp, p).float()
        new = pf - lr * u - lr * self.weight_decay * pf
        p.copy_(new if zp is None else zp.gather(new.to(p.dtype)))

    def _moments(self, g, v, rho):
        """The update direction u of the fp32 gradient ``g``, with the
        second moments ``v`` (factored for a matrix) written in place."""
        g2 = torch.square(g) + self.eps
        if "vr" in v:
            vr = rho * v["vr"] + (1 - rho) * g2.mean(dim=-1)
            vc = rho * v["vc"] + (1 - rho) * g2.mean(dim=-2)
            u = _factored_u(g, vr, vc)
            v["vr"].copy_(vr)
            v["vc"].copy_(vc)
            return u
        v["v"].copy_(rho * v["v"] + (1 - rho) * g2)
        return g / torch.sqrt(v["v"])

    def _apply(self, p, u, rms, lr):
        """``p`` stepped in place by ``u`` clipped at the RMS ``rms``."""
        u = u / torch.clamp(rms / self.clip_threshold, min=1.0)
        pf = p.float()
        p.copy_(pf - lr * u - lr * self.weight_decay * pf)


def _mean(x, dim: int, part):
    """The mean of the whole leaf over ``dim``, from this rank's slice
    ``x`` (``part`` of the leaf, or None for the whole leaf), and the
    part of the result this rank holds: a sum over the ranks where the
    slice cuts ``dim`` (the result is then whole), else the slice's own
    mean, cut as ``part`` with ``dim`` removed."""
    if part is None:
        return x.mean(dim=dim), None
    if part.dim == dim:
        s = distributed.all_reduce(x.sum(dim=dim), "sum", part.group)
        return s / (x.shape[dim] * part.parts), None
    return x.mean(dim=dim), dataclasses.replace(
        part, dim=part.dim - (part.dim > dim))


def _factored_u(g, vr, vc):
    """g over the square root of the factored second moment, vr (rows)
    normed by its mean times vc (columns)."""
    denom = vr.mean(dim=-1, keepdim=True)
    return g / torch.sqrt(vr / denom)[..., None] / torch.sqrt(vc)[..., None, :]


def get_optimizer(name: str, **kw):
    if name == "adamw":
        return AdamW(**kw)
    if name == "adafactor":
        return Adafactor(**kw)
    raise KeyError(name)
