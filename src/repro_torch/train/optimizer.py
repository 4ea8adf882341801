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

Under a model axis (``sharding/tp.py``) each rank holds its part of a
model-split leaf, and its gradient, state and update are that part's; the
global norm sums the squares of such leaves over the model group and
counts every replicated leaf once, and every Adafactor statistic that
reduces over a model-split dim (its row and column means, the row
normaliser, the update's RMS) is summed over the model group.

ZeRO-1 (data-parallel ranks, ``layout``): each rank keeps only its slice
of the state, as ``sharding/zero.py::opt_state_shardings`` lays it out
(``layout`` reads it: a ``rules.Part`` a sliced leaf, None a whole one;
on a model-split leaf, a slice of this rank's model part).
``update`` then takes the rank's slice of the reduced gradients (every
rank holds them whole), updates its state slice and its slice of the
params, and all-gathers the params.  AdamW's arithmetic is elementwise,
so its bits are the whole leaf's.  Adafactor's is not: a factored
statistic that reduces over the sliced dim is all-reduced before use
(the row mean ``vr`` where the columns are sliced, the column mean ``vc``
where the rows are), the update direction reads whole rows and columns
of the moments (each rank's slices of ``vr`` and ``vc`` are gathered: the
row normaliser ``vr.mean(-1)`` reduces over the rows), and the update's
RMS is summed over the ranks.  A leaf that ``stack_slices`` cuts (the
expert stacks) is taken a slice at a time from this rank's ZeRO-1 slice
where the slices cut the stack dims alone.
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


def global_norm(tree, model_parts=None) -> torch.Tensor:
    """The global norm of ``tree``; with ``model_parts`` (a tree of each
    leaf's model-axis ``Part``, None for a whole leaf) the squares of the
    split leaves are summed over the model group, each replicated leaf
    counted once."""
    if model_parts is None:
        return torch.sqrt(sum(_square_sum(x) for x in tree_leaves(tree)))
    whole, split, groups = [], [], []

    def add(x, part):
        (whole if part is None else split).append(_square_sum(x))
        if part is not None:
            groups.append(part.group)

    _zip_each(add, tree, model_parts)
    group = groups[0] if groups else None
    total = sum(whole[1:], whole[0]) if whole else None
    if split:
        s = distributed.all_reduce(sum(split[1:], split[0]), "sum", group)
        total = s if total is None else total + s
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float, model_parts=None):
    """Scales ``grads`` to a global norm of at most ``max_norm``, in place
    (the bits of the reference's ``g * scale``, without a second copy of
    the gradients, nor an fp32 one of a large leaf), and returns (grads,
    their norm before)."""
    norm = global_norm(grads, model_parts)
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
        ``opt_state_shardings``, ``p``, the slice of the param it updates:
        its spec with ZeRO-1's data axes added (AdamW's moment spec; None
        for a whole leaf), and ``m``, the param's model-axis part."""
        sh = opt_state_shardings("adafactor", descr, rules, zero1=zero1)

        def per(p, moments):
            spec = rules.spec(p.logical, p.shape)
            model = NamedSharding(rules.mesh, spec).model_part()
            if zero1:
                spec = zero1_spec(spec, p.shape, rules)
            return {"p": NamedSharding(rules.mesh, spec).part(), "m": model,
                    **{k: s.part() for k, s in moments.items()}}

        return tree_map2(per, descr, sh["v"])

    def init(self, params, layout=None):
        layout = _nones(params) if layout is None else layout

        def per(p, parts):
            def z(shape, key):
                shape = list(shape)
                part = None if parts is None else parts[key]
                # (the model axis's part is p's own: p is this rank's)
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
                if len(stack_slices(_take(parts_of["p"], g).shape)) > 1:
                    self._split_sliced_update(g, v, p, parts_of, rho, lr)
                else:
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
        """One leaf's update from this rank's slices (ZeRO-1's ``p``, the
        model axis's ``m``): the whole-leaf arithmetic of ``_moments`` and
        ``_apply`` on the rank's slice ``parts["p"]`` of its model part,
        with what reduces over a sliced dim summed over the ranks (module
        docstring)."""
        zp, mp = parts["p"], parts.get("m")
        gs = _take(zp, g).float()
        nd = g.ndim
        if "vr" in v:
            g2 = torch.square(gs) + self.eps
            r, r_part = _mean(g2, nd - 1, zp, mp)
            c, c_part = _mean(g2, nd - 2, zp, mp)
            v["vr"].copy_(rho * v["vr"]
                          + (1 - rho) * _to_part(r, r_part, parts["vr"]))
            v["vc"].copy_(rho * v["vc"]
                          + (1 - rho) * _to_part(c, c_part, parts["vc"]))
            vr = _to_part(v["vr"], parts["vr"], None)
            vc = _to_part(v["vc"], parts["vc"], None)
            # the row normaliser: vr's mean over the rows (g's dim nd - 2)
            denom = _mean(vr, nd - 2, None, mp)[0][..., None]
            rows = torch.sqrt(vr / denom)[..., None]
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
        rms = self._split_rms(torch.sum(torch.square(u)), g, zp, mp)
        u = u / torch.clamp(rms / self.clip_threshold, min=1.0)
        pf = _take(zp, p).float()
        new = pf - lr * u - lr * self.weight_decay * pf
        p.copy_(new if zp is None else zp.gather(new.to(p.dtype)))

    @staticmethod
    def _split_rms(sq, g, zp, mp):
        """The update's RMS over the whole leaf from this rank's square
        sum ``sq`` of its slice of ``g``."""
        n = g.numel()
        for part in (zp, mp):
            if part is not None:
                distributed.all_reduce(sq, "sum", part.group)
        if mp is not None:
            n *= mp.parts
        return torch.sqrt(sq / n + 1e-30)

    def _split_sliced_update(self, g, v, p, parts, rho, lr):
        """``_zero_update`` for a leaf that ``stack_slices`` cuts (an
        expert stack): where ZeRO-1 and the model axis split stack dims
        only, the factored statistics of each stack slice are its own, and
        the rank's slice is stepped a stack slice at a time, as the
        whole-leaf path is, with the RMS's square sum over the ranks."""
        zp, mp = parts["p"], parts.get("m")
        nd = g.ndim
        if any(part is not None and part.dim >= nd - 2
               for part in (zp, mp, *(parts.get(k) for k in ("vr", "vc")))):
            raise NotImplementedError(
                f"a leaf of {tuple(g.shape)} cut into stack slices with "
                f"its ZeRO-1 or model-axis split on a factored dim: "
                f"{QUEUE_A9B}")
        gs, ps = _take(zp, g), _take(zp, p)
        cut = stack_slices(gs.shape)
        sums = [torch.sum(torch.square(self._moments(
                    gs[i].float(), {k: m[i] for k, m in v.items()}, rho)))
                for i in cut]
        rms = self._split_rms(sum(sums[1:], sums[0]), g, zp, mp)
        for i in cut:
            self._apply(ps[i], _factored_u(gs[i].float(), v["vr"][i],
                                           v["vc"][i]), rms, lr)
        if zp is not None:
            p.copy_(zp.gather(ps))

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


def _mean(x, dim: int, part, model=None):
    """The mean of the whole leaf over ``dim``, from this rank's slice
    ``x`` (``part`` of the leaf, or None for the whole leaf; ``model``,
    the model axis's part of the leaf, or None), and the part of the
    result this rank holds: a sum over the ranks where a slice cuts
    ``dim`` (the result is then whole over the data axes), else the
    slice's own mean, cut as ``part`` with ``dim`` removed."""
    on_model = model is not None and model.dim == dim
    on_data = part is not None and part.dim == dim
    if not (on_model or on_data):
        if part is None:
            return x.mean(dim=dim), None
        return x.mean(dim=dim), dataclasses.replace(
            part, dim=part.dim - (part.dim > dim))
    s, n = x.sum(dim=dim), x.shape[dim]
    if on_model:
        distributed.all_reduce(s, "sum", model.group)
        n *= model.parts
    if on_data:
        distributed.all_reduce(s, "sum", part.group)
        return s / (n * part.parts), None
    return s / n, (None if part is None else dataclasses.replace(
        part, dim=part.dim - (part.dim > dim)))


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
