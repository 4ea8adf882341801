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
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models.params import stack_slices, tree_leaves, tree_map


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

    def init(self, params):
        def f32(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        return {
            "m": tree_map(f32, params),
            "v": tree_map(f32, params),
            "master": tree_map(lambda p: p.detach().float().clone(), params),
            "count": torch.zeros((), dtype=torch.int32,
                                 device=tree_leaves(params)[0].device),
        }

    @torch.no_grad()
    def update(self, grads, state, params, lr):
        c = state["count"] + 1
        b1c = 1 - self.b1 ** c.float()
        b2c = 1 - self.b2 ** c.float()

        def upd(g, m, v, master, p):
            g = g.float()
            m.copy_(self.b1 * m + (1 - self.b1) * g)
            v.copy_(self.b2 * v + (1 - self.b2) * torch.square(g))
            mh, vh = m / b1c, v / b2c
            step = mh / (torch.sqrt(vh) + self.eps) + self.weight_decay * master
            master.copy_(master - lr * step)
            p.copy_(master)

        _zip_each(upd, grads, state["m"], state["v"], state["master"], params)
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

    def init(self, params):
        def per(p):
            def z(shape):
                return torch.zeros(shape, dtype=torch.float32, device=p.device)

            if p.ndim >= 2:
                return {"vr": z(p.shape[:-1]),
                        "vc": z(p.shape[:-2] + p.shape[-1:])}
            return {"v": z(p.shape)}

        return {"v": tree_map(per, params),
                "count": torch.zeros((), dtype=torch.int32,
                                     device=tree_leaves(params)[0].device)}

    @torch.no_grad()
    def update(self, grads, state, params, lr):
        c = state["count"] + 1
        rho = 1.0 - c.float() ** -self.decay

        def upd(g, v, p):
            parts = stack_slices(g.shape)
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

        _zip_each(upd, grads, state["v"], params)
        state["count"].copy_(c)
        return params, state

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
