"""Parameter descriptors: single source of truth for the shape, init and
dtype of every model parameter (and of the decode cache).

Model definitions build a nested tree (dicts and lists) of ``Param`` leaves
with the same paths and shapes as the JAX package's tree, so weights cross
between the two key by key (``models/convert.py``).  ``init_params``
materialises the tree on a device with the reference's distributions; it
cannot reproduce JAX's bits (``jax.random.fold_in`` over crc32 paths).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.device import resolve_device

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass(frozen=True)
class Param:
    shape: tuple
    logical: tuple          # logical axis name (or None) per dim
    init: str = "normal"    # normal | zeros | ones | scaled | const
    dtype: str = "bfloat16"
    scale: float | None = None  # for 'normal': std; for 'const': the value

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(f"shape {self.shape} vs logical {self.logical}")


def is_param(x) -> bool:
    return isinstance(x, Param)


def tree_map(fn, tree):
    """Map ``fn`` over the leaves of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_map2(fn, tree, other):
    """``fn(leaf, matching)`` over the leaves of ``tree``, a new tree;
    ``other`` has ``tree``'s structure down to each leaf, where its
    sub-tree (a leaf, or a dict of a leaf's parts) is passed whole."""
    if isinstance(tree, dict):
        return {k: tree_map2(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map2(fn, v, other[i]) for i, v in enumerate(tree)]
    return fn(tree, other)


def tree_leaves(tree) -> list:
    out: list = []
    tree_map(out.append, tree)
    return out


# A normal leaf is drawn in slices of its leading (layer) axis, as many as
# fit in this many elements, into a tensor of its final dtype, so no fp32
# copy of a large leaf ever exists (granite-20b's stacked FFN weight alone
# is 7.85 G elements, 29 GiB in fp32).  Where one slice alone is larger,
# each slice is drawn the same way along its own leading axis, down to an
# axis whose slices fit (a stack of MoE experts: deepseek-v3's [layers,
# 256, 7168, 2048], jamba's [super-blocks, 4, 16, 4096, 14336]).  A leaf
# no larger than this is one slice: one fp32 draw of its shape, scaled and
# cast, the bits of a single draw (every leaf of smollm-360m and
# mamba2-130m is).
SLICED_DRAW_ELEMS = 2**28

# The optimizer side (``train/optimizer.py``: the global norm and
# Adafactor's update) takes a leaf larger than this one slice of its stack
# axes (all but the last two) at a time, the slices cut as
# ``_fill_normal`` cuts its draws (``stack_slices``), so its fp32
# temporaries are a slice's, not the leaf's: jamba-v0.1-52b's expert
# stacks [super-blocks, 4, 16, 4096, 14336] hold 3.76 G elements a
# super-block, 15 GB in fp32 for each temporary.  A leaf no larger keeps
# the whole-leaf arithmetic and its bits: 2**31 is olmoe-1b-7b's full
# expert stack, the largest leaf of every other config that trains.
SLICED_UPDATE_ELEMS = 2**31


def stack_slices(shape) -> list:
    """Index tuples that cut a leaf of ``shape`` into the slices the
    optimizer side takes one at a time: ``[()]`` (the whole leaf) for a
    leaf of at most ``SLICED_UPDATE_ELEMS`` elements or of fewer than
    three axes; else as many leading-axis slices at a time as fit in
    ``SLICED_DRAW_ELEMS`` (at least one), one axis down where one alone
    does not fit, never into the last two axes (Adafactor's factored
    ones), so each tuple indexes the leaf and its factored moments
    alike."""
    shape = tuple(shape)
    if math.prod(shape) <= SLICED_UPDATE_ELEMS or len(shape) < 3:
        return [()]
    return list(_stack_slices(shape, ()))


def _stack_slices(shape: tuple, lead: tuple):
    inner = math.prod(shape[1:])
    if len(shape) > 3 and inner > SLICED_DRAW_ELEMS:
        for i in range(shape[0]):
            yield from _stack_slices(shape[1:], (*lead, i))
        return
    rows = max(1, SLICED_DRAW_ELEMS // max(1, inner))
    for i in range(0, shape[0], rows):
        yield (*lead, slice(i, i + rows))


def _fill_normal(out: torch.Tensor, std: float, generator) -> None:
    """Fill ``out`` with N(0, std), as many leading-axis slices at a time
    as fit in ``SLICED_DRAW_ELEMS`` (at least one), each drawn in fp32,
    scaled in place and cast into ``out``; a slice that alone does not fit
    is filled by the same rule, one axis down."""
    inner = math.prod(out.shape[1:])
    if out.ndim > 1 and inner > SLICED_DRAW_ELEMS:
        for i in range(out.shape[0]):
            _fill_normal(out[i], std, generator)
        return
    rows = max(1, SLICED_DRAW_ELEMS // max(1, inner))
    for i in range(0, out.shape[0], rows):
        part = out[i:i + rows]
        x = torch.randn(part.shape, generator=generator, dtype=torch.float32,
                        device=out.device)
        part.copy_(x.mul_(std))
        del x       # before the next draw, which can then reuse its memory


def _normal(shape, std: float, dtype, generator, device) -> torch.Tensor:
    """N(0, std) of ``shape`` in ``dtype`` (``_fill_normal``; a ``meta``
    tensor holds no values, so nothing is drawn for it)."""
    out = torch.empty(shape, dtype=dtype, device=device)
    if out.device.type != "meta":
        _fill_normal(out, std, generator)
    return out


def _init_one(p: Param, generator, device) -> torch.Tensor:
    dtype = DTYPES[p.dtype]
    if p.init == "zeros":
        return torch.zeros(p.shape, dtype=dtype, device=device)
    if p.init == "ones":
        return torch.ones(p.shape, dtype=dtype, device=device)
    if p.init == "const":
        return torch.full(p.shape, p.scale, dtype=dtype, device=device)
    if p.init == "scaled":  # 1/sqrt(fan_in) for matmul weights
        fan_in = p.shape[-2] if len(p.shape) >= 2 else p.shape[-1]
        std = 1.0 / np.sqrt(fan_in)
    else:
        std = 0.02 if p.scale is None else p.scale
    return _normal(p.shape, float(std), dtype, generator, device)


def init_params(tree, generator: torch.Generator | None = None,
                device: str | torch.device = "cuda", parts=None):
    """Materialise a descriptor tree on ``device``.

    Normal draws come from ``generator`` (which must live on ``device``),
    leaf by leaf in tree order; zeros/ones/const leaves draw nothing.
    ``parts`` (a tree of ``sharding.rules.Part`` or None, this rank's
    model-axis part of each leaf: ``sharding/tp.py::param_parts``) keeps
    this rank's slice of each leaf: every leaf is drawn whole, so every
    mesh starts from the one device's weights."""
    dev = resolve_device(device)
    if parts is None:
        return tree_map(lambda p: _init_one(p, generator, dev), tree)

    def one(p, part):
        x = _init_one(p, generator, dev)
        return x if part is None else part.take(x).clone()

    return tree_map2(one, tree, parts)


@dataclass(frozen=True)
class AbstractParam:
    """A leaf without memory (``jax.ShapeDtypeStruct`` with a sharding): a
    ``meta`` tensor of its shape and dtype, and its spec under the rules
    (None without rules)."""
    value: torch.Tensor
    spec: object = None


def abstract_params(tree, rules=None):
    def go(p: Param):
        spec = rules.spec(p.logical, p.shape) if rules is not None else None
        return AbstractParam(torch.empty(p.shape, dtype=DTYPES[p.dtype],
                                         device="meta"), spec)

    return tree_map(go, tree)


def param_specs(tree, rules):
    return tree_map(lambda p: rules.spec(p.logical, p.shape), tree)


def param_shardings(tree, rules):
    return tree_map(lambda p: rules.sharding(p.logical, p.shape), tree)


def param_count(tree) -> int:
    return sum(int(np.prod(p.shape)) for p in tree_leaves(tree)
               if is_param(p))


def cast_tree(tree, dtype: torch.dtype):
    return tree_map(lambda x: x.to(dtype), tree)
