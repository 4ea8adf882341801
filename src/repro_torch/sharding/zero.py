"""ZeRO-1: shard optimizer state over the data-parallel axes (a port of
``repro/sharding/zero.py``).

Parameters are TP-sharded over 'model'; their optimizer moments (and fp32
master copies) are additionally sharded over the DP axes ('pod','data') on
the first divisible unsharded dimension.  This is what makes Adam states of
a 671B model representable: state bytes/device scale with
1/(model_parallel * data_parallel) instead of 1/model_parallel.  Each rank
keeps its slices of the state (``train/optimizer.py``); the specs here say
which.
"""
from __future__ import annotations

import math

from repro_torch.distributed import mesh_axes
from repro_torch.models.params import Param, tree_map
from repro_torch.sharding.rules import (NamedSharding, PartitionSpec,
                                        ShardingRules)


def _dp_axes(rules: ShardingRules) -> tuple[str, ...]:
    names, _ = mesh_axes(rules.mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def zero1_spec(spec: PartitionSpec, shape, rules: ShardingRules) -> PartitionSpec:
    """Add the DP axes to the first unsharded, divisible dim of ``spec``."""
    dp = _dp_axes(rules)
    if not dp:
        return spec
    dp_size = math.prod(mesh_axes(rules.mesh)[1][a] for a in dp)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    for i, (e, d) in enumerate(zip(entries, shape, strict=False)):
        if e is None and d % dp_size == 0:
            entries[i] = dp if len(dp) > 1 else dp[0]
            return PartitionSpec(*entries)
    return spec


def _normalize(spec: PartitionSpec, ndim: int) -> list:
    return list(spec) + [None] * (ndim - len(spec))


def adamw_state_shardings(descr_tree, rules: ShardingRules, zero1: bool = True):
    """Sharding tree matching AdamW.init's state structure."""

    def per(p: Param):
        spec = rules.spec(p.logical, p.shape)
        if zero1:
            spec = zero1_spec(spec, p.shape, rules)
        return NamedSharding(rules.mesh, spec)

    moment = tree_map(per, descr_tree)
    return {
        "m": moment,
        "v": moment,
        "master": moment,
        "count": NamedSharding(rules.mesh, PartitionSpec()),
    }


def adafactor_state_shardings(descr_tree, rules: ShardingRules,
                              zero1: bool = True):
    def per(p: Param):
        spec = _normalize(rules.spec(p.logical, p.shape), len(p.shape))
        if len(p.shape) >= 2:
            vr_shape, vr_spec = p.shape[:-1], spec[:-1]
            vc_shape = p.shape[:-2] + p.shape[-1:]
            vc_spec = spec[:-2] + spec[-1:]
            vr = PartitionSpec(*vr_spec)
            vc = PartitionSpec(*vc_spec)
            if zero1:
                vr = zero1_spec(vr, vr_shape, rules)
                vc = zero1_spec(vc, vc_shape, rules)
            return {"vr": NamedSharding(rules.mesh, vr),
                    "vc": NamedSharding(rules.mesh, vc)}
        v = PartitionSpec(*spec)
        if zero1:
            v = zero1_spec(v, p.shape, rules)
        return {"v": NamedSharding(rules.mesh, v)}

    return {
        "v": tree_map(per, descr_tree),
        "count": NamedSharding(rules.mesh, PartitionSpec()),
    }


def opt_state_shardings(opt_name: str, descr_tree, rules: ShardingRules,
                        zero1: bool = True):
    if opt_name == "adamw":
        return adamw_state_shardings(descr_tree, rules, zero1)
    if opt_name == "adafactor":
        return adafactor_state_shardings(descr_tree, rules, zero1)
    raise KeyError(opt_name)
