"""Logical-axis sharding rules (a port of ``repro/sharding/rules.py``).

Model code annotates parameters and activations with *logical* axis names
('batch', 'heads', 'ffn', 'experts', 'vocab', ...).  A ``ShardingRules``
object (built from a mesh) resolves logical names to physical mesh axes,
dropping any axis whose dimension is not divisible by the mesh axes it
maps to (e.g. granite-20b's single KV head cannot be sharded over model=16
and falls back to replication -- the Megatron/MaxText convention).

The mesh is a ``torch.distributed`` ``DeviceMesh`` (``launch/mesh.py``) or
any object with ``axis_names`` and a ``shape`` mapping.  ``spec`` returns
the port's ``PartitionSpec``: a tuple whose entries are None, an axis name
or a tuple of names, entry for entry the reference's.

Rules are installed with ``use_rules(rules)``; model code calls
``shard(x, *logical)``.  The port shards the data axes only (ROADMAP Queue
A item 9a): each rank's activations already are its rows of the batch,
so ``shard`` returns ``x``; it refuses rules that shard anything else
(the model axis, the sequence), which are item 9b.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from dataclasses import dataclass, field

import torch

from repro_torch import distributed
from repro_torch.distributed import mesh_axes

QUEUE_A9B = "ROADMAP Queue A item 9b"


class PartitionSpec(tuple):
    """The mesh axes of each dim: None, an axis name, or a tuple of names."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def _names(entry) -> tuple:
    return (entry,) if isinstance(entry, str) else tuple(entry or ())


@dataclass(frozen=True)
class Part:
    """This rank's part of a leaf split over the data axes: the
    ``index``-th of ``parts`` equal slices along ``dim``, gathered back
    over ``group`` (ZeRO-1's optimizer state, the batch's rows)."""
    dim: int
    index: int
    parts: int
    group: object = None

    def take(self, x):
        """This rank's slice of ``x`` (a tensor or a numpy array): a view."""
        n = x.shape[self.dim] // self.parts
        return x[(slice(None),) * self.dim
                 + (slice(self.index * n, (self.index + 1) * n),)]

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return distributed.all_gather(x, self.dim, self.group)


@dataclass(frozen=True)
class NamedSharding:
    """A ``PartitionSpec`` over a mesh: ``part()`` is this rank's split of a
    leaf laid out so, ``local`` its slice of a whole leaf, ``full`` the
    whole leaf gathered from every rank's slice."""
    mesh: object
    spec: PartitionSpec

    def part(self) -> Part | None:
        """The split over the data axes, None for a replicated leaf.  Any
        other split (the model axis) is item 9b."""
        names, sizes = mesh_axes(self.mesh)
        coord = dict(zip(names, self.mesh.get_coordinate(), strict=True))
        found = None
        for dim, entry in enumerate(self.spec):
            axes = _names(entry)
            if math.prod(sizes[a] for a in axes) == 1 and not any(
                    a in distributed.DATA_AXES for a in axes):
                continue
            if any(a not in distributed.DATA_AXES for a in axes) \
                    or found is not None:
                raise NotImplementedError(f"{self.spec} splits a leaf over "
                                          f"more than the data axes: "
                                          f"{QUEUE_A9B}")
            index = 0
            for a in axes:
                index = index * sizes[a] + coord[a]
            found = Part(dim, index, math.prod(sizes[a] for a in axes),
                         distributed.data_group(self.mesh))
        return found

    def local(self, x: torch.Tensor) -> torch.Tensor:
        part = self.part()
        return x if part is None else part.take(x)

    def full(self, x: torch.Tensor) -> torch.Tensor:
        part = self.part()
        return x if part is None else part.gather(x)


# Default logical->physical tables.  'pod' participates in the batch axes on
# the multi-pod mesh (outer data parallelism across pods).
def default_table(mesh, seq_shard: bool = False) -> dict:
    axes, _ = mesh_axes(mesh)
    dp = tuple(a for a in ("pod", "data") if a in axes)
    tp = ("model",) if "model" in axes else ()
    table = {
        "batch": dp,
        "seq": (),          # sequence usually replicated ...
        "seq_kv": (),       # ... unless sequence sharding is on
        "vocab": tp,
        "heads": tp,
        "kv_heads": tp,
        "ffn": tp,
        "experts": tp,
        "embed": (),
        "model_dim": (),    # alias of embed for activations
        "state": (),
        "layers": (),
        "q_lora": (),
        "kv_lora": (),
        "codebooks": (),
    }
    if seq_shard:
        # long-context cells: batch < data-axis size -> shard sequence on data
        table["seq"] = ("data",)
        table["seq_kv"] = ("data",)
        table["batch"] = tuple(a for a in dp if a != "data")
    return table


@dataclass
class ShardingRules:
    mesh: object
    table: dict = field(default_factory=dict)

    def axis_size(self, phys: tuple[str, ...]) -> int:
        _, sizes = mesh_axes(self.mesh)
        return math.prod(sizes[a] for a in phys)

    def spec(self, logical, shape=None) -> PartitionSpec:
        """Resolve a logical spec (tuple of names/None) to a PartitionSpec.

        If ``shape`` is given, drop mesh axes that don't divide the dim.
        """
        out = []
        for i, name in enumerate(logical):
            if shape is not None and i >= len(shape):
                break  # caller passed more names than dims (e.g. 2-D path
                       # through a 3-D helper); extra names are moot
            if name is None:
                out.append(None)
                continue
            phys = self.table.get(name, ())
            if not phys:
                out.append(None)
                continue
            if shape is not None \
                    and shape[i] % self.axis_size(phys) != 0:
                out.append(None)
                continue
            out.append(phys[0] if len(phys) == 1 else phys)
        # PartitionSpec forbids repeating a mesh axis; guard against tables
        # that would double-use one (can happen with custom tables).
        seen: set[str] = set()
        clean = []
        for entry in out:
            names = _names(entry)
            if any(n in seen for n in names):
                clean.append(None)
            else:
                seen.update(names)
                clean.append(entry)
        return PartitionSpec(*clean)

    def sharding(self, logical, shape=None) -> NamedSharding:
        return NamedSharding(self.mesh, self.spec(logical, shape))

    def data_parallel_only(self) -> None:
        """Raise unless these rules shard nothing but the batch: a logical
        name other than 'batch' on mesh axes of more than one rank is the
        model axis (tensor and expert parallelism) or sequence sharding."""
        for name, phys in self.table.items():
            if name != "batch" and self.axis_size(tuple(phys)) > 1:
                raise NotImplementedError(
                    f"logical axis {name!r} sharded over {tuple(phys)} "
                    f"({self.axis_size(tuple(phys))} ranks): the model axis "
                    f"and sequence sharding are {QUEUE_A9B}")


_current: contextvars.ContextVar[ShardingRules | None] = contextvars.ContextVar(
    "sharding_rules", default=None
)


@contextlib.contextmanager
def use_rules(rules: ShardingRules | None):
    tok = _current.set(rules)
    try:
        yield rules
    finally:
        _current.reset(tok)


def current_rules() -> ShardingRules | None:
    return _current.get()


def make_rules(mesh, seq_shard: bool = False, **overrides) -> ShardingRules:
    table = default_table(mesh, seq_shard=seq_shard)
    table.update(overrides)
    return ShardingRules(mesh=mesh, table=table)


def shard(x, *logical):
    """Mark an activation's layout by logical axis names.

    Returns ``x``: with no rules installed, and under rules that split
    only the batch, whose rows each rank already holds alone.  Rules that
    shard another axis raise (item 9b)."""
    rules = current_rules()
    if rules is None:
        return x
    rules.data_parallel_only()
    return x
