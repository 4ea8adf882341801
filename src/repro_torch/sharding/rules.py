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
``shard(x, *logical)``.  Each rank already holds its part of every
activation (its rows of the batch; under the ``model`` axis, its heads,
FFN columns, experts or vocabulary, ``sharding/tp.py``), so ``shard``
returns ``x``; it refuses rules that shard the sequence, which is ROADMAP
Queue A item 9c.  ``check_supported`` refuses what the model axis does
not cover yet (item 9b).
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
QUEUE_A9C = "ROADMAP Queue A item 9c"
# the logical axes the model axis splits (``sharding/tp.py``)
MODEL_NAMES = ("vocab", "heads", "kv_heads", "ffn", "experts")


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
    """This rank's part of a leaf split over one group of ranks: the
    ``index``-th of ``parts`` equal slices along ``dim``, gathered back
    over ``group`` (the model axis's heads or columns; ZeRO-1's optimizer
    state and the batch's rows over the data axes)."""
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
    """A ``PartitionSpec`` over a mesh: ``model_part()`` is this rank's
    split of a leaf laid out so over the model axis, ``part()`` its split
    over the data axes of what the model part leaves (ZeRO-1 puts the
    data axes on another dim of a model-split leaf), ``local`` its slice
    of a whole leaf, ``full`` the whole leaf gathered from every rank's
    slice."""
    mesh: object
    spec: PartitionSpec

    def _split(self, data: bool) -> Part | None:
        names, sizes = mesh_axes(self.mesh)
        coord = dict(zip(names, self.mesh.get_coordinate(), strict=True))
        found = None
        for dim, entry in enumerate(self.spec):
            axes = _names(entry)
            if math.prod(sizes[a] for a in axes) == 1 and not any(
                    a in distributed.DATA_AXES for a in axes):
                continue
            on_data = [a in distributed.DATA_AXES for a in axes]
            if (any(on_data) and not all(on_data)) or any(
                    a not in distributed.DATA_AXES
                    and a != distributed.MODEL_AXIS for a in axes):
                raise NotImplementedError(
                    f"{self.spec} splits a dim over {axes}: one dim takes "
                    f"the data axes or the model axis: {QUEUE_A9B}")
            if all(on_data) != data:
                continue
            if found is not None:
                raise NotImplementedError(
                    f"{self.spec} splits two dims over the "
                    f"{'data axes' if data else 'model axis'}: {QUEUE_A9B}")
            index = 0
            for a in axes:
                index = index * sizes[a] + coord[a]
            found = Part(dim, index, math.prod(sizes[a] for a in axes),
                         distributed.data_group(self.mesh) if data
                         else distributed.model_group(self.mesh))
        return found

    def part(self) -> Part | None:
        """The split over the data axes of this rank's model part (None
        where the data axes split no dim)."""
        return self._split(data=True)

    def model_part(self) -> Part | None:
        """The split over the model axis (None for a leaf it leaves
        whole)."""
        return self._split(data=False)

    def local(self, x: torch.Tensor) -> torch.Tensor:
        for part in (self.model_part(), self.part()):
            if part is not None:
                x = part.take(x)
        return x

    def full(self, x: torch.Tensor) -> torch.Tensor:
        for part in (self.part(), self.model_part()):
            if part is not None:
                x = part.gather(x)
        return x


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

    def model_size(self) -> int:
        _, sizes = mesh_axes(self.mesh)
        return sizes.get(distributed.MODEL_AXIS, 1)

    def check_supported(self, cfg=None) -> None:
        """Raise for what the port does not shard yet: the sequence over
        any axis of more than one rank (item 9c); a logical axis other
        than the batch and ``MODEL_NAMES`` sharded, or one of those on
        other axes than the data axes or ``model`` (item 9b); and, with
        ``cfg`` and a model axis above 1, the configs whose layers it does
        not split: Mamba-2 and the Jamba hybrid, MLA (deepseek-v3-671b)
        and the modality stubs (item 9b)."""
        for name, phys in self.table.items():
            phys = tuple(phys)
            if self.axis_size(phys) == 1:
                continue
            if name in ("seq", "seq_kv"):
                raise NotImplementedError(
                    f"logical axis {name!r} sharded over {phys}: sequence "
                    f"sharding is {QUEUE_A9C}")
            if name == "batch" and all(a in distributed.DATA_AXES
                                       for a in phys):
                continue
            if name not in MODEL_NAMES or phys != (distributed.MODEL_AXIS,):
                raise NotImplementedError(
                    f"logical axis {name!r} sharded over {phys} "
                    f"({self.axis_size(phys)} ranks): {QUEUE_A9B}")
        if cfg is None or self.model_size() == 1:
            return
        what = []
        if cfg.family == "ssm" or cfg.hybrid_block:
            what.append("Mamba-2's in_proj (its ffn split cuts across the "
                        "concatenated z/x/B/C/dt columns)")
        if cfg.attention_kind == "mla":
            what.append("MLA")
        if cfg.num_codebooks or cfg.vision_stub:
            what.append("the modality stubs")
        if what:
            raise NotImplementedError(
                f"{cfg.name} over a model axis of {self.model_size()}: "
                f"{', '.join(what)} on the model axis are {QUEUE_A9B}")


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

    Returns ``x``: each rank already holds its part of the activation
    (its rows of the batch, its heads, columns or experts under the model
    axis).  Rules that shard the sequence raise (item 9c), as does what
    ``check_supported`` refuses."""
    rules = current_rules()
    if rules is None:
        return x
    rules.check_supported()
    return x
