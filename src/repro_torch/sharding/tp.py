"""The ``model`` mesh axis: Megatron-style tensor parallelism and the
expert-parallel MoE (what the reference's SPMD partitioner makes of the
``model`` entries of ``ShardingRules``' table).

Each rank of a model group holds its part of every leaf the rules split
over ``model`` and the whole of every other leaf.  A tensor-parallel
region starts with ``enter`` (the identity forward; backward, the
gradient summed over the group: each rank returns the part of it that its
heads or columns make) and ends with ``leave`` (the ranks' partial
results summed forward; backward, the replicated gradient passed
through), so every activation between regions is whole and the same on
every rank of the group:

  * attention: ``wq``/``wk``/``wv`` split by columns over whole heads,
    ``wo`` by rows, ``leave`` after ``wo``;
  * the dense FFN: ``wi``/``wg`` by columns, ``wo`` by rows;
  * the vocabulary: the embedding's rows (a masked local lookup, then
    ``leave``), the head's columns, and the cross-entropy over the split
    logits (``models/lm.py``);
  * MoE: the experts (``models/moe.py``).

A replicated weight used inside a region on this rank's heads only (the
qk-norm scales; ``wk``/``wv`` where the KV heads do not split but the
query heads do) goes through ``enter`` too, so its gradient, partial on
each rank, is summed over the group.

The port splits attention by whole heads: ``heads`` splits over the model
axis only where the query heads divide it, and ``kv_heads`` only where the
KV heads divide it as well (``layout_descr``).  The reference's spec tests
the flattened dims instead (smollm-360m's 15 heads of 64 columns split
into 2 x 480 columns), which GSPMD may cut mid-head; the port holds such a
leaf whole.  The layout of every leaf is ``rules.spec`` of the descriptor
``layout_descr`` returns: the optimizer state, the checkpoint and the
byte counts all read it.
"""
from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass

from repro_torch import distributed
from repro_torch.models.params import Param, tree_map
from repro_torch.sharding.rules import (QUEUE_A9B, NamedSharding,
                                        PartitionSpec, _names, current_rules)


@dataclass(frozen=True)
class ModelAxis:
    """This rank's place on the model axis of the installed rules."""
    size: int
    rank: int
    group: object
    table: dict

    def splits(self, name: str, n: int) -> bool:
        """Whether a dim of ``n`` named ``name`` splits over the axis."""
        return (distributed.MODEL_AXIS in tuple(self.table.get(name, ()))
                and n % self.size == 0)

    def enter(self, x):
        return distributed.copy_to_model(x, self.group)

    def leave(self, x):
        return distributed.reduce_from_model(x, self.group)


def model_axis() -> ModelAxis | None:
    """The installed rules' model axis; None without rules or where the
    axis has one rank (every leaf is then whole)."""
    rules = current_rules()
    if rules is None:
        return None
    m = rules.model_size()
    if m == 1:
        return None
    names, _ = distributed.mesh_axes(rules.mesh)
    coord = dict(zip(names, rules.mesh.get_coordinate(), strict=True))
    return ModelAxis(m, coord[distributed.MODEL_AXIS],
                     distributed.model_group(rules.mesh), rules.table)


def heads_split(cfg, m: int) -> tuple[bool, bool]:
    """(query heads split, KV heads split) over a model axis of ``m``.
    Query heads split where they divide ``m``, KV heads where they do as
    well; where only the query heads split, each rank's query heads must
    read a contiguous run of KV heads in the flash kernel's order (local
    query head j reads local KV head j // G'), else refused."""
    H, K = cfg.num_heads, cfg.num_kv_heads
    if m == 1 or H % m:
        return False, False
    if K % m == 0:
        return True, True
    G, h_loc = H // K, H // m
    if G % h_loc and h_loc % G:
        raise NotImplementedError(
            f"{cfg.name}: {h_loc} query heads a rank over groups of {G} "
            f"on {K} replicated KV heads: {QUEUE_A9B}")
    return True, False


def local_kv(cfg, m: int, rank: int) -> tuple[int, int]:
    """[lo, hi): the KV heads this rank's query heads read, where only the
    query heads split."""
    G, h_loc = cfg.num_heads // cfg.num_kv_heads, cfg.num_heads // m
    return (rank * h_loc) // G, ((rank + 1) * h_loc - 1) // G + 1


def layout_descr(cfg, descr, rules):
    """``descr`` with the ``heads`` / ``kv_heads`` names dropped where the
    port keeps those heads whole (``heads_split``), so that ``rules.spec``
    of each leaf is the layout this rank holds."""
    q, kv = heads_split(cfg, rules.model_size())
    drop = {name for name, split in (("heads", q), ("kv_heads", kv))
            if not split}
    if not drop:
        return descr

    def go(p: Param) -> Param:
        logical = tuple(None if n in drop else n for n in p.logical)
        return p if logical == p.logical else Param(
            p.shape, logical, p.init, p.dtype, p.scale)

    return tree_map(go, descr)


_rows: contextvars.ContextVar = contextvars.ContextVar("data_rows",
                                                       default=None)


@contextlib.contextmanager
def use_data_rows(group):
    """Within: the batch's rows are split over ``group`` (the data group;
    None where every rank holds the whole batch), which the MoE's global
    dispatch gathers over (``models/moe.py``)."""
    tok = _rows.set(group)
    try:
        yield
    finally:
        _rows.reset(tok)


def data_rows():
    """The group the batch's rows are split over, or None."""
    return _rows.get()


def param_shardings(cfg, descr, rules):
    """Each leaf's ``NamedSharding`` as this rank holds the params: the
    model axis's split of ``layout_descr``'s spec (the params are whole
    over the data axes)."""
    def go(p: Param):
        spec = rules.spec(p.logical, p.shape)
        spec = PartitionSpec(*(e if distributed.MODEL_AXIS in _names(e)
                               else None for e in spec))
        return NamedSharding(rules.mesh, spec)

    return tree_map(go, layout_descr(cfg, descr, rules))


def param_parts(cfg, descr, rules):
    """This rank's model-axis ``Part`` of each leaf (None for a whole
    leaf): the ``parts`` of ``init_params``."""
    return tree_map(NamedSharding.model_part,
                    param_shardings(cfg, descr, rules))
