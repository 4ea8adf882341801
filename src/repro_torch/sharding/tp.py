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
  * MoE: the experts (``models/moe.py``), and a shared expert as the
    dense FFN;
  * MLA (``models/mla.py``): ``wuq``/``wuk``/``wuv`` by columns over whole
    heads, ``wo`` by rows; the low-rank ``wdq``, ``wdkv``, ``wkr`` and
    their norms whole;
  * the Mamba-2 mixer (``models/mamba.py``): the SSD heads, ``out_proj``
    by rows; ``in_proj`` and the conv whole (``layout_descr``).

A replicated weight used inside a region on this rank's heads only (the
qk-norm scales; ``wk``/``wv`` where the KV heads do not split but the
query heads do; MLA's low-rank projections; Mamba's ``in_proj``, conv,
``A_log``, ``D``, ``dt_bias`` and gated-norm scale) goes through ``enter``
too, so its gradient, partial on each rank, is summed over the group.

The port splits attention by whole heads: ``heads`` splits over the model
axis only where the query heads divide it, and ``kv_heads`` only where the
KV heads divide it as well (``layout_descr``).  The reference's spec tests
the flattened dims instead (smollm-360m's 15 heads of 64 columns split
into 2 x 480 columns), which GSPMD may cut mid-head; the port holds such a
leaf whole.  The layout of every leaf is ``rules.spec`` of the descriptor
``layout_descr`` returns: the optimizer state, the checkpoint and the
byte counts all read it.

Mamba-2 splits by whole SSD heads too (``ssm_heads_split``).  The
reference gives ``in_proj`` the ``ffn`` name on its columns, the
concatenation [z | x | B | C | dt], which GSPMD cuts wherever a contiguous
split falls (mamba2-130m's 3,352 columns into 2 x 1,676, mid-``x``); the
port holds ``in_proj``, ``conv_w`` and ``conv_b`` whole on every rank of
the model group, and each rank reads its heads' columns of z, x and dt and
the B/C columns of its groups, which every head of a group shares.  Only
``out_proj``'s rows, head-major, split.  A column split of ``in_proj``
would mix split and replicated segments in one leaf; held whole, the leaf
goes through the global norm, Adafactor, ZeRO-1 and the checkpoint as any
replicated leaf does.

Serving (``lm.prefill``, ``prefill_chunk``, ``decode_step``) splits the
same way, and each rank holds its part of the decode cache
(``cache_layout``): the KV heads its query heads read, its SSD heads'
``ssm`` rows and its conv channels (x of its heads, B and C of their
groups); MLA's latent cache is whole, as its low-rank projections are.
The logits leave the step whole, gathered over the group from the
vocabulary split of the head.  The modality stubs split as the rest:
musicgen's [cb, V, d] tables and [cb, d, V] heads over V, and
phi-3-vision's image rows written over the whole embedding output.
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


def ssm_heads_split(cfg, m: int) -> bool:
    """Whether a Mamba-2 mixer's SSD heads split over a model axis of
    ``m``: where they divide ``m``.  With more than one group of B/C
    columns each rank's heads must take whole groups or lie in one
    group (``local_groups``), else refused."""
    s = cfg.ssm
    if s is None or m == 1:
        return False
    nheads = s.n_heads(cfg.d_model)
    if nheads % m:
        return False
    per_group, h_loc = nheads // s.n_groups, nheads // m
    if per_group % h_loc and h_loc % per_group:
        raise NotImplementedError(
            f"{cfg.name}: {h_loc} SSD heads a rank over groups of "
            f"{per_group} heads: {QUEUE_A9B}")
    return True


def local_groups(cfg, m: int, rank: int) -> tuple[int, int]:
    """[lo, hi): the B/C groups this rank's SSD heads read, where the
    heads split (``ssm_heads_split``)."""
    s = cfg.ssm
    nheads = s.n_heads(cfg.d_model)
    per_group, h_loc = nheads // s.n_groups, nheads // m
    return (rank * h_loc) // per_group, \
        ((rank + 1) * h_loc - 1) // per_group + 1


# a Mamba-2 mixer's leaves that the port holds whole over the model axis
# (the reference's ``ffn`` on their columns or channels dropped)
_MAMBA_WHOLE = ("in_proj", "conv_w", "conv_b")


def _drop(p: Param, names) -> Param:
    logical = tuple(None if n in names else n for n in p.logical)
    return p if logical == p.logical else Param(p.shape, logical, p.init,
                                                p.dtype, p.scale)


def _mamba_layout(tree, split: bool):
    """``tree`` with each Mamba-2 mixer's ``ffn`` names dropped from the
    leaves the port holds whole: ``in_proj``, ``conv_w``, ``conv_b``, and
    ``out_proj`` too where the SSD heads do not split."""
    if isinstance(tree, (list, tuple)):
        return [_mamba_layout(t, split) for t in tree]
    if not isinstance(tree, dict):
        return tree
    if "A_log" in tree and "in_proj" in tree:
        whole = _MAMBA_WHOLE + (() if split else ("out_proj",))
        return {k: _drop(v, ("ffn",)) if k in whole else v
                for k, v in tree.items()}
    return {k: _mamba_layout(v, split) for k, v in tree.items()}


def _model_rank(rules) -> int:
    names, _ = distributed.mesh_axes(rules.mesh)
    return dict(zip(names, rules.mesh.get_coordinate(),
                    strict=True))[distributed.MODEL_AXIS]


def cache_layout(cfg, descr, rules):
    """``descr`` (``lm.cache_descr``'s dense tree) at the shapes this rank
    holds: the batch dim cut over the axes the rules map ``batch`` to
    (where they divide it, as ``rules.spec`` drops them elsewhere); under
    a model axis that splits the heads, ``k``/``v`` at the KV heads this
    rank's query heads read (``local_kv``: its own where the KV heads
    split), and where the SSD heads split, ``ssm`` at this rank's heads
    and ``conv`` at its channels (``mamba.on_rank``'s x of its
    heads, B and C of their groups).  The MLA latents stay whole."""
    m = rules.model_size()
    rank = _model_rank(rules) if m > 1 else 0
    q_split, kv_split = heads_split(cfg, m)
    ssm_split = ssm_heads_split(cfg, m)

    def leaf(name: str, p: Param) -> Param:
        shape = list(p.shape)
        logical = list(p.logical)
        for i, n in enumerate(logical):
            if n == "batch":
                rows = rules.spec(("batch",), (shape[i],))[0]
                shape[i] //= rules.axis_size(_names(rows))
            if n in ("kv_heads", "ffn"):
                logical[i] = None
        if name in ("k", "v") and q_split:
            K = p.logical.index("kv_heads")
            lo, hi = ((rank * shape[K] // m, (rank + 1) * shape[K] // m)
                      if kv_split else local_kv(cfg, m, rank))
            shape[K] = hi - lo
        elif name == "ssm" and ssm_split:
            shape[-3] //= m
        elif name == "conv" and ssm_split:
            s = cfg.ssm
            g_lo, g_hi = local_groups(cfg, m, rank)
            shape[-1] = s.d_inner(cfg.d_model) // m \
                + 2 * (g_hi - g_lo) * s.d_state
        return Param(tuple(shape), tuple(logical), p.init, p.dtype, p.scale)

    def go(tree):
        if isinstance(tree, (list, tuple)):
            return [go(t) for t in tree]
        return {k: leaf(k, v) if isinstance(v, Param) else go(v)
                for k, v in tree.items()}

    return go(descr)


def layout_descr(cfg, descr, rules):
    """``descr`` with the ``heads`` / ``kv_heads`` names dropped where the
    port keeps those heads whole (``heads_split``), and a Mamba-2 mixer's
    ``ffn`` names where it keeps those leaves whole (``ssm_heads_split``),
    so that ``rules.spec`` of each leaf is the layout this rank holds."""
    m = rules.model_size()
    q, kv = heads_split(cfg, m)
    drop = {name for name, split in (("heads", q), ("kv_heads", kv))
            if not split}
    if drop:
        descr = tree_map(lambda p: _drop(p, drop), descr)
    if cfg.ssm is not None:
        descr = _mamba_layout(descr, ssm_heads_split(cfg, m))
    return descr


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
