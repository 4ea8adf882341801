"""The dry-run: lower each (arch x shape x mesh) cell by tracing one rank's
step on the ``meta`` device, compile it where it fits by capturing that
step on the card as one CUDA graph, and read the cost, memory, collective
and roofline terms (the port of ``repro/launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m \
        --shape decode_32k --seg-counts 2 [--device cuda|meta] \
        [--mesh-shape 2 4 --mesh-axes data model | --multi-pod] \
        [--json out.json] [--variant k=v ...]

One card (no ``--mesh-shape`` and no ``--multi-pod``; the sweep's
``--mesh single``): the record says ``chips: 1`` and names the card (or
``meta``) in ``mesh``.  On a mesh (``--mesh-shape`` with ``--mesh-axes``,
or ``--multi-pod``'s 2 x 16 x 16 (pod, data, model); the reference's
single pod is ``--mesh-shape 16 16 --mesh-axes data model``): this process
joins rank 0 of a fake world of the mesh's size (torch's ``fake``
process-group backend, ``distributed.fake_world``), builds the mesh and
the rules over it (``make_rules``; ``dp_only`` maps the batch over every
axis and no layer to ``model``), and traces that rank's step: its rows
of the batch, its parts of the params, the optimizer state and the cache
(``launch/inputs.py``), its heads, columns, experts and vocabulary.  The
record says ``chips`` (the mesh's size), ``mesh`` in the reference's form
(``data2xmodel4``), the traced ``rank`` and its ``coordinate``, and
``"collectives": "counted, not run"``: the fake group moves no data, so
the card stage's numbers are one rank's compute with its collectives
absent, not the mesh's step.

Lower (``lower_s``): the cell's step runs on ``meta`` tensors, which hold
no memory: ``lm.train_loss`` with its backward and the optimizer update
for ``train``, ``lm.prefill``, or ``lm.decode_step``.  It counts
- FLOPs: ``FlopCounterMode``'s products plus the hand-written kernels'
  work, which their wrappers' ``meta`` branches record
  (``kernels/work.py``; a decode call counts every cache row, having no
  ``kv_len`` values);
- bytes: each aten op's tensor inputs read once and outputs written once,
  unfused (views and bare allocations move nothing; a gather reads the
  rows it outputs and an in-place scatter writes the values it is given,
  not the whole tensor they index), plus the kernels' bytes;
- collectives: each ``c10d`` op of the rank's step, by kind, its payload
  bytes (an all-gather's output, a reduce-scatter's piece, an
  all-reduce's buffer) and its calls, which ``roofline.analyze`` weighs by
  the reference's ring factors;
- ``bytes_per_device_inputs``: the bytes of the rank's input tree;
- the peak of live tensor bytes over the trace: the inputs, plus every
  storage an op allocates, from its allocation to its release (activations
  that autograd keeps for the backward stay live until it runs).
``hlo_flops`` and ``hlo_bytes`` are the rank's counts times ``chips``, as
the reference scales ``cost_analysis()``; ``collective_bytes_per_chip`` is
the rank's weighted count.

Compile (``compile_s``), only where that peak fits ``FIT_SHARE`` of the
card's free memory: the cell (the rank's part of it on a mesh) is built on
the card at its segment counts and full width, bf16 weights from
``SEED``, and its step captured as one CUDA graph
(``train_step.GraphedStep`` for ``train``, ``graphs.capture`` for prefill
and decode) after an eager warm-up, then replayed once; its logits (a
train step's metrics) must be finite.  ``kernel_launches`` is what one
replay launches of each kernel (the capture's counts, at the rank's local
heads); ``memory_analysis`` states the allocator's peaks beside the
estimate.  ``lower_s`` of a process's first cell includes torch's one-time
load of its meta kernels (2-7 s).

Status: ``ok``; ``inapplicable`` (``shape_applicable``); or
``exceeds_device``, a result like ``inapplicable``: the estimate and the
roofline are recorded and nothing is built.  ``--device meta`` runs the
lower stage alone (the CPU tests; ``run_cell``'s ``budget_bytes`` then
stands in for the card's memory); ``--device cuda`` (the default) raises
without a card and never skips the card stage of a cell that fits.  A
capture that fails raises, and the process exits non-zero.

Variants (defaults = the reference's baseline):
    remat=dots|none        the selective remat policy (``lm.backbone``) or none
    optimizer=adamw|adafactor
    donate=0|1             1: the step updates its params, optimizer state
                           and cache in place; 0: the traced step copies
                           them first, so the peak holds both
    xent_chunk=N           logits positions a chunk of the loss
    moe_cf=F               the MoE capacity factor (the config's
                           ``moe.capacity_factor``, replaced)
    zero1=0|1              ZeRO-1: the optimizer state sliced over the data
                           axes (a mesh; one card has none to slice)
    unroll=0|1             accepted: the port's layers always run one by one
    dp_only=1              the batch over every mesh axis, no tensor
                           parallelism (the reference's table update)
    moe=ep                 the expert-parallel MoE dispatch (``apply_moe_ep``;
                           a layout it refuses fails the cell)
    seq_shard=1, kv_shard_model, sp_model   refused: sequence sharding is
                           ROADMAP Queue A item 9c part 2
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import sys
import time
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import get_config, get_shape, shape_applicable
from repro_torch.configs.analysis import _layer_kinds, model_flops, param_counts
from repro_torch import distributed
from repro_torch.configs.registry import with_segment_counts
from repro_torch.device import resolve_device
from repro_torch.graphs import capture
from repro_torch.kernels import work
from repro_torch.kernels.ops import COUNTED
from repro_torch.launch import roofline as R
from repro_torch.launch.inputs import input_specs, layout, local_rows
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models import lm
from repro_torch.models.params import init_params, tree_map
from repro_torch.sharding.rules import make_rules, use_rules
from repro_torch.sharding.tp import use_data_rows
from repro_torch.train.optimizer import get_optimizer
from repro_torch.train.schedule import warmup_cosine
from repro_torch.train.train_step import GraphedStep, make_train_step

QUEUE_A9 = "ROADMAP Queue A item 9c part 2"
# variants that shard the sequence
SEQUENCE_VARIANTS = ("seq_shard", "kv_shard_model", "sp_model")
VARIANTS = frozenset({"remat", "optimizer", "donate", "xent_chunk", "moe_cf",
                      "zero1", "unroll", "moe", "dp_only",
                      *SEQUENCE_VARIANTS})
# the share of the card's free memory a cell's estimated peak may take
FIT_SHARE = 0.9
# the card stage's weights and batch
SEED = 0
# the traced rank of a mesh
RANK = 0


def parse_variant(pairs):
    out = {"remat": "dots", "seq_shard": 0, "zero1": 1,
           "optimizer": "adamw", "donate": 1}
    for p in pairs or []:
        k, v = p.split("=", 1)
        out[k] = int(v) if v.isdigit() else v
    return out


def _tensors(tree) -> list:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return [tree]


def tree_local_bytes(tree) -> float:
    """Bytes of a tree of (meta or device) tensors: on a mesh each is the
    rank's local part already (``launch/inputs.py``), so this is the
    reference's per-device count."""
    return float(sum(t.numel() * t.element_size() for t in _tensors(tree)))


def check_variants(v: dict) -> None:
    """Refuse what the port does not lower yet, sequence sharding
    (``QUEUE_A9``), and variants the port does not know."""
    for k in SEQUENCE_VARIANTS:
        if v.get(k) not in (None, 0, "0"):
            raise NotImplementedError(f"variant {k}={v[k]} shards the "
                                      f"sequence: {QUEUE_A9}")
    unknown = sorted(set(v) - VARIANTS)
    if unknown:
        raise ValueError(f"unknown variants {unknown}; the port takes "
                         f"{sorted(VARIANTS)}")


def mesh_desc(mesh) -> str:
    """The reference's name of a mesh: ``data2xmodel4``."""
    names, sizes = distributed.mesh_axes(mesh)
    return "x".join(f"{k}{sizes[k]}" for k in names)


def cell_rules(device: str, v: dict, *, multi_pod: bool = False,
               mesh_shape=None, mesh_axes=None):
    """The rules of the cell's mesh on ``device`` (``meta`` for the lower
    stage, ``cuda`` for the card's) in the joined fake world, with the
    reference's ``dp_only`` table update."""
    if mesh_shape is not None:
        axes = tuple(mesh_axes or ("data", "model")[-len(mesh_shape):])
        mesh = make_mesh(tuple(mesh_shape), axes, device=device)
    else:
        mesh = make_production_mesh(multi_pod=multi_pod, device=device)
    rules = make_rules(mesh)
    if v.get("dp_only") not in (None, 0, "0"):
        rules.table.update(batch=tuple(distributed.mesh_axes(mesh)[0]),
                           heads=(), kv_heads=(), ffn=(), vocab=(),
                           experts=())
    return rules


@contextlib.contextmanager
def moe_dispatch(v: dict):
    """Within: ``REPRO_MOE`` is the variant's dispatch (``moe=ep``), as the
    reference sets it; put back on the way out."""
    old = os.environ.get("REPRO_MOE")
    if v.get("moe"):
        os.environ["REPRO_MOE"] = str(v["moe"])
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("REPRO_MOE", None)
        else:
            os.environ["REPRO_MOE"] = old


def cell_config(arch: str, v: dict, seg_counts=None):
    """The cell's config: the registry's, at ``seg_counts``, with the MoE
    capacity factor of ``moe_cf``."""
    cfg = get_config(arch)
    if seg_counts is not None:
        cfg = with_segment_counts(cfg, list(seg_counts))
    if v.get("moe_cf") and cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(v["moe_cf"])))
    return cfg


# ---------------------------------------------------------------------------
# lower: the meta trace
# ---------------------------------------------------------------------------
_ATEN = torch.ops.aten
# allocations that move no bytes
_BARE = {_ATEN.empty.memory_format, _ATEN.empty_strided.default,
         _ATEN.empty_like.default, _ATEN.new_empty.default,
         _ATEN.new_empty_strided.default}
# indexed reads and in-place indexed writes touch rows of their first
# argument, not all of it
_GATHERS = {_ATEN.index, _ATEN.index_select, _ATEN.gather, _ATEN.embedding}
_SCATTERS = {_ATEN.index_put_, _ATEN._index_put_impl_, _ATEN.index_copy_,
             _ATEN.scatter_, _ATEN.scatter_add_, _ATEN.index_add_}


def _size(t) -> int:
    return t.numel() * t.element_size()


def op_bytes(func, ins: list, outs: list) -> int:
    """The bytes one aten op moves, unfused: its tensor inputs read once
    and outputs written once; nothing for a view or a bare allocation; a
    gather's rows (its output) and indices, an in-place scatter's indices
    and values, read and written."""
    if func in _BARE or any(r.alias_info is not None
                            and not r.alias_info.is_write
                            for r in func._schema.returns):
        return 0
    if func.overloadpacket in _GATHERS:
        return sum(map(_size, ins[1:])) + 2 * sum(map(_size, outs))
    if func.overloadpacket in _SCATTERS:
        return 2 * sum(map(_size, ins[1:]))
    return sum(map(_size, ins)) + sum(map(_size, outs))


# the c10d ops of the port's collectives, by the reference's kind; the
# payload is the op's first tensor: the buffer, or the output
_C10D = {"allreduce_": "all-reduce", "_allgather_base_": "all-gather",
         "allgather_into_tensor_coalesced_": "all-gather",
         "_reduce_scatter_base_": "reduce-scatter",
         "alltoall_base_": "all-to-all", "broadcast_": "broadcast"}


def collective_kind(func) -> str | None:
    """The reference's kind of a ``c10d`` op, None for any other op; a
    ``c10d`` op the table does not know raises (its bytes would go
    uncounted)."""
    if func.namespace != "c10d":
        return None
    name = func.overloadpacket.__name__
    if name in ("barrier", "monitored_barrier_"):
        return None
    if name not in _C10D:
        raise NotImplementedError(f"the dry-run counts no bytes for {func}")
    return _C10D[name]


class Traffic(TorchDispatchMode):
    """Counts each op's bytes (``op_bytes``), each collective's payload
    bytes and calls by kind (``collectives``; not in ``bytes``), and the
    live storages: each storage an op allocates counts from its
    allocation until it is freed (a finalizer on the storage, which
    autograd's saved tensors keep alive), on top of ``base`` bytes of
    inputs."""

    def __init__(self, base: int):
        super().__init__()
        self.bytes = 0
        self.live = self.peak = base
        self.allocated = 0
        self.collectives: dict = {}
        self._sizes: dict = {}

    def _free(self, key):
        self.live -= self._sizes.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if func.namespace == "c10d":
            kind = collective_kind(func)
            if kind is not None:
                c = self.collectives.setdefault(kind, {"bytes": 0,
                                                       "calls": 0})
                c["bytes"] += _size(ins[0])
                c["calls"] += 1
            return out
        self.bytes += op_bytes(func, ins, outs)
        seen = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in seen or key in self._sizes:
                continue
            seen.add(key)
            self._sizes[key] = st.nbytes()
            self.live += st.nbytes()
            self.allocated += st.nbytes()
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)
        return out


def _copied(tree):
    return tree_map(lambda t: t.clone(), tree)


def train_step_fn(cfg, v: dict, rules=None, batch_size: int = 0):
    """The cell's ``make_train_step`` body (updates in place); with
    ``rules``, one rank's: the gradients summed over the ranks the batch's
    rows split over, ZeRO-1's slices (``zero1``), the model-split leaves
    in the global norm."""
    kw = {}
    if rules is not None:
        opt = get_optimizer(v["optimizer"])
        descr, parts = layout(cfg, rules)
        rows = split_rows(rules, batch_size)
        kw = dict(group=rows or data_group(rules),
                  layout=opt.layout(descr, rules, zero1=zero1(v, rules)),
                  model_parts=parts if rules.model_size() > 1 else None,
                  rows_split=rows is not None)
    return make_train_step(cfg, get_optimizer(v["optimizer"]),
                           warmup_cosine(3e-4, 100, 10_000),
                           remat=v["remat"] != "none",
                           xent_chunk=int(v.get("xent_chunk") or 512), **kw)


def split_rows(rules, n: int):
    """The group a batch of ``n`` rows is split over, None where every rank
    holds all of them (one card, or rows that do not divide)."""
    if rules is None or local_rows(rules, n) == n:
        return None
    return distributed.rows_group(rules)


def data_group(rules):
    """The data axes' group, None where they hold one rank: a sum over a
    group of one is the identity, so a (1, 1) mesh traces what one card
    does."""
    group = distributed.data_group(rules.mesh)
    return group if distributed.world(group) > 1 else None


def zero1(v: dict, rules) -> bool:
    """ZeRO-1 where the variant asks for it and the data axes have ranks
    to slice the optimizer state over."""
    return bool(v["zero1"]) and data_group(rules) is not None


def step_call(cfg, shape, v: dict, args, rules=None):
    """A thunk that runs the cell's step once on ``args`` (the
    ``input_specs`` tuple, on any device; this rank's with ``rules``,
    which it runs under) and returns its outputs."""
    donate = bool(v["donate"])
    rows = split_rows(rules, shape.global_batch)
    if shape.kind == "train":
        fn = train_step_fn(cfg, v, rules, shape.global_batch)
        params, opt_state, batch, step = args

        def body():
            p, o = (params, opt_state) if donate else (_copied(params),
                                                       _copied(opt_state))
            return fn(p, o, batch, step)
    elif shape.kind == "prefill":
        params, batch = args

        def body():
            with torch.no_grad(), use_data_rows(rows):
                return lm.prefill(cfg, params, batch)
    else:
        params, batch, cache = args

        def body():
            with torch.no_grad(), use_data_rows(rows):
                return lm.decode_step(cfg, params, batch,
                                      cache if donate else _copied(cache))

    def run():
        with use_rules(rules):
            return body()
    return run


def lower(cfg, shape, v: dict, rules=None) -> dict:
    """Trace the cell's step on ``meta`` (one rank's with ``rules``):
    counts, the inputs' bytes and the peak of live bytes."""
    t0 = time.perf_counter()
    args = input_specs(cfg, shape, rules, opt=get_optimizer(v["optimizer"]),
                       opt_name=v["optimizer"],
                       zero1=rules is None or zero1(v, rules))
    inputs = tree_local_bytes(args)
    run = step_call(cfg, shape, v, args, rules)
    with work.counting() as tally, FlopCounterMode(display=False) as fc, \
            Traffic(int(inputs)) as traffic:
        out = run()
    del out
    products = fc.get_total_flops()
    return {"lower_s": time.perf_counter() - t0,
            "bytes_per_device_inputs": inputs,
            "flops": products + tally.total_flops,
            "bytes": traffic.bytes + tally.total_bytes,
            "flops_products": products, "flops_kernels": tally.total_flops,
            "bytes_ops": traffic.bytes, "bytes_kernels": tally.total_bytes,
            "kernels": tally.as_dict(), "peak_estimate_bytes": traffic.peak,
            "allocated_bytes": int(inputs) + traffic.allocated,
            "collectives": traffic.collectives}


# ---------------------------------------------------------------------------
# compile: the card
# ---------------------------------------------------------------------------
def _card_batch(cfg, shape, gen, device, rules=None) -> dict:
    """The cell's batch on the card from ``gen`` (this rank's rows with
    ``rules``): random tokens; a decode step at the last position, so every
    cache row is live; image embeds over the first positions."""
    B, S = local_rows(rules, shape.global_batch), shape.seq_len
    cb = (cfg.num_codebooks,) if cfg.num_codebooks else ()
    if shape.kind == "decode":
        return {"tokens": torch.randint(0, cfg.vocab_size, (B, 1, *cb),
                                        generator=gen, device=device,
                                        dtype=torch.int32),
                "pos": torch.full((B,), S - 1, dtype=torch.int32,
                                  device=device)}
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S, *cb),
                                     generator=gen, device=device,
                                     dtype=torch.int32)}
    if cfg.vision_stub:
        N = cfg.num_image_tokens
        batch["image_embeds"] = torch.randn(
            (B, N, cfg.d_model), generator=gen, device=device,
            dtype=torch.float32).to(torch.bfloat16)
        batch["image_positions"] = torch.arange(
            N, dtype=torch.int32, device=device).expand(B, N).contiguous()
    return batch


def _all_finite(tree) -> bool:
    return all(bool(torch.isfinite(t.float()).all())
               for t in _tensors(tree) if t.is_floating_point())


def compile_on_card(cfg, shape, v: dict, device, rules=None) -> dict:
    """Build the cell on the card (this rank's part of it with ``rules``,
    whose fake group's collectives launch nothing), warm its step up
    eagerly, capture it as one CUDA graph and replay it once.  Raises on a
    failed capture or on outputs that are not finite."""
    torch.cuda.reset_peak_memory_stats(device)
    before = {w.__name__: w.launches for w in COUNTED}
    t0 = time.perf_counter()
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    descr, parts = layout(cfg, rules)
    params = init_params(descr, gen, device, parts)
    batch = _card_batch(cfg, shape, gen, device, rules)
    args = (params, batch)
    if shape.kind == "decode":
        args = (params, batch, lm.make_cache(cfg, shape.global_batch,
                                             shape.seq_len, device=device,
                                             rules=rules))
    torch.cuda.synchronize(device)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    if shape.kind == "train":
        opt = get_optimizer(v["optimizer"])
        opt_state = (opt.init(params) if rules is None else opt.init(
            params, opt.layout(descr, rules, zero1=zero1(v, rules))))
        fn = train_step_fn(cfg, v, rules, shape.global_batch)
        step = GraphedStep(fn, params, opt_state, group=None if rules is None
                           else distributed.data_group(rules.mesh))
        host = {k: t.cpu().numpy() for k, t in batch.items()}
        with use_rules(rules):
            step(host, 0)                   # the warm-up, eager
        torch.cuda.synchronize(device)
        compile_s = time.perf_counter() - t0
        with use_rules(rules):
            outputs = step(host, 1)         # the capture, then one replay
        per_replay = step.per_replay
        compile_s += step.stats["capture_ms"] / 1e3
    else:
        run = step_call(cfg, shape, dict(v, donate=1), args, rules)
        box: list = []

        def body():
            box[:] = [run()]

        stream = torch.cuda.Stream(device)
        current = torch.cuda.current_stream(device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            body()                          # the warm-up, eager
        current.wait_stream(stream)
        box.clear()
        graph = capture(body, device, stream, f"the {shape.kind} step")
        compile_s = time.perf_counter() - t0
        graph.replay()
        per_replay = graph.per_replay
        outputs = box[0][0]                 # the logits
    torch.cuda.synchronize(device)
    peaks = (torch.cuda.max_memory_allocated(device),
             torch.cuda.max_memory_reserved(device))
    if not _all_finite(outputs):
        raise FloatingPointError(f"{shape.kind} step on the card: outputs "
                                 "not finite")
    return {"build_s": build_s, "compile_s": compile_s,
            "kernel_launches": {w.__name__: n for w, n in per_replay.items()},
            "launches_run": {w.__name__: w.launches - before[w.__name__]
                             for w in COUNTED
                             if w.launches != before[w.__name__]},
            "max_memory_allocated": peaks[0], "max_memory_reserved": peaks[1]}


# ---------------------------------------------------------------------------
# a cell
# ---------------------------------------------------------------------------
def layers_built(cfg) -> dict:
    """Attention (GQA or MLA) and Mamba layers of the config."""
    kinds = [m for m, _ in _layer_kinds(cfg)]
    return {"attn": kinds.count("attn"), "mamba": kinds.count("mamba")}


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             variant: dict | None = None, mesh_shape=None, mesh_axes=None,
             seg_counts=None, verbose: bool = True, device: str = "cuda",
             budget_bytes: float | None = None) -> dict:
    """The cell's record: on one card without ``mesh_shape`` and
    ``multi_pod``, else one rank's of the mesh in a fake world of its size
    (module docstring).  ``budget_bytes``: what the estimated peak may
    take (default: ``FIT_SHARE`` of the card's free memory; none on
    ``meta``)."""
    v = parse_variant([])
    v.update(dict(variant or {}))
    check_variants(v)
    dev = resolve_device(device)
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"--device {device}: the dry-run lowers on meta and "
                         "compiles on cuda")
    cfg = cell_config(arch, v, seg_counts)
    shape = get_shape(shape_name)
    if not shape_applicable(cfg, shape):
        return {"arch": arch, "shape": shape_name, "status": "inapplicable",
                "note": "full-attention arch at 500k (by design; DESIGN.md)"}
    kw = dict(v=v, seg_counts=seg_counts, verbose=verbose, dev=dev,
              budget_bytes=budget_bytes)
    if mesh_shape is None and not multi_pod:
        with moe_dispatch(v):
            return _cell(arch, shape_name, cfg, shape, mesh=None, **kw)
    chips = (math.prod(mesh_shape) if mesh_shape is not None
             else 512 if multi_pod else 256)
    mesh = dict(multi_pod=multi_pod, mesh_shape=mesh_shape,
                mesh_axes=mesh_axes)
    with distributed.fake_world(chips, RANK), moe_dispatch(v):
        return _cell(arch, shape_name, cfg, shape, mesh=mesh, **kw)


def _cell(arch, shape_name, cfg, shape, *, mesh, v, seg_counts, verbose,
          dev, budget_bytes) -> dict:
    rules = None if mesh is None else cell_rules("meta", v, **mesh)
    if rules is not None:
        rules.check_supported(cfg)
        desc = mesh_desc(rules.mesh)
        chips = rules.mesh.size()
    else:
        desc = torch.cuda.get_device_name(dev) if dev.type == "cuda" \
            else "meta"
        chips = 1
    if dev.type == "cuda" and budget_bytes is None:
        budget_bytes = FIT_SHARE * torch.cuda.mem_get_info(dev)[0]
    low = lower(cfg, shape, v, rules)
    peak = low["peak_estimate_bytes"]
    fits = budget_bytes is None or peak <= budget_bytes
    card = {}
    if fits and dev.type == "cuda":
        card = compile_on_card(cfg, shape, v, dev, None if mesh is None
                               else cell_rules("cuda", v, **mesh))
    status = "ok" if fits else "exceeds_device"
    gib = 2.0 ** 30
    whose = "" if rules is None else f" of rank {RANK}"
    mem_note = (f"estimate (meta trace) {peak / gib:.2f} GiB peak of live "
                f"tensors{whose}, budget {budget_bytes / gib:.2f} GiB"
                if budget_bytes is not None else
                f"estimate (meta trace) {peak / gib:.2f} GiB peak of live "
                f"tensors{whose}, no budget")
    if card:
        mem_note += (f"; card max_memory_allocated "
                     f"{card['max_memory_allocated'] / gib:.2f} GiB, "
                     f"max_memory_reserved "
                     f"{card['max_memory_reserved'] / gib:.2f} GiB")
    elif not fits:
        mem_note += "; exceeds the device: not built"
    mf = model_flops(cfg, shape)
    roof = R.analyze(arch=arch, shape=shape_name, mesh_desc=desc,
                     chips=chips, cost={"flops": low["flops"],
                                        "bytes accessed": low["bytes"]},
                     hlo_text="", model_flops=mf,
                     bytes_per_device=low["bytes_per_device_inputs"],
                     collectives=low["collectives"])
    pc = param_counts(cfg)
    out = {
        "arch": arch, "shape": shape_name, "mesh": desc,
        "status": status, "chips": chips, "device": dev.type,
        "variant": v, "seg_counts": seg_counts,
        "num_layers": cfg.num_layers, "layers_built": layers_built(cfg),
        "params_total": pc.total, "params_active": pc.active,
        "lower_s": round(low["lower_s"], 3),
        "compile_s": round(card.get("compile_s", 0.0), 3),
        "build_s": round(card.get("build_s", 0.0), 3),
        "memory_analysis": mem_note,
        "peak_estimate_bytes": peak, "budget_bytes": budget_bytes,
        "allocated_bytes": low["allocated_bytes"],
        "max_memory_allocated": card.get("max_memory_allocated"),
        "max_memory_reserved": card.get("max_memory_reserved"),
        "bytes_per_device_inputs": low["bytes_per_device_inputs"],
        "counted": {k: low[k] for k in ("flops_products", "flops_kernels",
                                        "bytes_ops", "bytes_kernels")},
        "kernels": low["kernels"],
        "kernel_launches": card.get("kernel_launches", {}),
        "launches_run": card.get("launches_run", {}),
        "roofline": json.loads(roof.to_json()),
    }
    if rules is not None:
        out.update(rank=RANK, coordinate=list(rules.mesh.get_coordinate()),
                   collectives="counted, not run",
                   collectives_counted=low["collectives"])
    if verbose:
        print(f"[dryrun] {arch} x {shape_name} on {desc}: {status} | "
              f"lower {low['lower_s']:.1f}s compile {out['compile_s']:.1f}s "
              f"| inputs {out['bytes_per_device_inputs'] / 1e9:.2f} GB"
              f"{'' if rules is None else '/device'} | "
              f"dominant={roof.dominant} "
              f"compute={roof.compute_s * 1e3:.2f}ms "
              f"memory={roof.memory_s * 1e3:.2f}ms "
              f"collective={roof.collective_s * 1e3:.2f}ms "
              f"useful={roof.useful_ratio:.2f} "
              f"roofline_frac={roof.roofline_fraction:.3f}")
        print(f"[dryrun] memory_analysis: {mem_note}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mesh-shape", type=int, nargs="*", default=None,
                    help="a mesh of a fake world, e.g. --mesh-shape 2 4 "
                         "--mesh-axes data model (one card without it)")
    ap.add_argument("--mesh-axes", type=str, nargs="*", default=None)
    ap.add_argument("--variant", nargs="*", default=[])
    ap.add_argument("--seg-counts", type=int, nargs="*", default=None)
    ap.add_argument("--json", type=str, default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (lower, then compile on the card; never "
                         "falls back) or meta (lower only)")
    args = ap.parse_args(argv)

    res = run_cell(args.arch, args.shape, multi_pod=args.multi_pod,
                   variant=parse_variant(args.variant),
                   mesh_shape=args.mesh_shape, mesh_axes=args.mesh_axes,
                   seg_counts=args.seg_counts, device=args.device)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
    if res["status"] not in ("ok", "inapplicable", "exceeds_device"):
        sys.exit(1)


if __name__ == "__main__":
    main()
