"""Process groups and the collectives of data- and model-parallel
training.

The reference trains on a mesh through JAX's SPMD partitioner: it shards
the batch over the data axes, the weights over the ``model`` axis, and XLA
inserts the collectives.  The port runs one process a rank under
``torch.distributed`` and makes those collectives itself
(``train/train_step.py``, ``train/optimizer.py``,
``checkpoint/checkpointer.py``, ``sharding/compression.py``, and the
model's tensor-parallel regions through ``copy_to_model``,
``reduce_from_model`` and ``gather_rows``).

The backend follows a rule, never a flag, and never changes on a failure:
NCCL when every local rank has a card of its own; gloo when the ranks
share a card (NCCL refuses two ranks on one device) or run on the CPU.
Gloo takes only ``broadcast`` and ``all_reduce`` for CUDA tensors, so on a
gloo group ``all_gather`` and ``reduce_scatter`` of CUDA tensors go
through host copies; nothing falls back, and a collective that fails
raises.  On a gloo group of one rank (a data axis of 1 under ranks that
share a card) a collective is the identity and runs none: gloo would
carry a CUDA tensor through the host and back for it.  A gloo group
cannot be captured in a CUDA graph (``capturable``).

Nothing leaves the machine: the group meets through ``torchrun``'s
environment on this host (``MASTER_ADDR`` a loopback address), a
``file://`` store, or ``tcp://localhost:<port>``.  Importing this module
starts nothing.

The dry-run on a mesh (``launch/dryrun.py``) alone joins a fake world
(``init_fake``): one process is one rank of a world of N through torch's
``fake`` backend, whose collectives move no data and launch nothing, so
that rank's step can be traced on ``meta`` and captured on the card with
its collectives counted, not run.  The output of a fake all-gather or
reduce-scatter is zeros (the rank's own step stays finite); an all-reduce
leaves the rank's own values.  Training and serving refuse a fake world
(``refuse_fake``).
"""
from __future__ import annotations

import contextlib
import math
import os
import tempfile

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

LOOPBACK = ("localhost", "127.0.0.1", "::1")
DATA_AXES = ("pod", "data")
MODEL_AXIS = "model"
FAKE = "fake"

_state: dict = {}
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def backend_for(device: torch.device, local_world_size: int) -> str:
    """NCCL when each of the ``local_world_size`` ranks of this host has a
    card of its own, else gloo (ranks sharing a card, or on the CPU)."""
    if device.type == "cpu":
        return "gloo"
    if device.type != "cuda":
        raise ValueError(f"no process-group backend for device {device}")
    return "nccl" if local_world_size <= torch.cuda.device_count() else "gloo"


def _check_local(init_method: str) -> None:
    if init_method.startswith("file://"):
        return
    if init_method == "env://":
        host = os.environ.get("MASTER_ADDR", "localhost")
    elif init_method.startswith("tcp://"):
        host = init_method[len("tcp://"):].rsplit(":", 1)[0].strip("[]")
    else:
        raise ValueError(f"init_method {init_method!r}: use env://, "
                         "file:// or tcp://localhost:<port>")
    if host not in LOOPBACK:
        raise ValueError(f"the process group must meet on this host, not "
                         f"{host!r}")


def init(device: str | torch.device = "cuda", *,
         init_method: str | None = None, rank: int | None = None,
         world_size: int | None = None) -> torch.device:
    """Join the default process group (once a process) and return this
    rank's device: ``cuda:<LOCAL_RANK % cards>`` on the card.  Rank and
    world size come from the arguments or ``torchrun``'s environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``); a
    process alone, outside ``torchrun``, is a world of one on a fresh
    ``file://`` store."""
    if dist.is_initialized():
        return resolve_device(device) if is_fake() else _state["device"]
    env = os.environ
    rank = int(env.get("RANK", 0)) if rank is None else rank
    world_size = (int(env.get("WORLD_SIZE", 1)) if world_size is None
                  else world_size)
    local_rank = int(env.get("LOCAL_RANK", rank))
    local_world = int(env.get("LOCAL_WORLD_SIZE", world_size))
    dev = resolve_device(device)
    backend = backend_for(dev, local_world)
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    store = None
    if init_method is None:
        if "MASTER_ADDR" in env:
            init_method = "env://"
        elif world_size == 1:
            fd, store = tempfile.mkstemp(prefix="repro_torch_pg_")
            os.close(fd)
            init_method = f"file://{store}"
        else:
            raise ValueError(f"a world of {world_size} ranks needs an "
                             "init_method (file:// or tcp://localhost) or "
                             "torchrun's environment")
    _check_local(init_method)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)
    _state.update(device=dev, backend=backend, store=store, groups={})
    return dev


def init_fake(world_size: int, rank: int = 0) -> None:
    """Join rank ``rank`` of a world of ``world_size`` ranks through
    torch's ``fake`` backend (the dry-run's alone; module docstring).  The
    meshes over it are built on ``meta`` or ``cuda`` (``launch/mesh.py``)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if is_fake() and dist.get_world_size() == world_size \
                and dist.get_rank() == rank:
            return
        raise RuntimeError(f"a process group is already joined "
                           f"({backend()}, {dist.get_world_size()} ranks)")
    dist.init_process_group(FAKE, rank=rank, world_size=world_size,
                            store=FakeStore())
    _state.update(device=None, backend=FAKE, store=None, groups={})


@contextlib.contextmanager
def fake_world(world_size: int, rank: int = 0):
    """Within: this process is rank ``rank`` of a fake world of
    ``world_size`` (``init_fake``), left again on the way out."""
    init_fake(world_size, rank)
    try:
        yield
    finally:
        shutdown()


def is_fake(group=None) -> bool:
    """Whether this process has joined a fake world (``init_fake``)."""
    return dist.is_initialized() and backend(group) == FAKE


def refuse_fake(what: str) -> None:
    """Raise where ``what`` (training, serving) finds a fake world: its
    collectives move no data, so only the dry-run may use one."""
    if is_fake():
        raise RuntimeError(f"{what} in a fake process group: its "
                           "collectives move no data (the dry-run's alone)")


def shutdown() -> None:
    """Leave the default process group and drop the groups made here.
    Every rank calls it: a barrier first, so no rank tears its group down
    while another still runs a collective on it."""
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
    store = _state.get("store")
    if store and os.path.exists(store):
        os.unlink(store)
    _state.clear()


def backend(group=None) -> str:
    return dist.get_backend(group)


def capturable(group=None) -> bool:
    """Whether a CUDA graph can capture this group's collectives: NCCL's
    can, gloo's run on the host; a fake group's launch nothing."""
    return backend(group) in ("nccl", FAKE)


def mesh_axes(mesh) -> tuple[tuple[str, ...], dict]:
    """(axis names, {name: size}) of a ``DeviceMesh`` or of any object with
    ``axis_names`` and a ``shape`` mapping (the reference's meshes and the
    tests' stand-ins)."""
    names = getattr(mesh, "axis_names", None)
    if names is None:
        names = tuple(mesh.mesh_dim_names)
        return names, dict(zip(names, mesh.shape, strict=True))
    return tuple(names), dict(mesh.shape)


def _axes_group(mesh, axes: tuple[str, ...]):
    """The group of ranks that share this rank's coordinates on every axis
    of ``mesh`` but ``axes``, in row-major order of ``axes``.  Every rank
    makes every such group, in one order, the first time a mesh asks."""
    key = (id(mesh), axes)
    groups = _state.setdefault("groups", {})
    if key not in groups:
        names, _ = mesh_axes(mesh)
        inner = [i for i, n in enumerate(names) if n in axes]
        rest = [i for i in range(len(names)) if i not in inner]
        size = math.prod(mesh.mesh.shape[i] for i in inner)
        rows = mesh.mesh.permute(*rest, *inner).reshape(-1, size).tolist()
        me = dist.get_rank()
        if len(rows) == 1 and rows[0] == list(range(dist.get_world_size())):
            groups[key] = (mesh, dist.group.WORLD)
        else:
            made = [dist.new_group(r) for r in rows]
            groups[key] = (mesh, next(g for r, g in zip(rows, made,
                                                       strict=True)
                                      if me in r))
    return groups[key][1]


def data_group(mesh):
    """The ranks that share this rank's coordinates on every axis but the
    data axes (``pod``, ``data``): the ranks that split the batch, sum the
    gradients and slice the optimizer state."""
    return _axes_group(mesh, DATA_AXES)


def model_group(mesh):
    """The ranks that share this rank's coordinates on every axis but
    ``model``: the ranks that split a layer's heads, FFN columns, experts
    and vocabulary between them."""
    return _axes_group(mesh, (MODEL_AXIS,))


def world(group=None) -> int:
    return dist.get_world_size(group)


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def _alone(group) -> bool:
    """A gloo group of one rank, whose collectives are the identity (an
    NCCL group of one keeps its collectives, which a graph captures)."""
    return world(group) == 1 and backend(group) == "gloo"


def rows_group(rules):
    """The ranks the batch's rows are split over: those that differ from
    this rank only on the axes the rules map ``batch`` to (the data axes;
    every axis under ``dp_only``); None where they are not split."""
    axes = tuple(rules.table.get("batch", ()))
    if rules.axis_size(axes) == 1:
        return None
    return _axes_group(rules.mesh, axes)


def _output(like: torch.Tensor, shape: tuple, group) -> torch.Tensor:
    """A collective's output buffer: zeros on a fake group, which writes
    none (module docstring)."""
    if backend(group) == FAKE:
        return like.new_zeros(shape)
    return like.new_empty(shape)


def all_reduce(x: torch.Tensor, op: str = "sum", group=None) -> torch.Tensor:
    """``x`` reduced over ``group`` in place (``op`` "sum" or "max")."""
    if not _alone(group):
        dist.all_reduce(x, op=_OPS[op], group=group)
    return x


def broadcast(x: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """``x`` overwritten in place by rank ``src``'s."""
    if not _alone(group):
        dist.broadcast(x, src=src, group=group)
    return x


def _host_copies(x: torch.Tensor, group) -> bool:
    return x.device.type == "cuda" and backend(group) == "gloo"


def all_gather(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim``, in rank order."""
    if _alone(group):
        return x.clone()
    n = world(group)
    lead = x.movedim(dim, 0).contiguous()
    if _host_copies(x, group):
        lead = lead.cpu()
    out = _output(lead, (n * lead.shape[0], *lead.shape[1:]), group)
    _all_gather(out, lead, group=group)
    return out.to(x.device).movedim(0, dim)


def reduce_scatter(x: torch.Tensor, dim: int, group=None,
                   op: str = "sum") -> torch.Tensor:
    """``x`` reduced over the ranks, and this rank's part of it: the
    ``rank``-th of ``world`` equal slices along ``dim``."""
    n = world(group)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"into {n}")
    if _alone(group):
        return x.clone()
    lead = x.movedim(dim, 0).contiguous()
    if _host_copies(x, group):
        lead = lead.cpu()
    out = _output(lead, (lead.shape[0] // n, *lead.shape[1:]), group)
    _reduce_scatter(out, lead, op=_OPS[op], group=group)
    return out.to(x.device).movedim(0, dim)


# ---------------------------------------------------------------------------
# differentiable collectives of the model axis (Megatron's f and g)
# ---------------------------------------------------------------------------
class _CopyToModel(torch.autograd.Function):
    """f: the identity forward, the gradient summed over the group
    backward (the input of a tensor-parallel region, whose ranks each
    return a part of its gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return all_reduce(dy.contiguous().clone(), "sum", ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """g: the ranks' partial results summed forward, the gradient passed
    through backward (every rank holds the whole, replicated gradient).
    ``torch.distributed.nn``'s all-reduce sums the gradient again, which
    multiplies a replicated gradient by the group's size."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), "sum", group)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _GatherRows(torch.autograd.Function):
    """The ranks' rows concatenated along ``dim`` forward, in rank order;
    backward, the gradient summed over the ranks and cut to this rank's
    rows (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, dy):
        return reduce_scatter(dy, ctx.dim, ctx.group), None, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromModel.apply(x, group)


def gather_rows(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return _GatherRows.apply(x, dim, group)
