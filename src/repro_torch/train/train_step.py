"""The training step (a port of ``repro/train/train_step.py``): loss and
gradients -> clip by the global norm -> optimizer update.

JAX jits a pure function and donates (params, opt_state).  Here the body
updates the params and the optimizer state in place (they are the donated
buffers) and so can be captured once as a CUDA graph and replayed once
per step: ``GraphedStep`` does that on the card, and runs the same body
eagerly on the CPU.  Each call of the body takes the parameters as fresh
autograd leaves that alias their storage, so no gradient carries from one
step into the next.

Over data-parallel ranks (``group``, a ``torch.distributed`` group: what
the reference's SPMD partitioner does on a mesh) each rank takes its rows
of the batch; every loss term is this rank's summed numerator over the
ranks' summed count (``lm.train_loss``'s ``count``), so summing the
ranks' gradients (one all-reduce a leaf) gives the global batch's, and
every rank clips by the same global norm and updates its ZeRO-1 slices
(``layout``).  Under a model axis (``sharding/tp.py``) each rank holds
its parts of the params and takes the whole gradient of each part: the
gradients are still summed over the data group only, and the global norm
sums the model-split leaves' squares over the model group
(``model_parts``).  NCCL's collectives are captured with the rest of the
step; a gloo group runs the step eagerly (``GraphedStep.mode``).
"""
from __future__ import annotations

import time

import torch

from repro_torch import distributed
from repro_torch.graphs import Staged, capture
from repro_torch.models import lm
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.sharding.tp import use_data_rows
from repro_torch.train.optimizer import clip_by_global_norm


def make_train_step(cfg, opt, lr_fn, *, clip_norm: float = 1.0,
                    remat: bool = True, compress=None,
                    xent_chunk: int = 512, group=None, layout=None,
                    model_parts=None, rows_split: bool = True):
    """Returns ``train_step(params, opt_state, batch, step)`` ->
    (params, opt_state, metrics): the same ``params`` and ``opt_state``
    trees, updated in place, and ``loss``, ``ce``, ``aux`` (``mtp`` too
    with MTP modules), ``grad_norm`` and ``lr`` as 0-dim tensors on the
    params' device.  ``step`` is an int or an int tensor; the lr is
    computed from it on the params' device; ``xent_chunk`` positions of
    logits are made at a time (``lm.chunked_xent``).  Nothing in the body
    waits for the device, so it can be captured.

    ``compress``: the reference's gradient transform, ``compress(grads,
    opt_state) -> (grads, opt_state)`` (``sharding/compression.py``),
    applied to the reduced gradients before the clip.  ``group``: the
    data-parallel ranks (the metrics are then the global batch's on every
    rank); ``layout``: this rank's ZeRO-1 parts (``opt.layout``);
    ``model_parts``: each leaf's model-axis part (``tp.param_parts``) for
    the global norm; ``rows_split``: whether the batch's rows are split
    over ``group`` (else every rank holds the whole batch), which the
    MoE's global dispatch reads (``tp.use_data_rows``)."""
    count = None
    rows = None
    if group is not None:
        def count(n):
            return distributed.all_reduce(n.detach().clone(), "sum", group)

        if rows_split and distributed.world(group) > 1:
            rows = group

    def train_step(params, opt_state, batch, step):
        device = tree_leaves(params)[0].device
        step = torch.as_tensor(step, dtype=torch.int32, device=device)
        leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
        with use_data_rows(rows):
            loss, metrics = lm.train_loss(cfg, leaves, batch, remat=remat,
                                          xent_chunk=xent_chunk, count=count)
            loss.backward()
        grads = tree_map(lambda p: torch.zeros_like(p) if p.grad is None
                         else p.grad, leaves)
        metrics = {k: v.detach() for k, v in metrics.items()}
        if group is not None:
            for g in tree_leaves(grads):
                distributed.all_reduce(g, "sum", group)
            metrics = {k: distributed.all_reduce(v.clone(), "sum", group)
                       for k, v in metrics.items()}
        if compress is not None:
            grads, opt_state = compress(grads, opt_state)
        grads, gnorm = clip_by_global_norm(grads, clip_norm, model_parts)
        lr = lr_fn(step)
        opt.update(grads, opt_state, params, lr, layout=layout)
        return params, opt_state, dict(metrics, grad_norm=gnorm, lr=lr)

    return train_step


class GraphedStep:
    """``step_fn`` (a ``make_train_step`` body) over fixed ``params`` and
    ``opt_state``, called once per step as ``run(batch, step)`` with the
    batch as numpy arrays; returns the step's metrics (0-dim tensors).

    On the CPU it calls the body.  On the card the first call runs the
    body eagerly on the capture stream (the warm-up: it builds the
    kernels, sets their attributes and allocates cuBLAS's workspace
    outside the graph's pool; it is a real step), the second captures the
    body once as a CUDA graph (``graphs.capture``), and every call after
    the first replays it: the batch is copied into static device buffers
    from pinned staging and the step into a device counter, both in
    place, and the graph updates ``params`` and ``opt_state`` in place.
    The metrics of a replay are the graph's own output tensors, which the
    next replay overwrites: read them before the next call.  A capture
    that fails raises; the body never runs eagerly in its place.

    A body that runs collectives on a gloo ``group`` cannot be captured:
    it runs eagerly on the card too (``mode``), as it does on the CPU."""

    def __init__(self, step_fn, params, opt_state, group=None):
        self.step_fn, self.params, self.opt_state = step_fn, params, \
            opt_state
        self.device = tree_leaves(params)[0].device
        eager = self.device.type == "cpu" or (
            group is not None and not distributed.capturable(group))
        self.mode = "eager" if eager else "graph"
        self._batch: dict | None = None
        self._step = None
        self._pushed = None
        self._stream = None
        self._graph = None
        self._metrics = None
        self.stats = {"captures": 0, "capture_ms": 0.0, "replays": 0,
                      "graph_pool_bytes": 0}

    def __call__(self, batch: dict, step: int) -> dict:
        if self.mode == "eager":
            return self.step_fn(self.params, self.opt_state,
                                {k: torch.from_numpy(v).to(self.device)
                                 for k, v in batch.items()}, step)[2]
        with torch.cuda.device(self.device):
            self._push(batch, step)
            if self._stream is None:
                return self._warm_up()
            if self._graph is None:
                self._capture()
            self._graph.replay()
            self.stats["replays"] += 1
            return self._metrics

    @property
    def per_replay(self) -> dict:
        """Each counted kernel wrapper's launches in one replay."""
        return {} if self._graph is None else self._graph.per_replay

    def _push(self, batch: dict, step: int):
        """Copy the batch and the step into their device buffers in place,
        on the current stream, once the last copies out of the staging
        have run."""
        if self._batch is None:
            self._batch = {k: Staged(v.shape, torch.from_numpy(v).dtype,
                                     self.device) for k, v in batch.items()}
            self._step = torch.zeros((), dtype=torch.int32,
                                     device=self.device)
            self._pushed = torch.cuda.Event()
        shapes = {k: tuple(b.host.shape) for k, b in self._batch.items()}
        got = {k: v.shape for k, v in batch.items()}
        if got != shapes:
            raise ValueError(f"the captured train step takes batches of "
                             f"{shapes}, got {got}")
        self._pushed.synchronize()
        for k, v in batch.items():
            self._batch[k].push(v)
        self._step.fill_(step)
        self._pushed.record(torch.cuda.current_stream(self.device))

    def _body(self) -> dict:
        return self.step_fn(self.params, self.opt_state,
                            {k: b.dev for k, b in self._batch.items()},
                            self._step)[2]

    def _warm_up(self) -> dict:
        """The first step, eagerly on the capture stream."""
        self._stream = torch.cuda.Stream(self.device)
        current = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(current)
        with torch.cuda.stream(self._stream):
            metrics = self._body()
        current.wait_stream(self._stream)
        return metrics

    def _capture(self):
        t0 = time.perf_counter()

        def body():
            self._metrics = self._body()

        self._graph = capture(body, self.device, self._stream,
                              "the train step")
        self.stats["captures"] += 1
        self.stats["capture_ms"] += (time.perf_counter() - t0) * 1e3
        self.stats["graph_pool_bytes"] = self._graph.pool_bytes


@torch.no_grad()
def eval_step(cfg, params, batch):
    _, metrics = lm.train_loss(cfg, params, batch, remat=False)
    return metrics
