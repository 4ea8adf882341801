"""Training loop with checkpoint/restart fault tolerance (a port of
``repro/train/loop.py``).

Written so that an ExpoCloud worker can run it as a task: if the process
(or the node) dies, calling ``run_training`` again with the same arguments
resumes from the latest checkpoint in ``job.ckpt_dir``, parameters,
optimizer state and the data iterator's position alike.

On the card the step is one CUDA graph, captured once per run (after the
run's first step, which runs eagerly and warms it up) and replayed once
per step, as the reference runs one jitted ``train_step`` with donated
(params, opt_state): the params and the optimizer state are fixed device
tensors that each replay updates in place (``train_step.GraphedStep``).
On the CPU the same body runs eagerly.  The host's work per step is the
next synthetic batch, its copy into the graph's input buffers, and, on
log steps only, the read of the metrics.

With ``rules`` (``sharding/rules.py``, over a ``launch/mesh.py`` mesh)
the run is one rank of data- and model-parallel training: every rank
draws the params from ``job.seed`` whole and keeps its model-axis part of
each leaf (``sharding/tp.py``; the ranks of a data group are checked to
hold the same bytes by one broadcast), takes its rows of each global batch
(every row where the batch does not divide over the data axes, as the
reference's spec drops the axis), sums the gradients over the data group,
and keeps its ZeRO-1 slices of the optimizer state
(``opt_state_shardings`` of ``tp.layout_descr``).  MoE layers route over
the global token set (``models/moe.py``).  A checkpoint holds whole
leaves, gathered over both axes and written by rank 0, so a run restores
onto any mesh.  Sequence sharding is ROADMAP Queue A item 9c; the configs
``ShardingRules.check_supported`` refuses on a model axis are item 9b.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from repro_torch import distributed
from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.data.synthetic import DataConfig, SyntheticIterator
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.models.params import init_params, tree_leaves
from repro_torch.sharding import tp
from repro_torch.sharding.rules import NamedSharding, use_rules
from repro_torch.sharding.zero import opt_state_shardings
from repro_torch.train.optimizer import get_optimizer
from repro_torch.train.schedule import warmup_cosine
from repro_torch.train.train_step import GraphedStep, make_train_step


@dataclass
class TrainJob:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str | None = None
    log_every: int = 10
    keep: int = 3
    base_lr: float = 3e-4
    warmup: int = 20
    clip_norm: float = 1.0
    optimizer: str = "adamw"
    remat: bool = True
    seed: int = 0
    async_ckpt: bool = True
    zero1: bool = True
    # injected fault for tests: raise after N steps (simulates preemption)
    fail_after_step: int | None = None


def run_training(cfg, data_cfg: DataConfig, job: TrainJob, *,
                 device: str | torch.device = "cuda", rules=None, log=print):
    """Returns (history, final_step, params).  Restores from job.ckpt_dir if
    it holds a checkpoint; otherwise initialises from ``job.seed``.  The
    returned params are the buffers the steps updated in place.  With
    ``rules`` this process is one rank of a mesh (module docstring) on
    its own device (``distributed.init``); only rank 0 logs."""
    descr = lm.make_lm(cfg)
    opt = get_optimizer(job.optimizer)
    lr_fn = warmup_cosine(job.base_lr, job.warmup, job.total_steps)
    group = layout = shardings = rows = parts = None
    if rules is None:
        dev = resolve_device(device)
    else:
        rules.check_supported(cfg)
        dev = distributed.init(device)
        if dev.type != resolve_device(device).type:
            raise ValueError(f"this rank's process group runs on {dev}, "
                             f"not {device}")
        group = distributed.data_group(rules.mesh)
        descr = tp.layout_descr(cfg, descr, rules)
        layout = opt.layout(descr, rules, zero1=job.zero1)
        shardings = {"params": tp.param_shardings(cfg, descr, rules),
                     "opt": opt_state_shardings(job.optimizer, descr, rules,
                                                zero1=job.zero1)}
        parts = tp.param_parts(cfg, descr, rules)
        rows = NamedSharding(rules.mesh, rules.spec(
            ("batch",), (data_cfg.batch_size,))).part()
        if torch.distributed.get_rank() != 0:
            log = _quiet
    step_fn = make_train_step(cfg, opt, lr_fn, clip_norm=job.clip_norm,
                              remat=job.remat, group=group, layout=layout,
                              model_parts=parts,
                              rows_split=rows is not None and rows.parts > 1)

    it = SyntheticIterator(data_cfg)
    start_step = 0
    if job.ckpt_dir and ckpt.available_steps(job.ckpt_dir):
        like_p = init_params(descr, None, "meta", parts)
        like = {"params": like_p, "opt": opt.init(like_p, layout)}
        state, start_step, meta = ckpt.restore(
            job.ckpt_dir, like, device=dev, shardings=shardings)
        params, opt_state = state["params"], state["opt"]
        it.restore(meta.get("data_state", start_step))
        log(f"[train] restored checkpoint at step {start_step}")
    else:
        gen = torch.Generator(device=dev)
        gen.manual_seed(job.seed)
        params = init_params(descr, gen, dev, parts)
        if group is not None:
            _check_replicas(params, group)
        opt_state = opt.init(params, layout)

    run_step = GraphedStep(step_fn, params, opt_state, group=group)
    history = []
    pending_writer = None
    t0 = time.time()
    try:
        for step in range(start_step, job.total_steps):
            batch = next(it)
            if rows is not None:
                batch = {k: rows.take(v) for k, v in batch.items()}
            with use_rules(rules):
                metrics = run_step(batch, step)
            if job.fail_after_step is not None and step >= job.fail_after_step:
                raise RuntimeError(f"injected failure at step {step}")
            if (step + 1) % job.log_every == 0 or step == start_step:
                m = {k: float(v) for k, v in metrics.items()}
                history.append(dict(m, step=step))
                log(f"[train] step {step} loss={m['loss']:.4f} "
                    f"lr={m['lr']:.2e} ({time.time() - t0:.1f}s)")
            if job.ckpt_dir and (step + 1) % job.ckpt_every == 0:
                # ``save`` copies every leaf to the host before it returns,
                # so the next step's in-place update cannot reach the
                # snapshot
                if pending_writer is not None:
                    pending_writer.join()
                pending_writer = ckpt.save(
                    job.ckpt_dir, step + 1,
                    {"params": params, "opt": opt_state},
                    metadata={"arch": cfg.name, "data_state": it.state()},
                    async_write=job.async_ckpt, shardings=shardings)
                if ckpt.is_writer():
                    ckpt.prune(job.ckpt_dir, job.keep)
    finally:
        # a failure, too, waits for the checkpoint write it follows, so
        # that the step it checkpointed is whole on disk when the run is
        # restarted (an injected failure right after a checkpoint then
        # resumes from it; a rerun in this process never races the old
        # writer for its temporary directory)
        if pending_writer is not None:
            pending_writer.join()
    if job.ckpt_dir:
        ckpt.save(job.ckpt_dir, job.total_steps,
                  {"params": params, "opt": opt_state},
                  metadata={"arch": cfg.name, "data_state": it.state()},
                  shardings=shardings)
    return history, job.total_steps, params


def _quiet(*args, **kwargs):
    pass


def _check_replicas(params, group) -> None:
    """Raise unless every rank of the data ``group`` built the same params
    (one broadcast of its first rank's bytes)."""
    mine = torch.cat([p.detach().reshape(-1).view(torch.uint8)
                      for p in tree_leaves(params)])
    first = torch.distributed.get_global_rank(group, 0)
    theirs = distributed.broadcast(mine.clone(), first, group)
    if not torch.equal(mine, theirs):
        raise RuntimeError("the params built from job.seed differ from "
                           f"rank {first}'s on this rank")
