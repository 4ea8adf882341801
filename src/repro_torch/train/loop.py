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
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.data.synthetic import DataConfig, SyntheticIterator
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.models.params import init_params
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
    # injected fault for tests: raise after N steps (simulates preemption)
    fail_after_step: int | None = None


def run_training(cfg, data_cfg: DataConfig, job: TrainJob, *,
                 device: str | torch.device = "cuda", rules=None, log=print):
    """Returns (history, final_step, params).  Restores from job.ckpt_dir if
    it holds a checkpoint; otherwise initialises from ``job.seed``.  The
    returned params are the buffers the steps updated in place."""
    if rules is not None:
        raise NotImplementedError("sharded training is not ported yet: "
                                  "ROADMAP Queue A item 9 (sharding, ZeRO-1 "
                                  "and compression)")
    dev = resolve_device(device)
    descr = lm.make_lm(cfg)
    opt = get_optimizer(job.optimizer)
    lr_fn = warmup_cosine(job.base_lr, job.warmup, job.total_steps)
    step_fn = make_train_step(cfg, opt, lr_fn, clip_norm=job.clip_norm,
                              remat=job.remat)

    it = SyntheticIterator(data_cfg)
    start_step = 0
    if job.ckpt_dir and ckpt.available_steps(job.ckpt_dir):
        like_p = init_params(descr, None, "meta")
        like = {"params": like_p, "opt": opt.init(like_p)}
        state, start_step, meta = ckpt.restore(job.ckpt_dir, like, device=dev)
        params, opt_state = state["params"], state["opt"]
        it.restore(meta.get("data_state", start_step))
        log(f"[train] restored checkpoint at step {start_step}")
    else:
        gen = torch.Generator(device=dev)
        gen.manual_seed(job.seed)
        params = init_params(descr, gen, dev)
        opt_state = opt.init(params)

    run_step = GraphedStep(step_fn, params, opt_state)
    history = []
    pending_writer = None
    t0 = time.time()
    for step in range(start_step, job.total_steps):
        metrics = run_step(next(it), step)
        if job.fail_after_step is not None and step >= job.fail_after_step:
            raise RuntimeError(f"injected failure at step {step}")
        if (step + 1) % job.log_every == 0 or step == start_step:
            m = {k: float(v) for k, v in metrics.items()}
            history.append(dict(m, step=step))
            log(f"[train] step {step} loss={m['loss']:.4f} "
                f"lr={m['lr']:.2e} ({time.time() - t0:.1f}s)")
        if job.ckpt_dir and (step + 1) % job.ckpt_every == 0:
            # ``save`` copies every leaf to the host before it returns, so
            # the next step's in-place update cannot reach the snapshot
            if pending_writer is not None:
                pending_writer.join()
            pending_writer = ckpt.save(
                job.ckpt_dir, step + 1, {"params": params, "opt": opt_state},
                metadata={"arch": cfg.name, "data_state": it.state()},
                async_write=job.async_ckpt)
            ckpt.prune(job.ckpt_dir, job.keep)
    if pending_writer is not None:
        pending_writer.join()
    if job.ckpt_dir:
        ckpt.save(job.ckpt_dir, job.total_steps,
                  {"params": params, "opt": opt_state},
                  metadata={"arch": cfg.name, "data_state": it.state()})
    return history, job.total_steps, params
