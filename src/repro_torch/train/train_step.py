"""The training step (a port of ``repro/train/train_step.py``): loss and
gradients -> clip by the global norm -> optimizer update.

JAX jits a pure function and donates (params, opt_state); here the step
runs eagerly.  Each call takes the parameters as fresh autograd leaves,
so no gradient carries from one step into the next, and returns new
parameter and state trees.
"""
from __future__ import annotations

import torch

from repro_torch.models import lm
from repro_torch.models.params import tree_map
from repro_torch.train.optimizer import clip_by_global_norm


def make_train_step(cfg, opt, lr_fn, *, clip_norm: float = 1.0,
                    remat: bool = True, compress=None):
    """Returns ``train_step(params, opt_state, batch, step)`` ->
    (params, opt_state, metrics) with ``loss``, ``ce``, ``aux``,
    ``grad_norm`` and ``lr`` (0-dim tensors)."""
    if compress is not None:
        raise NotImplementedError("gradient compression is not ported yet: "
                                  "ROADMAP Queue A item 9 (sharding, ZeRO-1 "
                                  "and compression)")

    def train_step(params, opt_state, batch, step):
        leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss, metrics = lm.train_loss(cfg, leaves, batch, remat=remat)
        loss.backward()
        grads = tree_map(lambda p: torch.zeros_like(p) if p.grad is None
                         else p.grad, leaves)
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        lr = lr_fn(step)
        params, opt_state = opt.update(grads, opt_state,
                                       tree_map(torch.Tensor.detach, leaves),
                                       lr)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return params, opt_state, dict(metrics, grad_norm=gnorm, lr=lr)

    return train_step


@torch.no_grad()
def eval_step(cfg, params, batch):
    _, metrics = lm.train_loss(cfg, params, batch, remat=False)
    return metrics
