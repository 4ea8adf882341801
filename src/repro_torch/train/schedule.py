"""LR schedules (a port of ``repro/train/schedule.py``): linear warmup +
cosine decay, and a constant.  Each returns ``lr(step)`` as an fp32 0-dim
tensor on the device of ``step``: an int (or a CPU tensor) gives one on
the CPU, a device tensor one on its device, computed there by tensor ops,
so a CUDA graph that reads the step from a device buffer recomputes the lr
on every replay (a CPU 0-dim tensor would reach the kernels as a scalar
argument, frozen at its captured value)."""
from __future__ import annotations

import math

import torch


def warmup_cosine(base_lr: float, warmup: int, total: int,
                  min_ratio: float = 0.1):
    def lr(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = base_lr * step / max(1.0, warmup)
        frac = torch.clamp((step - warmup) / max(1.0, total - warmup),
                           0.0, 1.0)
        cos = base_lr * (min_ratio + (1 - min_ratio)
                         * 0.5 * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup, warm, cos)

    return lr


def constant(base_lr: float):
    def lr(step):
        return torch.full((), base_lr, dtype=torch.float32,
                          device=torch.as_tensor(step).device)

    return lr
