"""LR schedules (a port of ``repro/train/schedule.py``): linear warmup +
cosine decay, and a constant.  Each returns ``lr(step)`` as an fp32 0-dim
tensor on the CPU, which torch combines with tensors on any device."""
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
    return lambda step: torch.full((), base_lr, dtype=torch.float32)
