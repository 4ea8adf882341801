"""Measurement primitives of the port's autotuner.

Two concerns live here, both motivated by Gent & Kotthoff's virtualised-
hardware reliability results (PAPERS.md): a single wall-clock sample on a
shared machine is not a measurement.

* :func:`time_fn` — warm up exactly once (the first launch included), then
  take repeated samples and reject the slow outliers (GC pauses, noisy
  neighbours) before averaging.
* :func:`retry_measurement` — the noisy-runner guard: keep the first
  measurement when it passes, otherwise re-run a bounded number of times,
  recording every repeat in the artifact so flakiness is visible instead
  of silently absorbed.

A sample is wall time per call, blocked on the call's result: CUDA
launches return before the card finishes, so every CUDA device the result
lives on is synchronized; a CPU result is complete when the call returns.
"""
from __future__ import annotations

import math
import time


def robust_mean_us(samples_us: list[float], outlier_frac: float = 0.25):
    """Mean of the samples after dropping the slowest ``outlier_frac``
    share (at least one sample is always kept).  Returns ``(mean, kept)``
    so callers can report how many samples survived rejection."""
    if not samples_us:
        raise ValueError("no samples")
    keep = max(1, math.ceil(len(samples_us) * (1.0 - outlier_frac)))
    kept = sorted(samples_us)[:keep]
    return sum(kept) / len(kept), len(kept)


def _cuda_devices(out, found: set) -> set:
    """The CUDA devices of every tensor in ``out`` (a tensor, or tuples,
    lists and dicts of them)."""
    import torch

    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            found.add(out.device)
    elif isinstance(out, (tuple, list)):
        for o in out:
            _cuda_devices(o, found)
    elif isinstance(out, dict):
        for o in out.values():
            _cuda_devices(o, found)
    return found


def block_until_ready(out):
    """Wait until ``out`` is computed: synchronize each CUDA device it
    lives on (nothing for CPU tensors or plain values).  Returns ``out``."""
    import torch

    for device in _cuda_devices(out, set()):
        torch.cuda.synchronize(device)
    return out


def time_fn(fn, *args, iters: int = 5, outlier_frac: float = 0.25):
    """Time ``fn(*args)`` in microseconds: one warmup call (first launch,
    allocator and cache fill — blocked on, never re-computed), then
    ``iters`` blocked samples, outlier-rejected via :func:`robust_mean_us`.

    Returns ``(mean_us, n_kept, samples_us)``.  Works on any callable
    returning tensors (or tuples of them) or plain Python values."""
    block_until_ready(fn(*args))         # the one warmup call
    samples = []
    for _ in range(iters):
        t0 = time.perf_counter()
        block_until_ready(fn(*args))
        samples.append((time.perf_counter() - t0) * 1e6)
    mean, kept = robust_mean_us(samples, outlier_frac)
    return mean, kept, samples


def retry_measurement(out: dict, label: str, first, measure, accept, best,
                      retries: int = 1):
    """Noisy-runner guard shared by every smoke-floor measurement.

    Keeps ``first`` when ``accept`` passes; otherwise re-runs ``measure``
    up to ``retries`` times, folding each repeat in with ``best`` (``max``
    for scalars, an argmax lambda for records) and appending it under
    ``out["retries"][label]`` — the artifact shows exactly how flaky the
    runner was instead of silently absorbing it."""
    result = first
    for _ in range(retries):
        if accept(result):
            break
        again = measure()
        out.setdefault("retries", {}).setdefault(label, []).append(again)
        result = best(result, again)
    return result


__all__ = ["robust_mean_us", "time_fn", "retry_measurement",
           "block_until_ready"]
