"""Seeded synthetic request traces for the serving benchmark.

A trace is a list of ``TimedRequest`` with Poisson arrivals and mixed
prompt/output lengths — the "millions of users" half of the north star
reduced to a reproducible workload: same seed, same trace, so host-sync
and fused engines replay identical request streams.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class TimedRequest:
    arrival_s: float
    prompt: np.ndarray          # [S] (or [S, cb]) int32
    max_new_tokens: int
    temperature: float = 0.0
    top_k: int = 0


def poisson_trace(*, n_requests: int, rate_per_s: float, vocab_size: int,
                  seed: int = 0, prompt_lens: tuple[int, int] = (4, 64),
                  output_lens: tuple[int, int] = (4, 32), codebooks: int = 0,
                  temperature: float = 0.0) -> list[TimedRequest]:
    """Poisson arrivals at ``rate_per_s`` with uniform prompt/output lengths
    (inclusive ranges).  Fully determined by ``seed``."""
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / rate_per_s, n_requests))
    out = []
    for i in range(n_requests):
        plen = int(rng.integers(prompt_lens[0], prompt_lens[1] + 1))
        shape = (plen, codebooks) if codebooks else plen
        prompt = rng.integers(0, vocab_size, shape).astype(np.int32)
        out.append(TimedRequest(
            arrival_s=float(arrivals[i]), prompt=prompt,
            max_new_tokens=int(rng.integers(output_lens[0],
                                            output_lens[1] + 1)),
            temperature=temperature))
    return out
