"""CUDA graph capture shared by the fused decode loop
(``serve/engine.py``) and the train step (``train/train_step.py``): the
port's counterpart of the reference's ``jax.jit``.

A replay runs the kernels its capture recorded, at the addresses they had
then, and no Python: every buffer the captured body reads or writes keeps
its address from one replay to the next (``Staged`` refreshes inputs in
place), and no kernel wrapper is called, so ``Graph.replay`` adds to each
wrapper's launch count what one replay launches.  The caller warms the
body up on the capture stream first (kernels loaded, their attributes
set, cuBLAS's workspace for that stream allocated outside the graph's
pool).
"""
from __future__ import annotations

import gc
from dataclasses import dataclass

import torch

from repro_torch.kernels.ops import COUNTED


class Staged:
    """A device tensor that keeps its address for its owner's life (a
    captured graph reads it there), refreshed in place from host staging
    that is pinned on the card."""

    def __init__(self, shape, dtype, device, fill=0):
        self.dev = torch.full(shape, fill, dtype=dtype, device=device)
        self.host = torch.empty(shape, dtype=dtype,
                                pin_memory=device.type == "cuda")

    def push(self, arr):
        self.host.numpy()[...] = arr
        self.dev.copy_(self.host, non_blocking=True)


@dataclass
class Graph:
    """A captured graph, the launches of each counted kernel wrapper that
    one replay makes, and the bytes its private memory pool holds (the
    allocator's reserved bytes that the capture added)."""
    graph: torch.cuda.CUDAGraph
    per_replay: dict
    pool_bytes: int

    def replay(self):
        """One replay on the current stream."""
        self.graph.replay()
        for w, k in self.per_replay.items():
            w.launches += k


def capture(body, device: torch.device, stream: torch.cuda.Stream,
            what: str) -> Graph:
    """Capture ``body()`` on ``stream`` as a CUDA graph.  A capture runs no
    kernel: the launch counts the body's wrappers advance are taken back
    and kept as the graph's per-replay counts.  A failed capture raises
    ``RuntimeError`` naming ``what``; nothing runs eagerly in its place."""
    with torch.cuda.device(device):
        torch.cuda.synchronize(device)
        # free cyclic garbage now: a collection inside the capture could
        # free device or pinned memory, which invalidates the capture
        gc.collect()
        # ``torch.cuda.graph`` empties the allocator's cache as it starts;
        # emptying it before the reading keeps that release out of the
        # pool's size (without it the size read 0 or negative)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        before = [w.launches for w in COUNTED]
        graph = torch.cuda.CUDAGraph()
        gc_on = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, stream=stream):
                body()
        except RuntimeError as e:
            raise RuntimeError(f"capturing {what} as a CUDA graph failed: "
                               f"{e}") from e
        finally:
            if gc_on:
                gc.enable()
            per_replay = {}
            for w, w0 in zip(COUNTED, before, strict=True):
                if w.launches != w0:
                    per_replay[w] = w.launches - w0
                w.launches = w0
        pool = torch.cuda.memory_reserved(device) - reserved
    return Graph(graph, per_replay, pool)
