"""Beyond-paper distributed-optimization trick: int8 error-feedback
gradient all-reduce (a port of ``repro/sharding/compression.py``).

For a slow link between data-parallel ranks the gradient reduction can be
compressed: quantise grads to int8 with a per-tensor scale, all-reduce the
int8 payload (4x fewer bytes), dequantise, and keep the quantisation
residual locally (error feedback, Karimireddy et al. 2019) so compression
noise becomes a *delayed* rather than *lost* signal.

Two pieces, with the reference's arithmetic op for op (torch's ``round``
rounds half to even, as ``jnp.round`` does):
  * ``make_error_feedback_compress`` -- per-tensor fake-quant + error
    feedback, a gradient transform;
  * ``allreduce_int8`` -- the explicit compressed all-reduce of one tensor
    over a process group (``torch.distributed``, where the reference
    names a mesh axis inside ``shard_map``).
Neither is wired into the train step, as in the reference.
"""
from __future__ import annotations

import torch

from repro_torch import distributed
from repro_torch.models.params import tree_map, tree_map2


def _scale(x, bits: int = 8):
    amax = torch.max(torch.abs(x)) + 1e-12
    qmax = 2.0 ** (bits - 1) - 1
    return amax / qmax, qmax


def _quant(x, bits: int = 8):
    scale, qmax = _scale(x, bits)
    q = torch.clamp(torch.round(x / scale), -qmax, qmax).to(torch.int8)
    return q, scale


def _dequant(q, scale):
    return q.to(torch.float32) * scale


def _pick(tree, i: int):
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_pick(v, i) for v in tree]
    return tree[i]


def make_error_feedback_compress(descr_like):
    """Returns (init_fn, transform) where transform(grads, residuals) ->
    (compressed_grads, new_residuals)."""

    def init(params):
        return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)

    def transform(grads, residuals):
        def per(g, r):
            gf = g.to(torch.float32) + r
            q, scale = _quant(gf)
            deq = _dequant(q, scale)
            return deq.to(g.dtype), gf - deq

        out = tree_map2(per, grads, residuals)
        return _pick(out, 0), _pick(out, 1)

    return init, transform


def allreduce_int8(x, group=None):
    """Explicit compressed all-reduce (the mean) of one tensor over
    ``group``: each rank's scale, their max (the common scale), each
    rank's payload re-quantised at it, the payloads summed as int32
    (saturation-safe for <= 2^23 ranks), rescaled by scale / ranks."""
    scale, _ = _scale(x)
    scale = distributed.all_reduce(scale.clone(), "max", group)
    q = torch.clamp(torch.round(x.to(torch.float32) / scale), -127, 127)
    total = distributed.all_reduce(q.to(torch.int32), "sum", group)
    n = float(distributed.world(group))
    return (total.to(torch.float32) * scale / n).to(x.dtype)
