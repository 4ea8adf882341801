"""Token samplers: greedy / temperature / top-k.

Greedy is an argmax whose ties go to the lowest index, exactly as in
``repro.serve.sampler._greedy`` (``torch.argmax`` does not promise which
tied index wins).  Temperature > 0 draws by the Gumbel-max trick:
``jax.random.categorical``'s bits cannot be reproduced, so only the
distribution matches the reference.

``sample_batch`` (the engine, in both modes) takes the noise from a
counter-based hash of (key, counter, vocab index): each slot carries a
key and a step counter as device tensors, the way the JAX engine carries
``keys``, so a captured CUDA graph replays the draws with no generator
state, and a slot's stream depends only on its own key and counter.  The
hash is plain int64 torch arithmetic whose every intermediate stays
below 2**63 (32-bit values times multipliers below 2**31), so the CPU and
the card give the same bits.  Its per-vocab-index half (``vocab_hash``)
is a constant that the caller computes once.  A codebook model's logits
[B, cb, V] hash index c * V + v for codebook c (``vocab_hash(cb * V)``
as [cb, V]), so codebook 0's bits are those of a [B, V] model's.
"""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
# odd multipliers below 2**31 (a product with a 32-bit value fits int64)
_MUL = (0x7FEB352D, 0x1B873593)
_UNIFORM_BITS = 23    # (k + 0.5) / 2**23 is exact in fp32 and lies in (0, 1)


def _greedy(lf):
    """argmax with the lowest index winning an exact tie."""
    m = lf.amax(dim=-1, keepdim=True)
    v = lf.shape[-1]
    idx = torch.arange(v, dtype=torch.int32, device=lf.device).expand(lf.shape)
    big = torch.full_like(idx, v)
    return torch.where(lf == m, idx, big).amin(dim=-1)


def _mix32(x):
    """A bijection of 32-bit values held in int64 (xorshift-multiply)."""
    x = x ^ (x >> 16)
    x = (x * _MUL[0]) & _M32
    x = x ^ (x >> 15)
    x = (x * _MUL[1]) & _M32
    return x ^ (x >> 16)


def vocab_hash(vocab: int, device) -> torch.Tensor:
    """[vocab] int64: the vocab index's half of ``hash_bits``."""
    return _mix32(torch.arange(vocab, dtype=torch.int64, device=device))


def hash_bits(keys, counters, vhash):
    """[B, *vhash.shape] int64 hash values in [0, 2**32) of (key, counter,
    vocab index); keys and counters are [B] int64 in [0, 2**32), ``vhash``
    is ``vocab_hash(V)`` (or ``vocab_hash(cb * V)`` as [cb, V])."""
    slot = _mix32(keys ^ _mix32(counters))
    return _mix32(slot.reshape(-1, *(1,) * vhash.ndim) ^ vhash[None])


def hash_gumbel(keys, counters, vhash):
    """[B, *vhash.shape] fp32 Gumbel noise from ``hash_bits``."""
    k = (hash_bits(keys, counters, vhash) >> (32 - _UNIFORM_BITS)).float()
    u = (k + 0.5) * 2.0 ** -_UNIFORM_BITS
    return -torch.log(-torch.log(u))


def sample_batch(logits, keys, counters, temperature, top_k, vhash):
    """Per-slot batched sampling for the decode engine.

    logits: [B, V] or [B, cb, V]; keys, counters: [B] int64 (the slot's
    stream and its position in it); temperature: [B] f32 (0 = greedy);
    top_k: [B] int32 (0 = disabled); vhash: ``vocab_hash(V)``, or
    ``vocab_hash(cb * V)`` as [cb, V].  Returns int32 [B] (or [B, cb]):
    greedy and top-k act on the last axis, per codebook.  Every slot's
    noise is made, so the work has one shape whatever the slots hold, but
    a greedy slot's token is the argmax.  Nothing here syncs with the
    host."""
    lf = logits.float()
    B, V = lf.shape[0], lf.shape[-1]
    lead = (B,) + (1,) * (lf.ndim - 2)      # per-slot values broadcast
    greedy = _greedy(lf)
    # per-slot top-k: the k-th largest value as cutoff (top_k <= 0 keeps all)
    desc = torch.sort(lf, dim=-1, descending=True).values
    kidx = (top_k.clamp(1, V) - 1).long().reshape(*lead, 1)
    cutoff = torch.gather(desc, -1, kidx.expand(*lf.shape[:-1], 1))
    use_k = (top_k > 0).reshape(*lead, 1)
    masked = lf.masked_fill(use_k & (lf < cutoff), float("-inf"))
    scaled = masked / temperature.float().clamp_min(1e-6).reshape(*lead, 1)
    drawn = (scaled + hash_gumbel(keys, counters, vhash)).argmax(dim=-1)
    return torch.where((temperature > 0.0).reshape(lead),
                       drawn.to(torch.int32), greedy)
