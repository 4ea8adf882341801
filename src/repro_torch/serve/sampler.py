"""Token samplers: greedy / temperature / top-k.

Greedy is an argmax whose ties go to the lowest index, exactly as in
``repro.serve.sampler._greedy`` (``torch.argmax`` does not promise which
tied index wins).  Temperature > 0 draws by the Gumbel-max trick from a
``torch.Generator`` on the logits' device: ``jax.random.categorical``'s
bits cannot be reproduced, so only the distribution matches the
reference.  ``sample_batch`` is the slot-vectorised variant the serving
engine uses, with one generator per slot so concurrent requests draw from
independent streams.
"""
from __future__ import annotations

import torch


def _greedy(lf):
    """argmax with the lowest index winning an exact tie."""
    m = lf.amax(dim=-1, keepdim=True)
    v = lf.shape[-1]
    idx = torch.arange(v, dtype=torch.int32, device=lf.device).expand(lf.shape)
    big = torch.full_like(idx, v)
    return torch.where(lf == m, idx, big).amin(dim=-1)


def _gumbel(shape, generator, device):
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u))


def sample(logits, generator: torch.Generator | None = None, *,
           temperature: float = 0.0, top_k: int = 0):
    """logits [..., V] -> token ids [...] (int32).

    temperature == 0 selects greedy argmax and draws nothing; otherwise a
    draw from softmax(logits / temperature), restricted to the ``top_k``
    largest logits when top_k > 0."""
    lf = logits.float()
    if temperature <= 0.0:
        return _greedy(lf)
    scaled = lf / max(float(temperature), 1e-6)
    if top_k:
        cutoff = torch.topk(scaled, top_k, dim=-1).values[..., -1:]
        scaled = scaled.masked_fill(scaled < cutoff, float("-inf"))
    noisy = scaled + _gumbel(scaled.shape, generator, scaled.device)
    return noisy.argmax(dim=-1).to(torch.int32)


def sample_batch(logits, generators, temperature, top_k):
    """Per-slot batched sampling for the serving engine.

    logits: [B, V]; generators: one ``torch.Generator`` (on the logits'
    device) per slot, or None for a slot that draws nothing this step (a
    greedy slot); temperature: [B] f32 (0 = greedy); top_k: [B] int32
    (0 = disabled).  Returns int32 [B].  Nothing here syncs with the host."""
    lf = logits.float()
    B, V = lf.shape
    greedy = _greedy(lf)
    draw = [i for i, g in enumerate(generators) if g is not None]
    if not draw:
        return greedy
    # per-slot top-k: the k-th largest value as cutoff (top_k <= 0 keeps all)
    desc = torch.sort(lf, dim=-1, descending=True).values
    kidx = (top_k.clamp(1, V) - 1).long().reshape(B, 1)
    cutoff = torch.gather(desc, -1, kidx)
    use_k = (top_k > 0).reshape(B, 1)
    masked = lf.masked_fill(use_k & (lf < cutoff), float("-inf"))
    scaled = masked / temperature.float().clamp_min(1e-6).reshape(B, 1)
    noise = torch.zeros_like(scaled)
    for i in draw:
        noise[i] = _gumbel((V,), generators[i], lf.device)
    drawn = (scaled + noise).argmax(dim=-1).to(torch.int32)
    return torch.where(temperature > 0.0, drawn, greedy)
