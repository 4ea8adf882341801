"""LM assembly: embeddings, layer segments, tied or untied head, chunked
cross-entropy, and the entry points

  * ``train_loss(cfg, params, batch)``              training loss
  * ``prefill(cfg, params, batch)``                 full-sequence forward
  * ``prefill_chunk(cfg, params, batch, cache)``    chunked cache warm-up
  * ``decode_step(cfg, params, batch, cache)``      one decode step

Each segment's parameters keep a stacked leading layer axis (the JAX
package scans over it); here a Python loop walks the layer index.  Decode
caches are updated in place, where the JAX package donates them, in the
dense or the paged layout (``batch["page_table"]``).  Mixers: GQA
attention, MLA and Mamba-2; FFNs: dense, MoE (whose aux loss the
backbone sums over layers) or none.  A Jamba hybrid config is one segment
of super-blocks (``blocks.HybridPlan``), whose leaves carry two stack
axes, [super-blocks, layers of the group]; it serves and trains through
every entry point.  ``train_loss`` adds the DeepSeek multi-token-prediction loss where
the config has MTP modules.  The modality stubs serve and train through
every entry point: multi-codebook audio (musicgen: tokens [B, S, cb], an
embedding table and a head per codebook, logits [B, cb, V], the loss the
mean over codebooks) and the vision stub (phi-3-vision: precomputed
``image_embeds`` written over the token embeddings at ``image_positions``,
under autograd too).
"""
from __future__ import annotations

import contextvars
import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.device import resolve_device
from repro_torch.models import blocks as B
from repro_torch.models.attention import clamped_table
from repro_torch.models.layers import make_embedding, make_norm, rmsnorm
from repro_torch.models.params import Param, init_params
from repro_torch import distributed
from repro_torch.sharding.rules import QUEUE_A9B, shard
from repro_torch.sharding.tp import cache_layout as tp_cache_layout
from repro_torch.sharding.tp import model_axis


# ---------------------------------------------------------------------------
# segments
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Segment:
    kind: str              # 'blocks' | 'hybrid'
    count: int
    mixer: str = "attn"
    ffn: str = "dense"
    plan: object = None


def segments(cfg) -> list[Segment]:
    if cfg.hybrid_block:
        return [Segment("hybrid", cfg.num_layers // cfg.hybrid_block,
                        plan=B.HybridPlan.build(cfg))]
    if cfg.family == "ssm":
        return [Segment("blocks", cfg.num_layers, mixer="mamba", ffn="none")]
    mixer = "mla" if cfg.attention_kind == "mla" else "attn"
    if cfg.moe is None:
        return [Segment("blocks", cfg.num_layers, mixer=mixer, ffn="dense")]
    segs = []
    fk = cfg.moe.first_k_dense
    if fk:
        segs.append(Segment("blocks", fk, mixer=mixer, ffn="dense"))
    if cfg.moe.every != 1:
        raise ValueError("periodic MoE outside hybrid_block unsupported")
    segs.append(Segment("blocks", cfg.num_layers - fk, mixer=mixer, ffn="moe"))
    return segs


# ---------------------------------------------------------------------------
# descriptors
# ---------------------------------------------------------------------------
def make_lm(cfg):
    d, cb = cfg.d_model, cfg.num_codebooks
    p: dict = {"embed": (Param((cb, cfg.vocab_size, d),
                               ("codebooks", "vocab", "embed"),
                               init="normal", scale=0.02)
                         if cb else make_embedding(cfg.vocab_size, d))}
    p["segments"] = [B.stack_descr(
        B.make_super_block(cfg, seg.plan) if seg.kind == "hybrid"
        else B.make_block(cfg, seg.mixer, seg.ffn), seg.count)
        for seg in segments(cfg)]
    p["final_norm"] = make_norm(d)
    if not cfg.tie_embeddings:
        p["lm_head"] = (Param((cb, d, cfg.vocab_size),
                              ("codebooks", "embed", "vocab"), init="scaled")
                        if cb else Param((d, cfg.vocab_size),
                                         ("embed", "vocab"), init="scaled"))
    if cfg.mtp_depth:
        mixer = "mla" if cfg.attention_kind == "mla" else "attn"
        p["mtp"] = [{"norm_h": make_norm(d), "norm_e": make_norm(d),
                     "proj": Param((2 * d, d), (None, "embed"),
                                   init="scaled"),
                     "block": B.make_block(cfg, mixer, "dense")}
                    for _ in range(cfg.mtp_depth)]
    return p


def init_lm(cfg, generator: torch.Generator | None = None,
            device: str | torch.device = "cuda"):
    return init_params(make_lm(cfg), generator, device)


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------
def embed_tokens(cfg, params, tokens, batch=None):
    """tokens [B, S] (or [B, S, cb]) -> h [B, S, d].  With codebooks, each
    codebook's table takes its own column of the tokens and the rows are
    summed in fp32 in codebook order, then cast once.  With the vision
    stub and ``image_embeds`` [B, N, d] in the batch, row
    ``image_positions[b, n]`` of sequence b becomes ``image_embeds[b, n]``
    (cast to h's dtype), out of place, as ``repro/models/lm.py``'s
    ``h.at[b, pos].set(img)``; a position at or past S is dropped, as the
    reference's scatter drops it (an indexed write on CUDA would fault).
    Under a model axis that splits the vocabulary the lookup is this
    rank's rows, summed over the group (``_vocab_rows``), and the image
    rows are written over the whole sum, the same on every rank: their
    gradient reaches no table row, and the rest passes through the sum's
    backward once."""
    table = params["embed"]
    tp = _vocab_axis(cfg)
    if tp is not None and cfg.num_codebooks:
        # each codebook's share summed in fp32 in codebook order, then one
        # sum over the group
        h = _vocab_rows(table[0], tokens[..., 0], tp).float()
        for c in range(1, cfg.num_codebooks):
            h = h + _vocab_rows(table[c], tokens[..., c], tp).float()
        h = tp.leave(h).to(table.dtype)
    elif tp is not None:
        h = tp.leave(_vocab_rows(table, tokens, tp))
    elif cfg.num_codebooks:
        h = table[0][tokens[..., 0]].float()
        for c in range(1, cfg.num_codebooks):
            h = h + table[c][tokens[..., c]].float()
        h = h.to(table.dtype)
    else:
        h = table[tokens]
    if cfg.vision_stub and batch is not None and "image_embeds" in batch:
        h = _merge_image(h, batch["image_embeds"], batch["image_positions"])
    return shard(h, "batch", "seq", "embed")


def _merge_image(h, img, pos):
    """h with row pos[b, n] of sequence b set to img[b, n]; negative
    positions count from the end, and positions outside [0, S) write a
    scratch row past the end that is cut off again.  Where several n of
    one sequence name one row, the last writes it, as the reference's
    scatter does, and only that one gets a gradient, as JAX's scatter
    gives it: the others go to the scratch row, so every row is written
    once (the same bits on the card), by device ops alone (no host sync
    inside a captured step)."""
    Bsz, S, N = h.shape[0], h.shape[1], pos.shape[1]
    pos = pos.long()
    pos = torch.where(pos < 0, pos + S, pos)
    pos = torch.where((pos >= 0) & (pos < S), pos, S)
    later = torch.ones((N, N), dtype=torch.bool, device=h.device).triu(1)
    overwritten = ((pos[:, :, None] == pos[:, None, :]) & later).any(-1)
    pos = torch.where(overwritten, S, pos)
    b_idx = torch.arange(Bsz, device=h.device)[:, None].expand_as(pos)
    out = F.pad(h, (0, 0, 0, 1)).index_put((b_idx, pos), img.to(h.dtype))
    return out[:, :S]


def _vocab_axis(cfg):
    """The model axis where it splits the vocabulary (``sharding/tp.py``;
    the tables then hold this rank's rows, the head its columns), else
    None."""
    tp = model_axis()
    return tp if tp is not None and tp.splits("vocab", cfg.vocab_size) \
        else None


def _vocab_rows(table, tokens, tp):
    """This rank's share of the embedding rows of ``tokens``: its table's
    rows ([V / m, d]) where the token is in its slice of the vocabulary,
    zero rows elsewhere (the ranks' shares sum to the lookup)."""
    v_loc = table.shape[-2]
    local = tokens.long() - tp.rank * v_loc
    inside = (local >= 0) & (local < v_loc)
    rows = table[local.clamp(0, v_loc - 1)]
    return torch.where(inside[..., None], rows, torch.zeros_like(rows))


def whole_logits(cfg, logits):
    """``logits`` [..., V / m] of this rank's columns of a vocabulary
    split over the model axis gathered over the group into the whole
    [..., V], as the reference's global array; else ``logits``."""
    tp = _vocab_axis(cfg)
    if tp is None:
        return logits
    return distributed.all_gather(logits, logits.ndim - 1, tp.group)


def head_weights(cfg, params):
    if cfg.tie_embeddings:
        return params["embed"].transpose(-1, -2)  # [d, V] (or [cb, d, V])
    return params["lm_head"]


def apply_head(cfg, params, h):
    """h [..., d] -> logits [..., V] (or [..., cb, V] with codebooks)."""
    w = head_weights(cfg, params)
    if cfg.num_codebooks:
        return torch.einsum("...d,cdv->...cv", h, w)
    return h @ w


# ---------------------------------------------------------------------------
# backbone
# ---------------------------------------------------------------------------
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """Remat policy: keep the outputs of products with no batch dims
    (``mm``, ``addmm``), recompute everything else, as JAX's
    ``dots_with_no_batch_dims_saveable`` (``repro/models/lm.py:155-157``).
    Batched products (``bmm``, and the plain attention's batched
    ``matmul``) are recomputed, as there."""
    if op in _SAVED_DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


_remat_context = functools.partial(create_selective_checkpoint_contexts,
                                   _save_dots)

def _in_context(ctx, fn, *args):
    """``fn(*args)`` run in ``ctx``: a checkpointed layer's recompute runs
    on autograd's device thread on the card, which does not inherit the
    forward's context variables (the installed sharding rules, which the
    model axis's layers read: ``sharding/tp.py``)."""
    return ctx.run(fn, *args)


def _layers_in_order(seg, seg_params):
    """(mixer, ffn, layer params) of each layer of a segment in order: a
    block segment's layers, and each super-block's layers in its plan's
    order (views into the group stacks)."""
    for i in range(seg.count):
        unit = B.take_layer(seg_params, i)
        if seg.kind == "hybrid":
            for mixer, ffn, layer_p, _ in B.plan_layers(seg.plan, unit):
                yield mixer, ffn, layer_p
        else:
            yield seg.mixer, seg.ffn, unit


def backbone(cfg, params, h, positions, *, collect: bool = False,
             remat: bool = False):
    """Returns (h, aux_loss, caches-per-segment or None).  A collected
    segment cache stacks its layers' {k, v} along a leading axis; a hybrid
    segment's is {group: {name: [super-blocks, layers of the group, ...]}},
    as its parameters are stacked.

    ``remat`` runs each layer (a super-block's too, one at a time) under
    ``torch.utils.checkpoint`` (not reentrant) with the selective policy
    ``_save_dots``: the backward keeps the layer's projections and
    recomputes the rest from the layer's input (the elementwise ops, the
    MoE experts' batched products, the attention and the SSD scan, whose
    forward kernels run again), as JAX's remat of the scanned layer or
    super-block does under the same policy; the gradients are the same
    bits as without remat, only memory and time differ (the backward
    holds one layer's recompute, not a super-block's).  No layer draws
    random numbers, so the recompute needs no saved generator state
    (``preserve_rng_state=False``: no stash and restore of the CUDA
    generator per layer; the train step's CUDA graph captures with it on
    too, on PyTorch 2.11)."""
    aux = torch.zeros((), device=h.device)
    caches = []
    for seg, seg_params in zip(segments(cfg), params["segments"], strict=True):
        if collect and seg.kind == "hybrid":
            h, a, c = _hybrid_collect(cfg, seg, seg_params, h, positions)
            aux = aux + a
            caches.append(c)
            continue
        layer_caches = []
        for mixer, ffn, layer_p in _layers_in_order(seg, seg_params):
            if remat:
                h, a = checkpoint(
                    _in_context, contextvars.copy_context(), B.apply_block,
                    cfg, layer_p, h, positions, mixer, ffn,
                    use_reentrant=False, context_fn=_remat_context,
                    preserve_rng_state=False)
            else:
                h, a, c = B.apply_block_collect(cfg, layer_p, h, positions,
                                                mixer, ffn)
                if collect:
                    layer_caches.append(c)
            aux = aux + a
        if collect:
            caches.append({name: torch.stack([c[name] for c in layer_caches])
                           for name in layer_caches[0]})
    return h, aux, (caches if collect else None)


def _hybrid_collect(cfg, seg, seg_params, h, positions):
    """A hybrid segment's super-blocks in order: (h, aux, the cache of each
    group's layers stacked as [super-blocks, layers of the group, ...])."""
    aux = torch.zeros((), device=h.device)
    blocks = []
    for i in range(seg.count):
        h, a, c = B.apply_super_block_collect(
            cfg, B.take_layer(seg_params, i), h, positions, seg.plan)
        aux = aux + a
        blocks.append(c)
    return h, aux, {g: {name: torch.stack([c[g][name] for c in blocks])
                        for name in blocks[0][g]}
                    for g in blocks[0]}


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------
def _xent_chunk(cfg, params, h, targets, mask):
    """Cross-entropy for one [B, C, d] chunk, fp32. Returns (sum_loss, n).

    Under a model axis that splits the vocabulary each rank makes the
    logits of its columns only: the row max, the sum of exponentials and
    the target's logit are reduced over the ranks, so no rank builds a
    whole row."""
    tp = _vocab_axis(cfg)
    if tp is None:
        logits = apply_head(cfg, params, h).float()
        lse = torch.logsumexp(logits, dim=-1)
        tgt = logits.gather(-1, targets[..., None].long())[..., 0]
    else:
        logits = apply_head(cfg, params, tp.enter(h)).float()
        v_loc = logits.shape[-1]
        top = distributed.all_reduce(logits.detach().amax(dim=-1), "max",
                                     tp.group)
        sumexp = tp.leave(torch.exp(logits - top[..., None]).sum(dim=-1))
        lse = top + torch.log(sumexp)
        local = targets.long() - tp.rank * v_loc
        inside = (local >= 0) & (local < v_loc)
        tgt = logits.gather(-1, local.clamp(0, v_loc - 1)[..., None])[..., 0]
        tgt = tp.leave(torch.where(inside, tgt, torch.zeros_like(tgt)))
    nll = lse - tgt
    if cfg.num_codebooks:
        nll = nll.mean(dim=-1)  # [B, C, cb] -> [B, C]: the codebooks' mean
    mf = mask.float()
    return (nll * mf).sum(), mf.sum()


def chunked_xent(cfg, params, h, targets, mask, chunk: int = 512,
                 count=None):
    """Sequence-chunked xent: the [B, S, V] logits are made ``chunk``
    positions at a time, with a shorter last chunk for the remainder.
    The summed loss over the summed count of unmasked positions; with
    ``count`` (data-parallel ranks: a sum over the ranks) the sum over
    ``count(n)``, so that the ranks' results add up to the loss of their
    rows together."""
    S = h.shape[1]
    if count is None:
        count = _same
    if S <= chunk:
        s, n = _xent_chunk(cfg, params, h, targets, mask)
        return s / count(n).clamp(min=1.0)
    n_chunks = S // chunk
    rem = S - n_chunks * chunk
    parts = [_xent_chunk(cfg, params, h[:, i * chunk:(i + 1) * chunk],
                         targets[:, i * chunk:(i + 1) * chunk],
                         mask[:, i * chunk:(i + 1) * chunk])
             for i in range(n_chunks)]
    total = torch.stack([s for s, _ in parts]).sum()
    n = torch.stack([c for _, c in parts]).sum()
    if rem:
        s2, n2 = _xent_chunk(cfg, params, h[:, -rem:], targets[:, -rem:],
                             mask[:, -rem:])
        total, n = total + s2, n + n2
    return total / count(n).clamp(min=1.0)


def _same(n):
    return n


def train_loss(cfg, params, batch, *, remat: bool = True,
               xent_chunk: int = 512, count=None):
    """batch: tokens [B, S] (or [B, S, cb]; int), optional loss_mask
    [B, S], optional image_embeds [B, N, d] and image_positions [B, N]
    (merged as ``embed_tokens`` merges them).  Next-token cross-entropy
    over positions 1..S-1 (with codebooks the mean of the codebooks'
    losses; image rows are not masked, as in the reference), ``xent_chunk``
    positions of logits at a time, plus the MoE aux loss and, with
    ``cfg.mtp_depth`` modules,
    ``mtp_loss_weight`` times their mean loss: module ``d`` joins the
    normed hidden state of position t with the normed embedding of token
    t + 1, runs one block on the S - 1 positions and predicts token
    t + 1 + d.  As in the reference, remat covers the backbone's layers
    only; the MTP blocks keep their activations.  Returns (loss, metrics).

    ``count`` makes this rank's share of a loss over data-parallel ranks
    (``train_step``): it maps a count of this rank's positions to a new
    tensor, the count over every rank (an all-reduce); each loss term is then this
    rank's summed numerator over the ranks' summed count (the MoE aux, a
    mean over tokens, is weighted by this rank's share of the tokens), so
    the ranks' losses and gradients sum to those of the global batch."""
    tokens = batch["tokens"]
    Bsz, S = tokens.shape[0], tokens.shape[1]
    positions = torch.arange(S, device=tokens.device)[None, :]
    h = embed_tokens(cfg, params, tokens, batch)
    h, aux, _ = backbone(cfg, params, h, positions, remat=remat)
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones((Bsz, S), dtype=torch.float32, device=h.device)
    ce = chunked_xent(cfg, params, h[:, :-1], tokens[:, 1:], mask[:, 1:],
                      xent_chunk, count)
    if count is not None:
        rows = torch.full((), float(Bsz * S), device=h.device)
        aux = aux * (rows / count(rows))
    loss = ce + aux
    metrics = {"ce": ce, "aux": aux}
    if cfg.mtp_depth:
        mixer = "mla" if cfg.attention_kind == "mla" else "attn"
        mtp = torch.zeros((), device=h.device)
        h_prev = h
        for depth, mp in enumerate(params["mtp"], start=1):
            emb = embed_tokens(cfg, params, tokens, batch)
            hm_in = torch.cat(
                [rmsnorm(h_prev[:, :-1], mp["norm_h"], cfg.norm_eps),
                 rmsnorm(emb[:, 1:], mp["norm_e"], cfg.norm_eps)],
                dim=-1) @ mp["proj"]
            hm, _ = B.apply_block(cfg, mp["block"], hm_in, positions[:, 1:],
                                  mixer, "dense")
            d1 = depth + 1
            mtp = mtp + chunked_xent(cfg, params, hm[:, :S - d1],
                                     tokens[:, d1:], mask[:, d1:], xent_chunk,
                                     count)
            h_prev = F.pad(hm, (0, 0, 0, 1))
        loss = loss + cfg.mtp_loss_weight * mtp / cfg.mtp_depth
        metrics["mtp"] = mtp
    metrics["loss"] = loss
    return loss, metrics


# ---------------------------------------------------------------------------
# serving entry points
# ---------------------------------------------------------------------------
def prefill(cfg, params, batch):
    """Full-sequence forward returning (last-token logits, caches).  batch:
    tokens [B, S] (or [B, S, cb]), optional image_embeds [B, N, d] and
    image_positions [B, N] int (the vision stub).  Under a model axis the
    caches are this rank's part (``tp.cache_layout``) and the logits
    whole (``whole_logits``)."""
    tokens = batch["tokens"]
    S = tokens.shape[1]
    positions = torch.arange(S, device=tokens.device)[None, :]
    h = embed_tokens(cfg, params, tokens, batch)
    h, _, caches = backbone(cfg, params, h, positions, collect=True)
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    logits = whole_logits(cfg, apply_head(cfg, params, h[:, -1]))
    return logits, caches


def cache_descr(cfg, batch_size: int, max_seq: int,
                paged: tuple[int, int] | None = None, rules=None):
    """Descriptor tree of the decode cache (one entry per segment).

    Dense: attention {k, v} [layers, batch, max_seq, K, head_dim].
    ``paged=(num_pages, page_size)``: attention {k, v} become shared pools
    [layers, num_pages + 1, page_size, K, head_dim] (the last page is the
    sink, see ``attention.py``) addressed through ``batch["page_table"]``.
    Mamba {conv, ssm} keep their dense per-slot state in both layouts.  A
    hybrid segment's cache is one such tree per group of its plan, with
    two stack axes, [super-blocks, layers of the group].  With ``rules``
    (a mesh), each leaf at the shape this rank holds
    (``tp.cache_layout``: its rows of the batch, its heads and channels);
    the paged layout takes no model axis (ROADMAP Queue A item 9b)."""
    if rules is not None and paged is not None and rules.model_size() > 1:
        raise NotImplementedError(f"the paged KV layout on a model axis of "
                                  f"{rules.model_size()}: {QUEUE_A9B}")
    out = []
    for seg in segments(cfg):
        stack = (seg.count,)
        if seg.kind == "hybrid":
            out.append(B.make_super_block_cache_paged(
                           cfg, seg.plan, batch_size, *paged, stack=stack)
                       if paged is not None
                       else B.make_super_block_cache(
                           cfg, seg.plan, batch_size, max_seq, stack=stack))
        else:
            out.append(B.make_block_cache_paged(
                           cfg, seg.mixer, batch_size, *paged, stack=stack)
                       if paged is not None
                       else B.make_block_cache(
                           cfg, seg.mixer, batch_size, max_seq, stack=stack))
    return out if rules is None else tp_cache_layout(cfg, out, rules)


def make_cache(cfg, batch_size: int, max_seq: int,
               paged: tuple[int, int] | None = None, *,
               device: str | torch.device = "cuda", rules=None):
    """The zeroed decode cache of ``cache_descr`` on ``device`` (this
    rank's part with ``rules``)."""
    return init_params(cache_descr(cfg, batch_size, max_seq, paged, rules),
                       None, resolve_device(device))


def _layers(cfg, params, cache):
    """(segment, stacked unit's params, its cache views) per layer of a
    block segment and per super-block of a hybrid one, in order."""
    for seg, seg_params, seg_cache in zip(segments(cfg), params["segments"],
                                          cache, strict=True):
        for i in range(seg.count):
            yield (seg, B.take_layer(seg_params, i),
                   B.take_layer(seg_cache, i))


# the page axis of a paged pool, counted from the end: k [*stack, pages,
# page_size, K, D] and ckv [*stack, pages, page_size, rank], past however
# many stack axes lead (one for a block segment, two for a hybrid's group)
_PAGE_AXIS = {"k": -4, "ckv": -3}


def _read_table(cache, page_table):
    """The step's ``attention.clamped_table`` of ``page_table``, made once
    for every layer (their pools share the pages); None without a table
    or without a paged pool (Mamba's state stays dense).  A hybrid
    segment's pools sit one level down, in its groups."""
    if page_table is None:
        return None
    for seg_cache in cache:
        for c in (seg_cache, *seg_cache.values()):
            for name, axis in _PAGE_AXIS.items():
                if isinstance(c, dict) and name in c:
                    return clamped_table(page_table, c[name].shape[axis] - 1)
    return None


def prefill_chunk(cfg, params, batch, cache):
    """Prefill a C-token chunk into slot caches (continuous batching).

    batch: tokens [B, C] (or [B, C, cb]), start [B] int32 (per-slot cache
    offset of the chunk's first token), optional active [B] bool (inactive
    slots' caches are left untouched), optional page_table [B, W] int32
    (paged layout).
    No head/logits: the first sampled token always comes from the decode
    path.  Updates ``cache`` in place and returns it."""
    start, active = batch["start"], batch.get("active")
    page_table = batch.get("page_table")
    read_table = _read_table(cache, page_table)
    h = embed_tokens(cfg, params, batch["tokens"], batch)
    for seg, unit_p, unit_c in _layers(cfg, params, cache):
        h, _ = (B.apply_super_block_prefill_chunk(
                    cfg, unit_p, h, unit_c, start, seg.plan, active,
                    page_table, read_table)
                if seg.kind == "hybrid"
                else B.apply_block_prefill_chunk(
                    cfg, unit_p, h, unit_c, start, seg.mixer, seg.ffn,
                    active, page_table, read_table))
    return cache


def decode_step(cfg, params, batch, cache):
    """One decode step. batch: tokens [B, 1] (or [B, 1, cb]), pos [B]
    int32, optional active [B] bool, optional page_table [B, W] int32
    (paged layout).  Updates ``cache`` in place; returns (logits [B, V]
    (or [B, cb, V]), whole under a model axis, cache)."""
    pos, active = batch["pos"], batch.get("active")
    page_table = batch.get("page_table")
    read_table = _read_table(cache, page_table)
    h = embed_tokens(cfg, params, batch["tokens"], batch)
    for seg, unit_p, unit_c in _layers(cfg, params, cache):
        h, _ = (B.apply_super_block_decode(
                    cfg, unit_p, h, unit_c, pos, seg.plan, active,
                    page_table, read_table)
                if seg.kind == "hybrid"
                else B.apply_block_decode(
                    cfg, unit_p, h, unit_c, pos, seg.mixer, seg.ffn, active,
                    page_table, read_table))
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return whole_logits(cfg, apply_head(cfg, params, h[:, -1])), cache
