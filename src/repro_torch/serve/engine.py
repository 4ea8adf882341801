"""Batched decode engine with slot-based continuous batching.

Requests are admitted into fixed batch slots between decode steps.  Each
slot carries its own position counter (positions are a [B] vector through
the model) and an ``active`` mask: inactive slots write nothing to the KV
cache and keep their SSM/conv state, so admission and retirement of one
request never perturb the others.  A slot's per-slot state leaves (every
cache leaf without a sequence or page axis: Mamba's conv window and SSM
state) are zeroed in place when a request is admitted to it, so a reused
slot never leaks its previous occupant's state.

Two stepping modes:

* ``mode="fused"`` (default): ``steps_per_sync`` decode steps run back to
  back with the slot state (tokens, pos, cursor, plen, remaining, live,
  temperature, top-k, sampling keys and counters, the prompts and, paged,
  the page table) in device buffers — sampling, prompt forcing, emission
  and retirement are tensor ops — and no host sync inside the loop.  One
  device->host copy per sync brings back the sampled tokens, the emit
  mask and the new state.  On the card the loop is one CUDA graph, the
  counterpart of the reference's jitted ``lax.scan``: it is captured at
  the engine's first fused sync (after a warm-up on the capture stream
  with every slot inactive, which writes no cache row, keeps every SSM
  state and advances no sampling counter) and replayed once per sync.  A
  capture or replay that fails raises; the engine never runs the loop
  eagerly on the card.  On the CPU the same body runs eagerly.  The
  buffers keep their addresses for the engine's life: each sync refreshes
  them in place from pinned host staging, and the graph reads the params
  and the cache by address too, so replacing either needs a new engine.
* ``mode="host"``: the per-step host-sync baseline: one decode step, then
  per-slot sampling and bookkeeping on the host.  Greedy outputs are
  identical across modes.

Two KV-cache layouts:

* ``kv_layout="dense"``: every slot owns a ``max_seq`` KV stripe.
* ``kv_layout="paged"``: KV rides a shared pool of ``num_pages`` pages of
  ``page_size`` rows (``serve/kv_pool.py``) addressed through per-slot
  page tables.  Admission is memory-aware and FIFO (the head request is
  admitted only when its prompt's pages fit), pages are allocated lazily
  before each sync to cover the sync's worst-case advance and zeroed in
  place when handed out, and retirement frees them O(1).  On pool
  exhaustion the youngest slot is preempted and its request requeued at
  the head of the queue (at least once); the oldest slot can always run
  to completion, as the constructor requires ``num_pages >=
  ceil(max_seq/page_size)``, so every request completes.  Greedy outputs
  equal the dense layout's.  The fused loop writes through the page table
  (frozen within a sync) and calls the paged decode kernel every step.
  The JAX engine instead gathers each pool into a dense per-slot view for
  the sync and scatters the written rows back; that view would allocate
  ``B x W x page_size`` rows per layer and undo the layout's memory
  saving, and the contract is equal tokens, not the mechanism.

Prompt consumption is sequential forced decode by default; with
``prefill_chunk=C > 0`` admission runs batched C-token prefill chunks
into the slot's cache (``lm.prefill_chunk``) and only the remainder of
the prompt goes through forced decode, with
``max_prefill_tokens_per_sync`` bounding per-sync prefill work.

Malformed prompts (empty, or too long for ``max_seq``) are rejected with
a typed failure (``Request.failed`` + ``fail_reason``) instead of
crashing the engine; serving continues for everyone else.

A codebook model (musicgen) carries a codebook axis on every token, as
the JAX engine's ``cb_tail`` does: prompts [S, cb], the slot tokens
[B, 1, cb], one sampled token per codebook a step, and each entry of
``Request.output`` a (cb,) array.  The vision stub's image path is not
served (nor is it in the JAX engine): phi-3-vision serves text tokens.

Sampling randomness: a temperature > 0 request's stream is a 32-bit key
seeded from ``(rng_seed, admission index)``, so it does not depend on its
slot or its neighbours, and a step counter, both in the slot state
(``sampler.sample_batch`` hashes them), as the JAX engine carries
``keys``.  The counter advances once per decode step for a slot that is
live at the step's start and never for one that is still in chunked
prefill, in both modes, so host and fused mode draw the same tokens.
Greedy requests' tokens take nothing from either.
"""
from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.graphs import Staged, capture
from repro_torch.kernels.decode_attention import pages_ok
from repro_torch.models import lm
from repro_torch.models.params import init_params, tree_leaves
from repro_torch.serve.kv_pool import KVPool, PoolExhausted
from repro_torch.serve.sampler import sample_batch, vocab_hash
from repro_torch.tune import cache as tune_cache

# paged-KV rows per page when the caller names none and the tune cache
# has no entry for the engine's decode shape (the JAX engine's value)
DEFAULT_PAGE_SIZE = 16
# the int32 slot state the fused loop reads, one [B] row each (a codebook
# model's [B, cb] tokens have a buffer of their own instead of the first)
SLOT_ROWS = ("tokens", "pos", "cursor", "plen", "remaining", "live", "topk",
             "counters")
# the [B] rows of the fused loop's packed result after its n*B sampled
# tokens, n*B emit flags and B slot tokens (n*B*cb and B*cb with codebooks)
RESULT_ROWS = ("pos", "cursor", "remaining", "live", "counters")


def _resolve_page_size(cfg, batch_slots: int, max_seq: int, device) -> int:
    """Tuned ``page_size`` for this engine's decode geometry, as
    ``repro.serve.engine._resolve_page_size`` picks it.

    Consults the ``repro_torch.tune`` best-config cache under the
    ``decode_attention_paged`` key (shape = this engine's steady-state
    decode call: B = slots, Sk = max_seq, the GQA geometry from cfg) for
    the route of ``device``.  A miss, or an MLA or attention-free config
    (whose paged pool is not the tuned kernel's), returns the built-in
    default.  A tuned value is re-validated by the paged kernel's own
    check (``decode_attention.pages_ok``), so a stale entry falls back to
    the default."""
    if cfg.attention_kind != "gqa":
        return DEFAULT_PAGE_SIZE
    kvh = cfg.num_kv_heads
    shape = {"b": batch_slots, "sk": max_seq, "kvh": kvh,
             "g": max(1, cfg.num_heads // kvh), "d": cfg.head_dim}
    hit = tune_cache.best_config("decode_attention_paged", shape, cfg.dtype,
                                 device)
    ps = int((hit or {}).get("page_size", DEFAULT_PAGE_SIZE))
    return ps if pages_ok(max_seq, ps) else DEFAULT_PAGE_SIZE


@dataclass
class Request:
    prompt: np.ndarray          # [S] (or [S, cb]) int32
    max_new_tokens: int = 16
    temperature: float = 0.0
    top_k: int = 0
    output: list = field(default_factory=list)
    done: bool = False
    failed: bool = False        # typed rejection (bad prompt) — never served
    fail_reason: str | None = None


def request_key(rng_seed: int, admission_index: int) -> int:
    """The 32-bit sampling key of the ``admission_index``-th request."""
    seq = np.random.SeedSequence([int(rng_seed), int(admission_index)])
    return int(seq.generate_state(1, np.uint32)[0])


class DecodeEngine:
    def __init__(self, cfg, params, *, batch_slots: int = 4,
                 max_seq: int = 512, rng_seed: int = 0, mode: str = "fused",
                 steps_per_sync: int = 8, prefill_chunk: int = 0,
                 max_prefill_tokens_per_sync: int | None = None,
                 kv_layout: str = "dense", page_size: int | None = None,
                 num_pages: int | None = None,
                 device: str | torch.device = "cuda"):
        if mode not in ("fused", "host"):
            raise ValueError(f"mode must be 'fused' or 'host', got {mode!r}")
        if kv_layout not in ("dense", "paged"):
            raise ValueError(f"kv_layout must be 'dense' or 'paged', got "
                             f"{kv_layout!r}")
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, the "
                             f"engine on {self.device}")
        self.cfg = cfg
        self.params = params
        self.B = batch_slots
        self.max_seq = max_seq
        self.mode = mode
        self.steps_per_sync = max(1, int(steps_per_sync))
        self.prefill_chunk = int(prefill_chunk)
        self.max_prefill_tokens_per_sync = max_prefill_tokens_per_sync
        self.kv_layout = kv_layout
        self.rng_seed = int(rng_seed)
        self.pool: KVPool | None = None
        paged = None
        if kv_layout == "paged":
            # explicit page_size > tuned cache > default (16)
            page_size = int(page_size or _resolve_page_size(
                cfg, batch_slots, max_seq, self.device))
            width = -(-max_seq // page_size)
            if num_pages is None:
                # capacity parity with the dense layout by default; size the
                # pool below slots * width for memory-aware admission
                num_pages = batch_slots * width
            if num_pages < width:
                raise ValueError(
                    f"num_pages={num_pages} cannot back one full sequence "
                    f"(need >= ceil(max_seq/page_size) = {width}); the "
                    "oldest slot could deadlock")
            self.pool = KVPool(num_pages, page_size, batch_slots, max_seq)
            paged = (int(num_pages), page_size)
        descr = lm.cache_descr(cfg, batch_slots, max_seq, paged)
        self.cache = init_params(descr, None, self.device)
        # per-slot state leaves (no sequence axis) with their batch axis,
        # and the paged pools with their page axis (just before seq_kv)
        self._state_leaves, self._pool_leaves = [], []
        for d, leaf in zip(tree_leaves(descr), tree_leaves(self.cache),
                           strict=True):
            if "seq_kv" not in d.logical:
                self._state_leaves.append((leaf, d.logical.index("batch")))
            elif paged is not None:
                self._pool_leaves.append((leaf,
                                          d.logical.index("seq_kv") - 1))
        self._slot_state_elems = sum(leaf.numel() // leaf.shape[ax]
                                     for leaf, ax in self._state_leaves)
        self._page_elems = sum(leaf.numel() // leaf.shape[ax]
                               for leaf, ax in self._pool_leaves)

        B = batch_slots
        self.cb_tail = (cfg.num_codebooks,) if cfg.num_codebooks else ()
        self.tokens = np.zeros((B, 1, *self.cb_tail), np.int32)
        self.pos = np.zeros((B,), np.int32)
        self.cursor = np.zeros((B,), np.int32)
        self.plen = np.zeros((B,), np.int32)
        self.remaining = np.zeros((B,), np.int32)
        self.live = np.zeros((B,), bool)
        self.temp = np.zeros((B,), np.float32)
        self.topk = np.zeros((B,), np.int32)
        self.keys = np.zeros((B,), np.int64)       # sampling keys
        self.counters = np.zeros((B,), np.int32)   # and their step counters
        self.prompt_buf = np.zeros((B, max_seq, *self.cb_tail), np.int32)
        self.pf_target = np.zeros((B,), np.int32)   # tokens to chunk-prefill
        self.pf_done = np.zeros((B,), np.int32)
        self.slot_admit = np.full((B,), -1, np.int64)  # admission order
        self.slot_req: list[Request | None] = [None] * B
        self.queue: collections.deque[Request] = collections.deque()
        self.steps = 0
        self._admitted = 0
        self.stats = {"admissions": 0, "rejected": 0, "preemptions": 0,
                      "admit_cache_elems": 0, "peak_occupied": 0}
        self._cache_elems = sum(t.numel() for t in tree_leaves(self.cache))
        # the per-vocab-index half of the sampling hash, a constant
        self._cb = cb = max(cfg.num_codebooks, 1)
        self._vhash = vocab_hash(cb * cfg.vocab_size, self.device).reshape(
            *self.cb_tail, cfg.vocab_size)

        # the fused loop's device buffers (fixed addresses) and its result
        dev = self.device
        self._slot_rows = SLOT_ROWS[1:] if self.cb_tail else SLOT_ROWS
        self._slots = Staged((len(self._slot_rows), B), torch.int32, dev)
        self._cb_tokens = (Staged((B, *self.cb_tail), torch.int32, dev)
                           if self.cb_tail else None)
        self._temp = Staged((B,), torch.float32, dev)
        self._keys = Staged((B,), torch.int64, dev)
        self._prompts = Staged((B, max_seq, *self.cb_tail), torch.int32, dev)
        self._table = (Staged(self.pool.table.shape, torch.int32, dev,
                               fill=self.pool.num_pages)
                       if self.pool is not None else None)
        self._pt_stale = False
        self._out = torch.zeros(
            (self.steps_per_sync * (cb + 1) + cb + len(RESULT_ROWS)) * B,
            dtype=torch.int32, device=dev)
        # the staging is rewritten only once its last copies have run
        self._pushed = (torch.cuda.Event() if dev.type == "cuda" else None)
        self._graph = None
        self._graph_stats = {"captures": 0, "capture_ms": 0.0, "replays": 0,
                             "graph_pool_bytes": 0}

    # ------------------------------------------------------------------
    def submit(self, req: Request):
        self.queue.append(req)

    def kv_stats(self) -> dict:
        """Accounting surface: engine counters, cache size and, paged, the
        pool's occupancy.  ``admit_cache_elems`` counts the cache elements
        the engine zeroed: the admitted slots' rows of the per-slot state
        leaves and, paged, every page handed out.  (The JAX engine's dense
        layout counts the whole cache per admission round instead, since
        its admission round-trips every leaf.)"""
        out = dict(self.stats)
        out["kv_layout"] = self.kv_layout
        out["cache_elems"] = self._cache_elems
        if self.pool is not None:
            out.update(self.pool.stats())
            out["slot_footprint"] = [self.pool.footprint(s)
                                     for s in range(self.B)]
        return out

    def graph_stats(self) -> dict:
        """The fused loop's CUDA graph: captures (at most one per engine),
        the capture's wall ms (warm-up included), replays, and the bytes
        the graph's private memory pool holds (the allocator's reserved
        bytes that the capture added).  All 0 on the CPU."""
        return dict(self._graph_stats)

    def _dev(self, arr: np.ndarray) -> torch.Tensor:
        return torch.tensor(arr, device=self.device)

    def _push(self, *pairs):
        """Copy each (``Staged``, host array) pair's array into its device
        buffer in place, on the current stream."""
        if self._pushed is not None:
            self._pushed.synchronize()
        for buf, arr in pairs:
            buf.push(arr)
        if self._pushed is not None:
            self._pushed.record(torch.cuda.current_stream(self.device))

    def _page_table(self):
        """The device page table (None for dense), refreshed in place when
        the host table changed since the last copy."""
        if self.pool is None:
            return None
        if self._pt_stale:
            self._push((self._table, self.pool.table))
            self._pt_stale = False
        return self._table.dev

    # -- paged-pool plumbing -------------------------------------------
    def _flush_dirty_pages(self, dirty: list[int]):
        """Zero freshly allocated pages in place (they may hold a previous
        occupant's rows); the cost follows the pages handed out, never
        max_seq."""
        if not dirty:
            return
        ids = torch.tensor(dirty, dtype=torch.long, device=self.device)
        for leaf, ax in self._pool_leaves:
            leaf.index_fill_(ax, ids, 0)
        self.stats["admit_cache_elems"] += len(dirty) * self._page_elems

    def _preempt(self, slot: int):
        """Evict ``slot`` on pool exhaustion: free its pages and requeue its
        request at the head of the queue (its output restarts from the
        prompt; a temperature > 0 request draws a fresh stream)."""
        req = self.slot_req[slot]
        self.pool.free_slot(slot)
        self._pt_stale = True
        self.slot_req[slot] = None
        self.live[slot] = False
        self.pf_target[slot] = 0
        self.pf_done[slot] = 0
        self.slot_admit[slot] = -1
        req.output.clear()
        req.done = False
        self.queue.appendleft(req)
        self.stats["preemptions"] += 1

    def _reclaim_for(self, slot: int, upto_pos: int) -> list[int] | None:
        """Extend ``slot``'s table to back ``upto_pos``, preempting younger
        occupied slots while the free list is short.  Returns the fresh page
        ids, or None if ``slot`` itself was preempted (it was the
        youngest)."""
        while True:
            try:
                fresh = self.pool.alloc(slot, upto_pos)
                if fresh:
                    self._pt_stale = True
                return fresh
            except PoolExhausted:
                victims = [s for s in range(self.B)
                           if self.slot_req[s] is not None
                           and self.slot_admit[s] > self.slot_admit[slot]]
                if not victims:
                    self._preempt(slot)
                    return None
                self._preempt(max(victims, key=lambda s: self.slot_admit[s]))

    def _ensure_decode_pages(self, n_steps: int):
        """Before a sync: back every live slot's worst-case advance
        (``pos .. pos+n_steps-1``), oldest slots first."""
        dirty: list[int] = []
        order = sorted((s for s in range(self.B) if self.live[s]),
                       key=lambda s: self.slot_admit[s])
        for s in order:
            if not self.live[s]:        # preempted by an older claimant
                continue
            upto = min(int(self.pos[s]) + n_steps - 1, self.max_seq - 1)
            fresh = self._reclaim_for(s, upto)
            if fresh:
                dirty.extend(fresh)
        self._flush_dirty_pages(dirty)

    # ------------------------------------------------------------------
    def _start_decode(self, slot: int):
        """Arm a slot for (forced-)decode after 0..pf_target prefilled."""
        q = int(self.pf_target[slot])
        self.tokens[slot, 0] = self.prompt_buf[slot, q]
        self.cursor[slot] = q + 1
        self.pos[slot] = q
        self.live[slot] = True

    def _reject(self, req: Request, reason: str):
        req.failed = True
        req.done = True
        req.fail_reason = reason
        self.stats["rejected"] += 1

    def _admit(self):
        admitted = []
        free_slots = (s for s in range(self.B) if self.slot_req[s] is None)
        while self.queue:
            req = self.queue[0]
            prompt = np.asarray(req.prompt, np.int32)
            L = prompt.shape[0]
            if prompt.shape[1:] != self.cb_tail:
                self.queue.popleft()
                self._reject(req, f"prompt shape {prompt.shape}: tokens "
                                  f"need the trailing shape {self.cb_tail}")
                continue
            if not 1 <= L < self.max_seq:
                # typed rejection: the engine keeps serving everyone else
                self.queue.popleft()
                self._reject(req, f"prompt length {L} outside "
                                  f"[1, max_seq={self.max_seq})")
                continue
            if self.pool is not None \
                    and self.pool.pages_for(L) > self.pool.free_pages:
                break   # memory-aware, FIFO: the head's pages must fit
            slot = next(free_slots, None)
            if slot is None:
                break
            self.queue.popleft()
            self.slot_req[slot] = req
            self.slot_admit[slot] = self._admitted
            self.prompt_buf[slot, :L] = prompt
            self.plen[slot] = L
            self.remaining[slot] = req.max_new_tokens
            # per-request stream, independent of slot placement
            self.keys[slot] = request_key(self.rng_seed, self._admitted)
            self.counters[slot] = 0
            self._admitted += 1
            self.stats["admissions"] += 1
            self.temp[slot] = req.temperature
            self.topk[slot] = req.top_k
            C = self.prefill_chunk
            # full chunks only — the remainder plus the last prompt token go
            # through forced decode, so the first sampled token's logits
            # always come from the decode path
            q = ((L - 1) // C) * C if C > 0 else 0
            self.pf_target[slot] = q
            self.pf_done[slot] = 0
            if q:
                self.live[slot] = False   # decode starts after prefill
            else:
                self._start_decode(slot)
            admitted.append(slot)
        if admitted and self._state_leaves:
            idx = torch.tensor(admitted, dtype=torch.long, device=self.device)
            for leaf, ax in self._state_leaves:
                leaf.index_fill_(ax, idx, 0)
            self.stats["admit_cache_elems"] += (len(admitted)
                                                * self._slot_state_elems)
        occupied = sum(r is not None for r in self.slot_req)
        self.stats["peak_occupied"] = max(self.stats["peak_occupied"],
                                          occupied)

    def _pump_prefill(self):
        C = self.prefill_chunk
        if not C:
            return
        pending = [s for s in range(self.B)
                   if self.slot_req[s] is not None
                   and self.pf_done[s] < self.pf_target[s]]
        if not pending:
            return
        budget = self.max_prefill_tokens_per_sync
        pending.sort(key=lambda s: self.slot_admit[s])
        take = []
        dirty: list[int] = []
        for s in pending:
            if budget is not None and take and (len(take) + 1) * C > budget:
                break   # bound per-sync prefill work (at least one slot)
            if self.slot_req[s] is None:
                continue                # preempted by an older slot above
            if self.pool is not None:
                fresh = self._reclaim_for(s, int(self.pf_done[s]) + C - 1)
                if fresh is None:
                    continue            # preempted (youngest): requeued
                dirty.extend(fresh)
            take.append(s)
        if self.pool is not None:
            self._flush_dirty_pages(dirty)
        if not take:
            return
        tok = np.zeros((self.B, C, *self.cb_tail), np.int32)
        start = np.zeros((self.B,), np.int32)
        active = np.zeros((self.B,), bool)
        for s in take:
            d = int(self.pf_done[s])
            tok[s] = self.prompt_buf[s, d:d + C]
            start[s] = d
            active[s] = True
        batch = {"tokens": self._dev(tok), "start": self._dev(start),
                 "active": self._dev(active), "page_table": self._page_table()}
        lm.prefill_chunk(self.cfg, self.params, batch, self.cache)
        for s in take:
            self.pf_done[s] += C
            if self.pf_done[s] >= self.pf_target[s]:
                self._start_decode(s)

    def _retire(self, slot: int):
        self.slot_req[slot].done = True
        self.slot_req[slot] = None
        self.slot_admit[slot] = -1
        if self.pool is not None:
            self.pool.free_slot(slot)   # O(1) free on retirement
            self._pt_stale = True

    # ------------------------------------------------------------------
    def _host_step(self) -> int:
        """Per-step host sync (benchmark baseline)."""
        if not self.live.any():
            return 0
        if self.pool is not None:
            self._ensure_decode_pages(1)
            if not self.live.any():     # everyone preempted (tiny pool)
                return 0
        batch = {"tokens": self._dev(self.tokens), "pos": self._dev(self.pos),
                 "active": self._dev(self.live),
                 "page_table": self._page_table()}
        logits, _ = lm.decode_step(self.cfg, self.params, batch, self.cache)
        self.steps += 1
        emitting = [s for s in range(self.B)
                    if self.slot_req[s] is not None and self.live[s]
                    and self.cursor[s] >= self.plen[s]]
        sampled = None
        if emitting:
            sampled = sample_batch(
                logits, self._dev(self.keys), self._dev(self.counters).long(),
                self._dev(self.temp), self._dev(self.topk),
                self._vhash).cpu().numpy()
        self.counters += self.live          # as the fused loop advances them
        finished = 0
        for slot in range(self.B):
            req = self.slot_req[slot]
            if req is None or not self.live[slot]:
                continue
            self.pos[slot] += 1
            if self.cursor[slot] < self.plen[slot]:
                self.tokens[slot, 0] = self.prompt_buf[slot,
                                                       self.cursor[slot]]
                self.cursor[slot] += 1
                continue
            tok = self._token(sampled[slot])
            req.output.append(tok)
            self.remaining[slot] -= 1
            self.tokens[slot, 0] = tok
            if self.remaining[slot] <= 0 or self.pos[slot] >= self.max_seq - 1:
                self.live[slot] = False
                self._retire(slot)
                finished += 1
        return finished

    def _token(self, sampled):
        """One slot's sampled token as ``Request.output`` holds it: an int,
        or a (cb,) array with codebooks."""
        return sampled.copy() if self.cb_tail else int(sampled)

    def _fused_steps(self, n_steps: int):
        """Run ``n_steps`` decode steps on the slot-state buffers and write
        the packed int32 result [sampled (n*B) | emit (n*B) | tokens | pos |
        cursor | remaining | live | counters] into ``self._out`` (sampled
        n*B*cb and tokens B*cb with codebooks, the masks broadcast over the
        codebook axis).  Reads
        and writes nothing else but the cache, and nothing in here waits
        for the device: the same body runs eagerly on the CPU and is
        captured as a CUDA graph on the card."""
        B, max_seq = self.B, self.max_seq
        st = dict(zip(self._slot_rows, self._slots.dev, strict=True))
        tokens = self._cb_tokens.dev if self.cb_tail else st["tokens"]
        pos, cursor, plen = st["pos"], st["cursor"], st["plen"]
        cb_axis = (slice(None),) + (None,) * len(self.cb_tail)
        remaining, counters, topk = st["remaining"], st["counters"], st["topk"]
        live = st["live"] != 0
        temp, keys, prompt_buf = self._temp.dev, self._keys.dev, \
            self._prompts.dev
        page_table = self._table.dev if self._table is not None else None
        b_idx = torch.arange(B, device=self.device)
        sampled_hist, emit_hist = [], []
        for _ in range(n_steps):
            batch = {"tokens": tokens[:, None], "pos": pos, "active": live,
                     "page_table": page_table}
            logits, _ = lm.decode_step(self.cfg, self.params, batch,
                                       self.cache)
            pos = pos + live.int()
            sampled = sample_batch(logits, keys, counters.long(), temp, topk,
                                   self._vhash)
            counters = counters + live.int()
            forcing = cursor < plen
            forced = prompt_buf[b_idx, cursor.clamp(0, max_seq - 1)]
            tokens = torch.where(live[cb_axis],
                                 torch.where(forcing[cb_axis], forced,
                                             sampled), tokens)
            cursor = cursor + (forcing & live).int()
            emit = live & ~forcing
            remaining = remaining - emit.int()
            done_now = emit & ((remaining <= 0) | (pos >= max_seq - 1))
            live = live & ~done_now
            sampled_hist.append(sampled)
            emit_hist.append(emit.int())
        self._out.copy_(torch.cat([torch.stack(sampled_hist).flatten(),
                                   torch.stack(emit_hist).flatten(),
                                   tokens.flatten(), pos, cursor, remaining,
                                   live.int(), counters]))

    def _capture(self):
        """Capture ``_fused_steps`` as the engine's CUDA graph
        (``graphs.capture``).  A warm-up on the capture stream with every
        slot inactive first loads the kernels, cuBLAS's handles and the
        decode kernel's counters for that stream outside the graph's pool,
        and leaves the cache and the sampling counters as they were.  The
        launch counts of the kernel wrappers count the warm-up (it
        launches) but not the capture (it launches nothing); ``_replay``
        adds what one replay launches."""
        n, dev = self.steps_per_sync, self.device
        t0 = time.perf_counter()
        with torch.cuda.device(dev):
            stream = torch.cuda.Stream(dev)
            live = self._slots.dev[self._slot_rows.index("live")]
            pushed = live.clone()
            live.zero_()
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream), torch.no_grad():
                self._fused_steps(n)
            torch.cuda.current_stream(dev).wait_stream(stream)
            live.copy_(pushed)

        def body():
            with torch.no_grad():
                self._fused_steps(n)

        self._graph = capture(body, dev, stream, f"the fused decode loop "
                              f"({n} steps, {self.B} slots)")
        self._graph_stats["captures"] += 1
        self._graph_stats["capture_ms"] += (time.perf_counter() - t0) * 1e3
        self._graph_stats["graph_pool_bytes"] = self._graph.pool_bytes

    @property
    def _per_replay(self) -> dict:
        """Each counted kernel wrapper's launches in one replay."""
        return {} if self._graph is None else self._graph.per_replay

    def _replay(self):
        """One replay of the captured loop on the current stream."""
        self._graph.replay()
        self._graph_stats["replays"] += 1

    def _run_fused(self):
        """The fused loop over the freshly pushed buffers: eager on the
        CPU, the captured graph (captured at the first call) on the card."""
        if self.device.type == "cpu":
            self._fused_steps(self.steps_per_sync)
            return
        if self._graph is None:
            self._capture()
        with torch.cuda.device(self.device):
            self._replay()

    def _fused_sync(self) -> int:
        """One fused run of ``steps_per_sync`` steps + one host sync."""
        if not self.live.any():
            return 0
        n, B = self.steps_per_sync, self.B
        if self.pool is not None:
            self._ensure_decode_pages(n)
            if not self.live.any():     # everyone preempted (tiny pool)
                return 0
        self._page_table()                # refreshed in place if stale
        rows = [self.pos, self.cursor, self.plen, self.remaining, self.live,
                self.topk, self.counters]
        pairs = [(self._temp, self.temp), (self._keys, self.keys),
                 (self._prompts, self.prompt_buf)]
        if self.cb_tail:
            pairs.append((self._cb_tokens, self.tokens[:, 0]))
        else:
            rows.insert(0, self.tokens[:, 0])
        self._push((self._slots, np.stack(rows)), *pairs)
        self._run_fused()
        packed = self._out.cpu().numpy()                # the one sync
        self.steps += n
        cb = self._cb
        sampled = packed[:n * B * cb].reshape(n, B, *self.cb_tail)
        packed = packed[n * B * cb:]
        emit = packed[:n * B].reshape(n, B).astype(bool)
        tokens = packed[n * B:n * B + B * cb].reshape(B, 1, *self.cb_tail)
        state = dict(zip(RESULT_ROWS,
                         packed[n * B + B * cb:].reshape(-1, B), strict=True))
        for s in range(n):
            for slot in np.nonzero(emit[s])[0]:
                self.slot_req[slot].output.append(
                    self._token(sampled[s, slot]))
        self.tokens = tokens.copy()
        self.pos, self.cursor, self.remaining, self.counters = (
            state["pos"].copy(), state["cursor"].copy(),
            state["remaining"].copy(), state["counters"].copy())
        new_live = state["live"].astype(bool)
        finished = 0
        for slot in np.nonzero(self.live & ~new_live)[0]:
            self._retire(slot)
            finished += 1
        self.live = new_live
        return finished

    def step(self) -> int:
        """Admission + one stepping round; returns #requests finished.

        In fused mode one round is ``steps_per_sync`` decode steps."""
        self._admit()
        self._pump_prefill()
        return self._fused_sync() if self.mode == "fused" \
            else self._host_step()

    def run_until_drained(self, max_steps: int = 100_000) -> int:
        while (self.queue or any(r is not None for r in self.slot_req)) \
                and self.steps < max_steps:
            self.step()
        return self.steps
