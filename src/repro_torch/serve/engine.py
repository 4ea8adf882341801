"""Batched decode engine with slot-based continuous batching.

Requests are admitted into fixed batch slots between decode steps.  Each
slot carries its own position counter (positions are a [B] vector through
the model) and an ``active`` mask: inactive slots write nothing to the KV
cache, so admission and retirement of one request never perturb the
others.

Two stepping modes:

* ``mode="fused"`` (default): ``steps_per_sync`` decode steps run back to
  back with the slot state (tokens, pos, cursor, plen, remaining, live) in
  device tensors — sampling, prompt forcing, emission and retirement are
  tensor ops — and no host sync inside the loop.  One device->host copy per
  sync brings back the sampled tokens, the emit mask and the new state.
  (The reference runs these steps in one jitted ``lax.scan``; capturing
  them in a CUDA graph is later work.)
* ``mode="host"``: the per-step host-sync baseline: one decode step, then
  per-slot sampling and bookkeeping on the host.  Greedy outputs are
  identical across modes.

Only the dense KV layout is ported: every slot owns a ``max_seq`` stripe.

Prompt consumption is sequential forced decode by default; with
``prefill_chunk=C > 0`` admission runs batched C-token prefill chunks
into the slot's cache (``lm.prefill_chunk``) and only the remainder of
the prompt goes through forced decode, with
``max_prefill_tokens_per_sync`` bounding per-sync prefill work.

Malformed prompts (empty, or too long for ``max_seq``) are rejected with
a typed failure (``Request.failed`` + ``fail_reason``) instead of
crashing the engine; serving continues for everyone else.

Sampling randomness: a temperature > 0 request draws from its own
``torch.Generator`` on the engine's device, seeded from
``(rng_seed, admission index)``, so its stream does not depend on its slot
or its neighbours.  Greedy requests draw nothing.
"""
from __future__ import annotations

import collections
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.serve.sampler import sample, sample_batch


@dataclass
class Request:
    prompt: np.ndarray          # [S] int32
    max_new_tokens: int = 16
    temperature: float = 0.0
    top_k: int = 0
    output: list = field(default_factory=list)
    done: bool = False
    failed: bool = False        # typed rejection (bad prompt) — never served
    fail_reason: str | None = None


def request_seed(rng_seed: int, admission_index: int) -> int:
    """Seed of the generator for the ``admission_index``-th request."""
    seq = np.random.SeedSequence([int(rng_seed), int(admission_index)])
    return int(seq.generate_state(1, np.uint64)[0])


class DecodeEngine:
    def __init__(self, cfg, params, *, batch_slots: int = 4,
                 max_seq: int = 512, rng_seed: int = 0, mode: str = "fused",
                 steps_per_sync: int = 8, prefill_chunk: int = 0,
                 max_prefill_tokens_per_sync: int | None = None,
                 kv_layout: str = "dense",
                 device: str | torch.device = "cuda"):
        if mode not in ("fused", "host"):
            raise ValueError(f"mode must be 'fused' or 'host', got {mode!r}")
        if kv_layout == "paged":
            raise NotImplementedError("kv_layout='paged' is not ported yet: "
                                      "ROADMAP slice 2 (Queue A item 3, paged)")
        if kv_layout != "dense":
            raise ValueError(f"kv_layout must be 'dense', got {kv_layout!r}")
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
        self.cache = lm.make_cache(cfg, batch_slots, max_seq,
                                   device=self.device)

        B = batch_slots
        self.tokens = np.zeros((B, 1), np.int32)
        self.pos = np.zeros((B,), np.int32)
        self.cursor = np.zeros((B,), np.int32)
        self.plen = np.zeros((B,), np.int32)
        self.remaining = np.zeros((B,), np.int32)
        self.live = np.zeros((B,), bool)
        self.temp = np.zeros((B,), np.float32)
        self.topk = np.zeros((B,), np.int32)
        self.prompt_buf = np.zeros((B, max_seq), np.int32)
        self.pf_target = np.zeros((B,), np.int32)   # tokens to chunk-prefill
        self.pf_done = np.zeros((B,), np.int32)
        self.slot_admit = np.full((B,), -1, np.int64)  # admission order
        self.slot_req: list[Request | None] = [None] * B
        self.generators: list[torch.Generator | None] = [None] * B
        self.queue: collections.deque[Request] = collections.deque()
        self.steps = 0
        self._admitted = 0
        self.stats = {"admissions": 0, "rejected": 0, "preemptions": 0,
                      "admit_cache_elems": 0, "peak_occupied": 0}
        self._cache_elems = sum(t.numel() for seg in self.cache
                                for t in seg.values())

    # ------------------------------------------------------------------
    def submit(self, req: Request):
        self.queue.append(req)

    def kv_stats(self) -> dict:
        """Accounting surface: engine counters + cache size."""
        out = dict(self.stats)
        out["kv_layout"] = self.kv_layout
        out["cache_elems"] = self._cache_elems
        return out

    def _dev(self, arr: np.ndarray) -> torch.Tensor:
        return torch.tensor(arr, device=self.device)

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
        free_slots = (s for s in range(self.B) if self.slot_req[s] is None)
        while self.queue:
            req = self.queue[0]
            prompt = np.asarray(req.prompt, np.int32)
            L = prompt.shape[0]
            if not 1 <= L < self.max_seq:
                # typed rejection: the engine keeps serving everyone else
                self.queue.popleft()
                self._reject(req, f"prompt length {L} outside "
                                  f"[1, max_seq={self.max_seq})")
                continue
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
            gen = None
            if req.temperature > 0:
                gen = torch.Generator(device=self.device)
                gen.manual_seed(request_seed(self.rng_seed, self._admitted))
            self.generators[slot] = gen
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
        for s in pending:
            if budget is not None and take and (len(take) + 1) * C > budget:
                break   # bound per-sync prefill work (at least one slot)
            take.append(s)
        tok = np.zeros((self.B, C), np.int32)
        start = np.zeros((self.B,), np.int32)
        active = np.zeros((self.B,), bool)
        for s in take:
            d = int(self.pf_done[s])
            tok[s] = self.prompt_buf[s, d:d + C]
            start[s] = d
            active[s] = True
        batch = {"tokens": self._dev(tok), "start": self._dev(start),
                 "active": self._dev(active)}
        lm.prefill_chunk(self.cfg, self.params, batch, self.cache)
        for s in take:
            self.pf_done[s] += C
            if self.pf_done[s] >= self.pf_target[s]:
                self._start_decode(s)

    def _retire(self, slot: int):
        self.slot_req[slot].done = True
        self.slot_req[slot] = None
        self.slot_admit[slot] = -1
        self.generators[slot] = None

    # ------------------------------------------------------------------
    def _host_step(self) -> int:
        """Per-step host sync (benchmark baseline)."""
        if not self.live.any():
            return 0
        batch = {"tokens": self._dev(self.tokens), "pos": self._dev(self.pos),
                 "active": self._dev(self.live)}
        logits, _ = lm.decode_step(self.cfg, self.params, batch, self.cache)
        self.steps += 1
        emitting = [s for s in range(self.B)
                    if self.slot_req[s] is not None and self.live[s]
                    and self.cursor[s] >= self.plen[s]]
        sampled = {}
        if emitting:
            toks = [sample(logits[s], self.generators[s],
                           temperature=float(self.temp[s]),
                           top_k=int(self.topk[s])) for s in emitting]
            sampled = dict(zip(emitting, torch.stack(toks).cpu().tolist(),
                               strict=True))
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
            tok = int(sampled[slot])
            req.output.append(tok)
            self.remaining[slot] -= 1
            self.tokens[slot, 0] = tok
            if self.remaining[slot] <= 0 or self.pos[slot] >= self.max_seq - 1:
                self.live[slot] = False
                self._retire(slot)
                finished += 1
        return finished

    def _device_state(self) -> dict:
        """The host's slot state, copied to the device for one sync."""
        names = ("tokens", "pos", "cursor", "plen", "remaining", "live",
                 "prompt_buf", "temp", "topk")
        st = {n: self._dev(getattr(self, n)) for n in names}
        # slots live at the sync's start draw every step (a finished slot's
        # draws are discarded), so a request's stream is its own
        st["gens"] = [g if self.live[s] else None
                      for s, g in enumerate(self.generators)]
        return st

    def _fused_steps(self, n_steps: int, st: dict):
        """Run ``n_steps`` decode steps with all slot state on the device;
        nothing in here waits for the device.  Returns the packed int32
        result tensor [sampled (n*B) | emit (n*B) | tokens | pos | cursor |
        remaining | live] for the caller's single device->host copy."""
        B, max_seq = self.B, self.max_seq
        tokens, pos, cursor, plen = (st["tokens"], st["pos"], st["cursor"],
                                     st["plen"])
        remaining, live, prompt_buf = (st["remaining"], st["live"],
                                       st["prompt_buf"])
        temp, topk, gens = st["temp"], st["topk"], st["gens"]
        b_idx = torch.arange(B, device=self.device)
        sampled_hist, emit_hist = [], []
        for _ in range(n_steps):
            batch = {"tokens": tokens, "pos": pos, "active": live}
            logits, _ = lm.decode_step(self.cfg, self.params, batch,
                                       self.cache)
            pos = pos + live.int()
            sampled = sample_batch(logits, gens, temp, topk)
            forcing = cursor < plen
            forced = prompt_buf[b_idx, cursor.clamp(0, max_seq - 1)]
            nxt = torch.where(live, torch.where(forcing, forced, sampled),
                              tokens[:, 0])
            cursor = cursor + (forcing & live).int()
            emit = live & ~forcing
            remaining = remaining - emit.int()
            done_now = emit & ((remaining <= 0) | (pos >= max_seq - 1))
            tokens = nxt[:, None]
            live = live & ~done_now
            sampled_hist.append(sampled)
            emit_hist.append(emit.int())
        return torch.cat([torch.stack(sampled_hist).flatten(),
                          torch.stack(emit_hist).flatten(), tokens[:, 0],
                          pos, cursor, remaining, live.int()])

    def _fused_sync(self) -> int:
        """One fused run of ``steps_per_sync`` steps + one host sync."""
        if not self.live.any():
            return 0
        n, B = self.steps_per_sync, self.B
        packed = self._fused_steps(n, self._device_state())
        packed = packed.cpu().numpy()                # the one sync
        self.steps += n
        sampled = packed[:n * B].reshape(n, B)
        emit = packed[n * B:2 * n * B].reshape(n, B).astype(bool)
        state = packed[2 * n * B:].reshape(5, B)
        for s in range(n):
            for slot in np.nonzero(emit[s])[0]:
                self.slot_req[slot].output.append(int(sampled[s, slot]))
        self.tokens = state[0][:, None].copy()
        self.pos, self.cursor, self.remaining = (state[1].copy(),
                                                 state[2].copy(),
                                                 state[3].copy())
        new_live = state[4].astype(bool)
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
