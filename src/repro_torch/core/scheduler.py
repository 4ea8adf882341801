"""Pure scheduler core — a deterministic state machine over typed events.

The paper's primary-server loop is split in three here (motivated by
JobPruner's policy/mechanism separation and by Gent & Kotthoff's case for
deterministic replay on unreliable virtualized hardware):

  * **core** (this module): ``SchedulerCore`` owns the task table, the
    ``MinHardSet`` pruning antichain and the client bookkeeping.  It
    consumes typed events — ``ClientMessage``, ``ClientJoined``,
    ``ClientLost``, ``Tick`` — and emits typed effects — ``Send``,
    ``CreateInstance``, ``TerminateInstance``.  It imports **no**
    transport or engine code: the same event stream always produces the
    same effect stream and the same ``snapshot()``, which is what makes
    backup takeover "replay the forwarded stream into the same core".
  * **policies** (``repro_torch.core.policy``): assignment order, fleet
    scaling and budget enforcement are strategy objects the core
    consults; they are rebuilt deterministically from the config.
  * **shell** (``repro_torch.core.server``): feeds events from real channels
    and executes effects against a compute engine.

``snapshot()``/``restore()`` replace the old ad-hoc pickle blob with a
structured, complete state capture (including per-client assignment
tables and retry counters, which the old blob silently dropped).
"""
from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import Any

from repro_torch.core import policy as _policy
from repro_torch.core.hardness import Hardness, MinHardSet
from repro_torch.core.messages import Message, MsgType
from repro_torch.core.results import EventLog

# task status values
PENDING, ASSIGNED, DONE, TIMED_OUT, PRUNED, FAILED_POOL = (
    "pending", "assigned", "done", "timed_out", "pruned", "failed_pool")


@dataclass
class ServerConfig:
    min_group_size: int = 0
    max_task_attempts: int = 3      # poison-task cap (beyond-paper)
    use_backup: bool = False
    max_clients: int = 4
    workers_hint: int = 1              # informational; pools size themselves
    health_update_limit: float = 10.0
    instance_max_non_active_time: float = 30.0
    create_backoff_init: float = 0.5
    create_backoff_max: float = 30.0
    health_interval: float = 1.0
    out_dir: str | None = None
    # policy layer (see repro_torch.core.policy)
    assign_policy: str = "hardness"    # "hardness" | "backfill"
    assign_batch: int = 4              # batch size for "backfill"
    scale_policy: str = "fixed"        # "fixed" | "demand"
    idle_timeout_s: float = 5.0        # demand scale: idle-downscale cutoff
    budget_cap: float | None = None    # stop scaling when cap is threatened
    budget_reserve_s: float = 30.0     # projection horizon for the cap
    create_batch: int = 1              # max CreateInstance effects per tick
    #   (fleet-scale boot: one create per tick serializes a 10k fleet)
    name_prefix: str = ""              # instance-name namespace; sharded
    #   runs give each shard its own prefix so names are globally unique
    # partition hardening (see repro_torch.core.policy.LivenessPolicy):
    partition_grace_s: float = 0.0     # extra liveness allowance while a
    #   client's link is reported partitioned (LinkLost) — a partitioned-
    #   but-alive client is not declared dead until limit + grace
    regrant_timeout_s: float = 6.0     # re-send an unacknowledged GRANT on
    #   the client's next request after this long (recovers grants lost to
    #   one-way server->client link loss; acked within ~2 RTT normally)


@dataclass
class ClientInfo:
    """Per-client record.  The core reads/writes everything except
    ``endpoint``, which the shell stores here for effect execution and
    which is deliberately excluded from snapshots."""

    name: str
    endpoint: Any
    last_health: float
    srv_seq: int = 0                    # per-client logical send counter
    last_client_seq: int = -1           # highest processed client msg seq
    assigned: dict = field(default_factory=dict)   # tid -> task
    capacity: int = 0                   # observed peak worker demand
    last_active: float = 0.0            # last task-lifecycle activity
    suspected_at: float | None = None   # LinkLost time (None = link fine)
    unacked: dict = field(default_factory=dict)    # tid -> grant time, not
    #   yet acknowledged (client's "granted"/"started" LOG or RESULT)


# ---------------------------------------------------------------------------
# typed events (inputs)
# ---------------------------------------------------------------------------
@dataclass
class ClientMessage:
    msg: Message
    now: float


@dataclass
class ClientJoined:
    name: str
    now: float


@dataclass
class ClientLost:
    name: str
    now: float
    reassign: bool = True


@dataclass
class LinkLost:
    """The transport reports the link to a client as (partially) down —
    the client may be partitioned-but-alive, so liveness gets
    ``partition_grace_s`` more allowance before declaring it dead."""

    name: str
    now: float


@dataclass
class LinkHealed:
    """The client's link recovered; normal liveness allowance resumes."""

    name: str
    now: float


@dataclass
class Tick:
    """Periodic decision point.  Everything the core may not observe
    directly (engine pending counts, shell backoff state, metered cost)
    arrives as event payload, so replaying ticks is deterministic.

    ``pending_instances`` counts every booting instance (the paper's
    fixed-fleet gate counts backups too); ``pending_clients`` counts
    only client-kind instances (worker capacity, used by demand
    scaling)."""

    now: float
    pending_instances: int = 0
    pending_clients: int = 0
    can_create: bool = True
    accrued_cost: float = 0.0
    burn_rate: float = 0.0
    client_rate: float = 1.0


# ---------------------------------------------------------------------------
# typed effects (outputs)
# ---------------------------------------------------------------------------
@dataclass(slots=True)
class Send:
    client: str
    mtype: MsgType
    body: Any = None
    srv_seq: int | None = None          # per-client counter (normal sends)
    ctrl_seq: int | None = None         # control-plane counter (broadcasts)


@dataclass
class CreateInstance:
    kind: str
    name: str


@dataclass
class TerminateInstance:
    name: str
    reason: str = ""


class SchedulerCore:
    """Deterministic scheduling state machine (see module docstring)."""

    def __init__(self, tasks, config: ServerConfig | None = None,
                 events: EventLog | None = None):
        self.config = config or ServerConfig()
        order = sorted(range(len(tasks)),
                       key=lambda i: tuple(tasks[i].hardness().values))
        self.tasks = [tasks[i] for i in order]        # hardness-sorted
        self.original_index = order                    # sorted pos -> orig pos
        self.status = [PENDING] * len(tasks)
        self.next_ptr = 0
        self.tasks_from_failed: collections.deque[int] = collections.deque()
        self.min_hard = MinHardSet()
        self.results: dict[int, tuple] = {}
        self.attempts: dict[int, int] = {}
        self.task_spans: dict[int, tuple] = {}   # tid -> (client, t0, t1)
        self._task_started: dict[int, tuple] = {}  # tid -> (client, t0)
        self.clients: dict[str, ClientInfo] = {}
        self.events = events or EventLog()
        self.done = False
        self._client_counter = 0
        self._budget_hit = False
        self._last_liveness = -1e18
        self.ctrl_seq = 0           # control-plane broadcast counter
        # Logical scheduling-event counters (benchmark observability).
        # Incremented per *item*, never per batch/message, so the primary
        # (batched wakes) and the backup (one-at-a-time FORWARD replay)
        # count identically and snapshots stay replay-equivalent:
        #   granted            task grants issued (incl. re-grants)
        #   acked              client message seqs acknowledged
        #   results            RESULT reports processed
        #   reports            REPORT_HARD_TASK reports processed
        #   log_entries        client LOG records (batched tids counted)
        #   domino_deliveries  hardness x client frontier deliveries
        self.stats = {"granted": 0, "acked": 0, "results": 0,
                      "reports": 0, "log_entries": 0,
                      "domino_deliveries": 0}
        self._build_policies()
        self._init_derived()

    def _build_policies(self):
        self.assign_policy = _policy.make_assign_policy(self.config)
        self.scale_policy = _policy.make_scale_policy(self.config)
        self.budget_policy = _policy.make_budget_policy(self.config)
        self.liveness_policy = _policy.make_liveness_policy(self.config)

    def _init_derived(self):
        """Derived state, rebuilt from ``status`` on both the ``__init__``
        and ``restore`` paths (like ``_build_policies``): live-task
        counters that make ``has_assignable``/``count_assignable``/
        ``_check_done`` O(1) instead of O(tasks).  Exact because every
        status write goes through ``_set_status`` and eager domino pruning
        (``_prune_dominated``) guarantees no PENDING/FAILED_POOL task is
        ever disqualified."""
        tally = collections.Counter(self.status)
        self._n_pending = tally[PENDING]
        self._n_failed = tally[FAILED_POOL]
        self._n_assigned = tally[ASSIGNED]

    def _set_status(self, tid: int, new: str):
        """Single funnel for task-status writes, keeping the live-task
        counters incrementally exact."""
        old = self.status[tid]
        if old == new:
            return
        self.status[tid] = new
        if old == PENDING:
            self._n_pending -= 1
        elif old == FAILED_POOL:
            self._n_failed -= 1
        elif old == ASSIGNED:
            self._n_assigned -= 1
        if new == PENDING:
            self._n_pending += 1
        elif new == FAILED_POOL:
            self._n_failed += 1
        elif new == ASSIGNED:
            self._n_assigned += 1

    # ------------------------------------------------------------------
    # event dispatch (replay entry point)
    # ------------------------------------------------------------------
    def handle(self, ev) -> list:
        if isinstance(ev, ClientMessage):
            return self.on_message(ev.msg, ev.now)
        if isinstance(ev, ClientJoined):
            self.client_joined(ev.name, ev.now)
            return []
        if isinstance(ev, ClientLost):
            return self.drop_client(ev.name, ev.now, reassign=ev.reassign)
        if isinstance(ev, LinkLost):
            return self.on_link_lost(ev.name, ev.now)
        if isinstance(ev, LinkHealed):
            return self.on_link_healed(ev.name, ev.now)
        if isinstance(ev, Tick):
            return self.on_tick(ev)
        raise TypeError(f"unknown scheduler event: {ev!r}")

    def handle_batch(self, events: list) -> list:
        """Dispatch a burst of events as one wake, coalescing per-client
        ACK effects into a single ``Send({"seqs": [...]})`` each and
        per-client domino broadcasts into one ``Send({"hardnesses":
        [...]})`` each, so effect cost is per-wake, not per-task.  When
        the same wake also grants to that client (or answers
        NO_FURTHER_TASKS), the ACK batch piggybacks on that message as
        ``body["acks"]`` and the separate ACK send is dropped.

        Safe to batch because both planes are *counterless* (no
        srv_seq/ctrl_seq — idempotent, order-free: outbox pops for ACKs,
        frontier unions for dominoes): the backup mirror replays
        FORWARDed messages one at a time and emits unbatched
        ``{"seq": n}`` / ``{"hardness": (...)}`` forms, and clients
        accept both shapes without any dedup-counter divergence."""
        if len(events) == 1:
            return self.handle(events[0])
        effects: list = []
        acks: dict[str, Send] = {}
        dominoes: dict[str, list] = {}
        carriers: dict[str, Send] = {}   # per-client ACK piggyback target
        for ev in events:
            for eff in self.handle(ev):
                if isinstance(eff, Send):
                    mt = eff.mtype
                    if mt is MsgType.ACK:
                        prev = acks.get(eff.client)
                        if prev is None:
                            # first ACK for this client keeps its place in
                            # the effect stream and becomes the carrier
                            eff.body = {"seqs": [eff.body["seq"]]}
                            acks[eff.client] = eff
                            effects.append(eff)
                        else:
                            prev.body["seqs"].append(eff.body["seq"])
                        continue
                    if mt is MsgType.APPLY_DOMINO_EFFECT:
                        hs = dominoes.get(eff.client)
                        if hs is None:
                            eff.body = {"hardnesses": [eff.body["hardness"]]}
                            dominoes[eff.client] = eff.body["hardnesses"]
                            effects.append(eff)
                        else:
                            hs.append(eff.body["hardness"])
                        continue
                    if mt is MsgType.GRANT_TASKS \
                            or mt is MsgType.NO_FURTHER_TASKS:
                        carriers.setdefault(eff.client, eff)
                effects.append(eff)
        # piggyback: a client that got both an ACK batch and a grant (or
        # no-further) this wake receives the acked seqs inside that
        # message instead of a separate ACK — one less message and one
        # less client wake.  Safe: acks are idempotent outbox pops, and
        # the backup's mirror (which replays unbatched and never sees the
        # piggyback) is deduped away by the carrier's srv_seq; a lost
        # carrier just means the outbox entries retry and re-ACK.
        dropped = None
        for cname, ack in acks.items():
            car = carriers.get(cname)
            if car is not None:
                body = car.body
                if body is None:
                    body = car.body = {}
                body["acks"] = ack.body["seqs"]
                if dropped is None:
                    dropped = set()
                dropped.add(id(ack))
        if dropped:
            effects = [e for e in effects if id(e) not in dropped]
        return effects

    # ------------------------------------------------------------------
    # assignment helpers (consumed by AssignPolicy implementations)
    # ------------------------------------------------------------------
    def take_failed(self):
        """Pop the next re-assignable task from the failed pool, marking
        disqualified entries PRUNED on the way.  None when exhausted."""
        while self.tasks_from_failed:
            tid = self.tasks_from_failed.popleft()
            if self.status[tid] != FAILED_POOL:
                continue
            if self.min_hard.disqualifies(self.tasks[tid].hardness()):
                self._set_status(tid, PRUNED)
                continue
            return tid, self.tasks[tid]
        return None

    def take_next(self):
        """Advance the hardness-order pointer to the next grantable task,
        marking disqualified entries PRUNED on the way."""
        while self.next_ptr < len(self.tasks):
            tid = self.next_ptr
            self.next_ptr += 1
            if self.status[tid] != PENDING:
                continue
            if self.min_hard.disqualifies(self.tasks[tid].hardness()):
                self._set_status(tid, PRUNED)
                continue
            return tid, self.tasks[tid]
        return None

    def has_assignable(self) -> bool:
        """O(1): eager domino pruning (``_prune_dominated``) keeps the
        invariant that no PENDING or FAILED_POOL task is disqualified, so
        the prune-aware live counters answer directly — no scan over
        ``range(next_ptr, len(tasks))`` (the old O(tasks)-per-tick cost
        that capped the fleet size)."""
        return self._n_failed > 0 or self._n_pending > 0

    def count_assignable(self, bound: int) -> int:
        """Number of currently grantable tasks, counted up to ``bound``.
        Pure O(1) query on the prune-aware counters: every PENDING /
        FAILED_POOL task is grantable (see ``has_assignable``)."""
        return min(bound, self._n_failed + self._n_pending)

    # ------------------------------------------------------------------
    # client lifecycle
    # ------------------------------------------------------------------
    def client_joined(self, name: str, now: float,
                      endpoint=None) -> ClientInfo:
        ci = ClientInfo(name, endpoint, now, last_active=now)
        self.clients[name] = ci
        self.events.ensure(name)
        return ci

    def register_client(self, name: str, srv_seq: int, last_client_seq: int,
                        now: float, endpoint=None) -> ClientInfo:
        """Backup-side registration from a NEW_CLIENT notification."""
        ci = ClientInfo(name, endpoint, now, srv_seq=srv_seq,
                        last_client_seq=last_client_seq, last_active=now)
        self.clients[name] = ci
        self.events.ensure(name)
        return ci

    def forget_client(self, name: str) -> None:
        """Backup-side removal from a CLIENT_TERMINATED notification."""
        self.clients.pop(name, None)

    # ------------------------------------------------------------------
    # link-state events (partition hardening)
    # ------------------------------------------------------------------
    def on_link_lost(self, cname: str, now: float) -> list:
        ci = self.clients.get(cname)
        if ci is not None and ci.suspected_at is None:
            ci.suspected_at = now
            self.events.log(cname, now, "LOG", {"event": "link_lost"})
        return []

    def on_link_healed(self, cname: str, now: float) -> list:
        ci = self.clients.get(cname)
        if ci is not None and ci.suspected_at is not None:
            ci.suspected_at = None
            # silence during the partition is explained by the partition:
            # restart the health window instead of letting the allowance
            # collapse below the accumulated silence the moment it heals
            ci.last_health = max(ci.last_health, now)
            self.events.log(cname, now, "LOG", {"event": "link_healed"})
        return []

    def drop_client(self, cname: str, now: float, reassign: bool,
                    reason: str = "unhealthy") -> list:
        """Remove a client; optionally requeue its assigned tasks.  Emits
        the TerminateInstance effect for the shell to execute."""
        ci = self.clients.pop(cname, None)
        if ci is None:
            return []
        if reassign:
            for tid in ci.assigned:
                if self.status[tid] == ASSIGNED:
                    self._set_status(tid, FAILED_POOL)
                    self.tasks_from_failed.append(tid)
        return [TerminateInstance(cname, reason)]

    def alloc_instance_name(self, prefix: str) -> str:
        name = f"{self.config.name_prefix}{prefix}-{self._client_counter}"
        self._client_counter += 1
        return name

    # ------------------------------------------------------------------
    # message handling (paper §c)
    # ------------------------------------------------------------------
    def _send(self, ci: ClientInfo, mtype, body=None) -> Send:
        eff = Send(ci.name, mtype, body, srv_seq=ci.srv_seq)
        ci.srv_seq += 1
        return eff

    def control_broadcast(self, mtype, body=None) -> list:
        """STOP/RESUME-style message to every known client.  One logical
        broadcast consumes one *control-plane* number shared by all
        recipients — per-client srv_seq is untouched, so a backup that
        missed the broadcast still agrees with the primary on every
        client's srv_seq (the backup mirrors the consumption by replaying
        the same broadcast from the primary's BROADCAST notice)."""
        seq = self.ctrl_seq
        self.ctrl_seq += 1
        return [Send(ci.name, mtype, body, ctrl_seq=seq)
                for ci in self.clients.values()]

    def on_message(self, msg: Message, now: float) -> list:
        cname = msg.sender
        ci = self.clients.get(cname)
        if ci is None:
            return []
        if msg.seq > ci.last_client_seq:
            ci.last_client_seq = msg.seq
        t = msg.type
        eff: list = []
        if t == MsgType.HEALTH_UPDATE:
            ci.last_health = now
        elif t == MsgType.REQUEST_TASKS:
            n = msg.body["n"]
            ci.capacity = max(ci.capacity, n + len(ci.assigned))
            # Re-grant assignments whose GRANT was never acknowledged and
            # has aged past the regrant timeout: a one-way server->client
            # link loss swallows grants silently, leaving tasks ASSIGNED
            # to a client that never received them — without the re-grant
            # those tasks are stranded forever (the client keeps
            # heartbeating, so liveness never requeues them).
            regrant = [(tid, ci.assigned[tid]) for tid, t0 in ci.unacked.items()
                       if now - t0 > self.config.regrant_timeout_s
                       and tid in ci.assigned]
            granted = self.assign_policy.select(self, n)
            if granted or regrant:
                ci.last_active = now
                self.stats["granted"] += len(regrant) + len(granted)
                for tid, task in granted:
                    self._set_status(tid, ASSIGNED)
                    ci.assigned[tid] = task
                for tid, _ in regrant + granted:
                    ci.unacked[tid] = now
                # echo the request size so a partial grant still settles the
                # client's whole outstanding count (see Client._act)
                eff.append(self._send(ci, MsgType.GRANT_TASKS,
                                      {"tasks": regrant + granted,
                                       "requested": n}))
            else:
                eff.append(self._send(ci, MsgType.NO_FURTHER_TASKS))
        elif t == MsgType.RESULT:
            # state-bearing reports are ACKed (by client message seq) so
            # the client can drop them from its at-least-once outbox —
            # processing below is idempotent, so duplicates just re-ACK.
            # ACKs are counterless (no srv_seq): order-free idempotent
            # pops need no dedup, and keeping them off the per-client
            # counter lets handle_batch coalesce them per wake without
            # desyncing the backup mirror's srv_seq state.
            eff.append(Send(ci.name, MsgType.ACK, {"seq": msg.seq}))
            self.stats["acked"] += 1
            # clients batch a wake's completions into one message
            # ({"results": [[tid, result], ...]}); the single-tid form is
            # kept for older traces and per-task senders
            body = msg.body
            items = body.get("results") \
                or ((body["tid"], body["result"]),)
            ci.last_active = now
            # the "done" lifecycle log entry is synthesized here rather
            # than shipped as a separate client LOG message — the RESULT
            # batch already names exactly the completed tids
            self.events.log(cname, now, "LOG",
                            {"event": "done",
                             "tids": [tid for tid, _ in items]})
            self.stats["log_entries"] += len(items)
            for tid, result in items:
                self.stats["results"] += 1
                ci.unacked.pop(tid, None)
                # Only ASSIGNED tasks may complete: a racy late result for
                # a task already TIMED_OUT/PRUNED (domino effect) or
                # already DONE (duplicate copy after takeover) must not
                # corrupt the table.
                started = self._task_started.pop(tid, None)
                if self.status[tid] == ASSIGNED:
                    self.results[tid] = tuple(result)
                    self._set_status(tid, DONE)
                    t0 = started[1] if started is not None else now
                    self.task_spans[tid] = (cname, t0, now)
                ci.assigned.pop(tid, None)
        elif t == MsgType.REPORT_HARD_TASK:
            eff.append(Send(ci.name, MsgType.ACK, {"seq": msg.seq}))
            self.stats["acked"] += 1
            # clients batch a timeout sweep into one message
            # ({"reports": [[tid, hardness], ...]}); single-tid form kept
            # for older traces and per-task senders
            body = msg.body
            items = body.get("reports") \
                or ((body["tid"], body["hardness"]),)
            ci.last_active = now
            for tid, hv in items:
                self.stats["reports"] += 1
                h = Hardness(tuple(hv))
                self._set_status(tid, TIMED_OUT)
                ci.assigned.pop(tid, None)
                ci.unacked.pop(tid, None)
                self._task_started.pop(tid, None)
                if self._absorb_hardness(h):
                    # broadcast only when the frontier actually grew: a
                    # dominated report h (some stored m <= h) prunes
                    # nothing new — by transitivity every task T >= h is
                    # also >= m and m's earlier broadcast already covered
                    # it (FIFO wires guarantee clients saw it).  At fleet
                    # scale dominated reports are the common case, so
                    # skipping the O(clients) fan-out here is what keeps
                    # timeouts cheap.
                    # Counterless like ACKs (no srv_seq/ctrl_seq):
                    # applying a hardness to a client's local queue is an
                    # idempotent, order-free frontier union, so no dedup
                    # counter is needed and handle_batch may coalesce a
                    # wake's broadcasts into one {"hardnesses": [...]}
                    # message per client.
                    self.stats["domino_deliveries"] += len(self.clients)
                    for other in self.clients.values():
                        eff.append(Send(other.name,
                                        MsgType.APPLY_DOMINO_EFFECT,
                                        {"hardness": h.values}))
        elif t == MsgType.LOG:
            self.events.log(cname, now, "LOG", msg.body)
            body = msg.body or {}
            ev_name = body.get("event")
            if ev_name == "lifecycle":
                # per-wake combined form: grant receipts + worker starts
                # in one wire message ({"granted": [...], "started": [...]})
                granted = body.get("granted") or ()
                started = body.get("started") or ()
                self.stats["log_entries"] += len(granted) + len(started)
                for tid in granted:
                    ci.unacked.pop(tid, None)
                for tid in started:
                    self._task_started[tid] = (cname, now)
                    ci.unacked.pop(tid, None)
            else:
                self.stats["log_entries"] += len(body.get("tids") or ()) or 1
                if ev_name == "started":
                    # legacy per-event form ({"tids": [...]} batched, or
                    # single-tid from older traces)
                    tids = body.get("tids") if "tids" in body else (
                        (body["tid"],) if "tid" in body else ())
                    for tid in tids:
                        self._task_started[tid] = (cname, now)
                        ci.unacked.pop(tid, None)
                elif ev_name == "granted":
                    # the client acknowledged receipt of these grants
                    for tid in body.get("tids", ()):
                        ci.unacked.pop(tid, None)
        elif t == MsgType.EXCEPTION:
            eff.append(Send(ci.name, MsgType.ACK, {"seq": msg.seq}))
            self.stats["acked"] += 1
            self.events.log(cname, now, "EXCEPTION", msg.body)
            tid = (msg.body or {}).get("tid")
            if tid is not None and self.status[tid] == ASSIGNED:
                ci.assigned.pop(tid, None)
                ci.unacked.pop(tid, None)
                ci.last_active = now
                self._task_started.pop(tid, None)
                self.attempts[tid] = self.attempts.get(tid, 1) + 1
                if self.attempts[tid] > self.config.max_task_attempts:
                    # poison task: stop retrying (would livelock otherwise)
                    self._set_status(tid, PRUNED)
                else:
                    # worker crash: send the task back to the pool
                    self._set_status(tid, FAILED_POOL)
                    self.tasks_from_failed.append(tid)
        elif t == MsgType.BYE:
            self.events.log(cname, now, "LOG", {"event": "bye"})
            # reassign=True is a no-op in the healthy flow (a client only
            # says BYE with an empty table) but saves any assignment a
            # desynced takeover still believes this client holds
            eff += self.drop_client(cname, now, reassign=True, reason="bye")
        return eff

    def _absorb_hardness(self, h: Hardness) -> bool:
        """Record a timed-out hardness; when it grows the pruning frontier
        apply the domino rule eagerly to assigned AND live (pending /
        failed-pool) tasks.  Returns True iff the frontier grew (callers
        broadcast APPLY_DOMINO_EFFECT only then).  Eager pruning is what
        keeps the live-task counters prune-aware: after this returns, no
        PENDING/FAILED_POOL task is disqualified."""
        if not self.min_hard.add(h):
            return False
        self._apply_domino(h)
        self._prune_dominated(h)
        return True

    def gossip_hardness(self, hs) -> tuple[list, list]:
        """Cross-shard domino (``core.shard``): absorb a batch of
        hardnesses observed by other shards' schedulers.  The client
        notification is counterless (no srv_seq/ctrl_seq — frontier
        unions are idempotent and order-free, like the ACK plane), so
        one gossip pump costs one message per client no matter how many
        frontier elements it delivered, and no counter state can diverge
        between primary and backup (the PR-4 bug class).  Returns
        ``(retained_values, effects)``; the shell replicates the retained
        values to the backup via the BROADCAST notice — gossip never
        arrives as a FORWARDable client message, so that notice is its
        only path into the mirror."""
        retained = [h.values for h in hs if self._absorb_hardness(h)]
        if not retained:
            return [], []
        self.stats["domino_deliveries"] += len(retained) * len(self.clients)
        return retained, [
            Send(ci.name, MsgType.APPLY_DOMINO_EFFECT,
                 {"hardnesses": list(retained)})
            for ci in self.clients.values()]

    def _apply_domino(self, h: Hardness):
        """Mark all assigned tasks dominated by h as pruned (their
        clients are terminating them; results will never arrive)."""
        for ci in self.clients.values():
            for tid in list(ci.assigned):
                if self.tasks[tid].hardness().geq(h):
                    if self.status[tid] == ASSIGNED:
                        self._set_status(tid, PRUNED)
                    ci.assigned.pop(tid, None)
                    ci.unacked.pop(tid, None)
                    self._task_started.pop(tid, None)

    def _prune_dominated(self, h: Hardness):
        """Eagerly prune live tasks dominated by a frontier-growing h.
        The old lazy scheme left them PENDING/FAILED_POOL until a grant
        scan or the completion sweep touched them, which forced every
        has_assignable/count_assignable call to re-check disqualification
        across the whole table.  One O(live) sweep per *retained* frontier
        element (rare) buys O(1) for every hot-path query."""
        for tid in range(self.next_ptr, len(self.tasks)):
            if self.status[tid] == PENDING \
                    and self.tasks[tid].hardness().geq(h):
                self._set_status(tid, PRUNED)
        for tid in self.tasks_from_failed:
            if self.status[tid] == FAILED_POOL \
                    and self.tasks[tid].hardness().geq(h):
                self._set_status(tid, PRUNED)

    # ------------------------------------------------------------------
    # periodic decisions (scaling, liveness, completion)
    # ------------------------------------------------------------------
    def on_tick(self, tick: Tick) -> list:
        eff: list = []
        # 1. fleet scaling (policy + budget), before liveness drops so the
        #    max_clients count still includes unhealthy clients — matches
        #    the paper loop's create-then-terminate order
        decision = self.scale_policy.decide(self, tick)
        if decision.create:
            if self.budget_policy is not None \
                    and not self.budget_policy.allow_create(self, tick):
                if not self._budget_hit:
                    self._budget_hit = True
                    self.events.ensure("server")
                    self.events.log(
                        "server", tick.now, "LOG",
                        {"event": "budget_cap",
                         "cap": self.budget_policy.cap,
                         "accrued": tick.accrued_cost})
            else:
                # decision.create may be > 1 (config.create_batch): one
                # tick boots a whole batch instead of serializing fleet
                # bring-up at one instance per tick
                for _ in range(decision.create):
                    eff.append(CreateInstance(
                        "client", self.alloc_instance_name("client")))
        # 2. terminate unhealthy clients (+ requeue their tasks).  Health
        #    state only changes at heartbeat granularity, so the O(clients)
        #    sweep runs at health_interval cadence, not every tick — with
        #    ready-set polling this keeps a quiet tick O(due work)
        if tick.now - self._last_liveness >= self.config.health_interval:
            self._last_liveness = tick.now
            for cname, ci in list(self.clients.items()):
                # a client whose link is reported partitioned (LinkLost)
                # gets partition_grace_s on top of the health limit — a
                # partitioned-but-alive client must not be declared dead
                # (and its tasks double-assigned) for a healable link
                if tick.now - ci.last_health > \
                        self.liveness_policy.allowance(ci):
                    self.events.log(cname, tick.now, "LOG",
                                    {"event": "unhealthy"})
                    eff += self.drop_client(cname, tick.now, reassign=True,
                                            reason="unhealthy")
        # 3. proactive idle downscale (policy may return names of clients
        #    with no assigned work; re-check so nothing is ever stranded)
        for cname in decision.terminate:
            ci = self.clients.get(cname)
            if ci is not None and not ci.assigned:
                self.events.log(cname, tick.now, "LOG",
                                {"event": "idle_downscale"})
                eff += self.drop_client(cname, tick.now, reassign=False,
                                        reason="idle")
        # 4. completion
        self._check_done()
        return eff

    def _check_done(self):
        if self.done:
            return
        # O(1) per tick on the live counters (was an O(tasks) any()-scan)
        if self._n_assigned > 0 or self.has_assignable():
            return
        # no assignable work, nothing in flight: sweep survivors (the
        # counters say there are none, but the sweep stays as a guard for
        # snapshots predating eager pruning); runs at most once
        for tid, s in enumerate(self.status):
            if s in (PENDING, FAILED_POOL):
                self._set_status(tid, PRUNED)
        self.done = True

    # ------------------------------------------------------------------
    # structured snapshot/restore (complete state; replay-equivalent)
    # ------------------------------------------------------------------
    def snapshot(self) -> dict:
        return {
            "config": self.config,
            "tasks": self.tasks,
            "original_index": list(self.original_index),
            "status": list(self.status),
            "next_ptr": self.next_ptr,
            "tasks_from_failed": list(self.tasks_from_failed),
            "min_hard": self.min_hard.snapshot(),
            "results": dict(self.results),
            "attempts": dict(self.attempts),
            "task_spans": dict(self.task_spans),
            "task_started": dict(self._task_started),
            "clients": {
                c: {"srv_seq": ci.srv_seq,
                    "last_client_seq": ci.last_client_seq,
                    "assigned": sorted(ci.assigned),
                    "last_health": ci.last_health,
                    "capacity": ci.capacity,
                    "last_active": ci.last_active,
                    "suspected_at": ci.suspected_at,
                    "unacked": dict(ci.unacked)}
                for c, ci in self.clients.items()},
            "events": self.events.snapshot(),
            "done": self.done,
            "client_counter": self._client_counter,
            "budget_hit": self._budget_hit,
            "last_liveness": self._last_liveness,
            "ctrl_seq": self.ctrl_seq,
            "stats": dict(self.stats),
        }

    @classmethod
    def restore(cls, snap: dict) -> SchedulerCore:
        core = cls.__new__(cls)
        core.config = snap["config"]
        core.tasks = snap["tasks"]
        core.original_index = list(snap["original_index"])
        core.status = list(snap["status"])
        core.next_ptr = snap["next_ptr"]
        core.tasks_from_failed = collections.deque(snap["tasks_from_failed"])
        core.min_hard = MinHardSet()
        core.min_hard.restore(snap["min_hard"])
        core.results = dict(snap["results"])
        core.attempts = dict(snap["attempts"])
        core.task_spans = dict(snap["task_spans"])
        core._task_started = dict(snap["task_started"])
        core.clients = {}
        for cname, st in snap["clients"].items():
            core.clients[cname] = ClientInfo(
                cname, None, st["last_health"], srv_seq=st["srv_seq"],
                last_client_seq=st["last_client_seq"],
                assigned={tid: core.tasks[tid] for tid in st["assigned"]},
                capacity=st["capacity"], last_active=st["last_active"],
                suspected_at=st.get("suspected_at"),
                unacked=dict(st.get("unacked", {})))
        core.events = EventLog()
        core.events.restore(snap["events"])
        core.done = snap["done"]
        core._client_counter = snap["client_counter"]
        core._budget_hit = snap["budget_hit"]
        core._last_liveness = snap["last_liveness"]
        core.ctrl_seq = snap.get("ctrl_seq", 0)
        core.stats = dict(snap.get("stats") or {
            "granted": 0, "acked": 0, "results": 0, "reports": 0,
            "log_entries": 0, "domino_deliveries": 0})
        core._build_policies()
        core._init_derived()
        return core
