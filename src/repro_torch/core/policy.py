"""Pluggable scheduling policies + cost accounting (pure policy layer).

JobPruner (Silva et al., 2018) treats pruning/scaling decisions as policy
choices worth swapping independently of the mechanism that executes them;
this module is that seam for ExpoCloud.  Three orthogonal policy families
are consulted by ``SchedulerCore``:

  * ``AssignPolicy``  — which tasks a client's REQUEST_TASKS is granted
    (hardness-order FIFO, the paper's rule, or a batch/backfill variant
    that keeps contiguous hardness batches on one client),
  * ``ScalePolicy``   — when to create a new client instance and when to
    proactively terminate an idle one (fixed fleet = the paper's rule;
    demand scale = create only while remaining work exceeds committed
    capacity, downscale idle clients once the tail no longer fills them),
  * ``BudgetPolicy``  — a user-set cost cap: scaling stops when the
    projected spend threatens the cap (the paper's "budget-effective"
    claim made enforceable).

Policies are deterministic strategy objects that see only the core's
public helpers and the typed ``Tick`` event — never transports or
engines — so a scheduling run replays bit-identically from an event log.

``CostMeter`` is the end-to-end cost account: engines report billing
records (per-instance start/end plus a $/instance-second rate — exact in
the simulator, wall-clock proxies on LocalEngine/GCE), the server shell
syncs them into the meter, and the meter's summary lands in the results
table and the benchmark artifacts.
"""
from __future__ import annotations

from dataclasses import dataclass, field


# ---------------------------------------------------------------------------
# task assignment
# ---------------------------------------------------------------------------
class AssignPolicy:
    """Chooses which tasks satisfy a client's request for ``n`` tasks.

    Implementations pull from the core via ``core.take_failed()`` /
    ``core.take_next()`` (both honour MinHardSet pruning and mark
    disqualified tasks PRUNED as they are encountered)."""

    def select(self, core, n: int) -> list:
        raise NotImplementedError


class HardnessOrderPolicy(AssignPolicy):
    """The paper's rule: re-assign tasks from failed clients first, then
    grant in non-decreasing hardness order (FIFO over the sorted table)."""

    def select(self, core, n: int) -> list:
        out = []
        while len(out) < n:
            nxt = core.take_failed()
            if nxt is None:
                break
            out.append(nxt)
        while len(out) < n:
            nxt = core.take_next()
            if nxt is None:
                break
            out.append(nxt)
        return out


@dataclass
class BatchBackfillPolicy(AssignPolicy):
    """Hardness-order with batch alignment: a single grant never crosses a
    ``batch``-boundary of the sorted task table, so consecutive-hardness
    batches (e.g. one group's instances) tend to land on one client and a
    freed client backfills the next whole batch.  Failed-pool tasks are
    still re-assigned with priority, unbatched."""

    batch: int = 4

    def select(self, core, n: int) -> list:
        out = []
        while len(out) < n:
            nxt = core.take_failed()
            if nxt is None:
                break
            out.append(nxt)
        # queue grants stay within one batch of the sorted table; batches
        # are index ranges, so a task from a different batch is handed
        # back (take_next never mutates a grantable task, resetting the
        # pointer to its tid restores the queue exactly)
        first_batch = None
        while len(out) < n:
            nxt = core.take_next()
            if nxt is None:
                break
            tid = nxt[0]
            if first_batch is None:
                first_batch = tid // self.batch
            elif tid // self.batch != first_batch:
                core.next_ptr = tid
                break
            out.append(nxt)
        return out


# ---------------------------------------------------------------------------
# fleet scaling
# ---------------------------------------------------------------------------
@dataclass
class ScaleDecision:
    create: int = 0                     # client instances to request; may
    #   exceed 1 up to config.create_batch (fleet-scale batched boot)
    terminate: list = field(default_factory=list)   # idle client names


class ScalePolicy:
    def decide(self, core, tick) -> ScaleDecision:
        raise NotImplementedError


class FixedFleetPolicy(ScalePolicy):
    """The paper's rule: create while any task is assignable and the fleet
    (alive + booting) is below max_clients; never downscale proactively
    (clients self-terminate via NO_FURTHER_TASKS -> BYE).  With
    ``config.create_batch`` > 1 a single tick requests a whole batch —
    capped by fleet room and by the number of assignable tasks, so a
    short tail never boots instances with nothing to do."""

    def decide(self, core, tick) -> ScaleDecision:
        create = 0
        room = core.config.max_clients \
            - len(core.clients) - tick.pending_instances
        if tick.can_create and room > 0 and core.has_assignable():
            batch = min(room, max(1, getattr(core.config, "create_batch", 1)))
            create = core.count_assignable(batch) if batch > 1 else 1
        return ScaleDecision(create=create)


@dataclass
class DemandScalePolicy(ScalePolicy):
    """Demand-aware scaling: create a client only while the number of
    grantable tasks exceeds the committed worker capacity (alive clients'
    observed capacity + booting instances x ``workers_hint``), and
    terminate clients that hold no assigned task once nothing is
    grantable and they have been workless for ``idle_timeout_s``.

    The idle cutoff only ever selects clients with an empty assignment
    table, so downscaling can never strand an ASSIGNED task."""

    workers_hint: int = 1
    idle_timeout_s: float = 5.0

    def decide(self, core, tick) -> ScaleDecision:
        hint = max(1, self.workers_hint)
        committed = sum(max(ci.capacity, hint)
                        for ci in core.clients.values())
        # only client-kind instances contribute worker capacity — a
        # booting backup server must not suppress client creation
        committed += tick.pending_clients * hint
        room = core.config.max_clients \
            - len(core.clients) - tick.pending_clients
        create = 0
        if tick.can_create and room > 0:
            batch = min(room, max(1, getattr(core.config, "create_batch", 1)))
            # enough assignable work beyond committed capacity to fill
            # ceil(deficit / hint) more clients, up to the batch cap
            assignable = core.count_assignable(committed + hint * batch + 1)
            if assignable > committed:
                create = min(batch, -(-(assignable - committed) // hint))
        terminate = []
        if not core.has_assignable():
            for cname, ci in core.clients.items():
                if not ci.assigned \
                        and tick.now - ci.last_active > self.idle_timeout_s:
                    terminate.append(cname)
        return ScaleDecision(create=create, terminate=terminate)


# ---------------------------------------------------------------------------
# liveness (partition hardening)
# ---------------------------------------------------------------------------
@dataclass
class LivenessPolicy:
    """How long a silent client may live before it is declared dead.

    Real cloud incidents are dominated by *partial* failures — one-way
    link loss, asymmetric partitions, delayed-but-alive peers (Gent &
    Kotthoff) — so a client whose link the transport reports as
    partitioned (``ClientInfo.suspected_at`` set via the core's
    ``LinkLost`` event) gets ``partition_grace_s`` extra allowance: if
    the link heals within the grace window the client's tasks are never
    double-assigned and no takeover/termination churn happens.  A truly
    dead client still dies at ``limit`` + grace."""

    limit: float
    partition_grace_s: float = 0.0

    def allowance(self, ci) -> float:
        if ci.suspected_at is not None:
            return self.limit + self.partition_grace_s
        return self.limit


# ---------------------------------------------------------------------------
# budget
# ---------------------------------------------------------------------------
@dataclass
class BudgetPolicy:
    """Deny instance creation when the projected spend threatens ``cap``.

    Projection: cost accrued-or-committed so far (the CostMeter bills
    open instances at least to their minimum-billing commitment) plus
    ``reserve_s`` more seconds of the current burn rate and of the
    would-be instance's rate — i.e. scaling stops while enough budget
    remains to finish in-flight work.  On engines with a minimum billing
    commitment, set ``reserve_s`` at or above it so the would-be
    instance's own commitment is covered."""

    cap: float
    reserve_s: float = 30.0

    def allow_create(self, core, tick) -> bool:
        projected = tick.accrued_cost \
            + self.reserve_s * (tick.burn_rate + tick.client_rate)
        return projected <= self.cap


# ---------------------------------------------------------------------------
# cost accounting
# ---------------------------------------------------------------------------
class CostMeter:
    """Account of per-instance billing intervals, synced from an engine's
    ``billing_records()``: tuples ``(name, kind, rate, start, end|None)``
    with an optional sixth element ``min_end`` — the end of a minimum
    billing commitment already locked in by starting the instance.  An
    open record (``end is None``) is billed to ``max(now, min_end)``, so
    committed spend is visible to the budget policy before it elapses."""

    def __init__(self):
        # name -> (kind, rate, t0, t1, min_end)
        self._records: dict[str, tuple] = {}

    def sync(self, records) -> None:
        for name, kind, rate, start, end, *rest in records:
            self._records[name] = (kind, rate, start, end,
                                   rest[0] if rest else None)

    @staticmethod
    def _billed_end(t1, min_end, now: float) -> float:
        if t1 is not None:
            return t1
        return now if min_end is None else max(now, min_end)

    def rate_of(self, name: str, default: float = 1.0) -> float:
        rec = self._records.get(name)
        return rec[1] if rec is not None else default

    def accrued(self, now: float) -> float:
        return sum((self._billed_end(t1, me, now) - t0) * rate
                   for _, rate, t0, t1, me in self._records.values())

    def burn_rate(self, now: float) -> float:
        """Sum of the rates of instances still billing."""
        return sum(rate for _, rate, t0, t1, _ in self._records.values()
                   if t1 is None)

    def by_kind(self, now: float) -> dict:
        out: dict[str, float] = {}
        for kind, rate, t0, t1, me in self._records.values():
            out[kind] = out.get(kind, 0.0) \
                + (self._billed_end(t1, me, now) - t0) * rate
        return out

    def instance_seconds(self, now: float) -> float:
        return sum(self._billed_end(t1, me, now) - t0
                   for _, _, t0, t1, me in self._records.values())

    def summary(self, now: float) -> dict:
        return {
            "total": round(self.accrued(now), 6),
            "instance_seconds": round(self.instance_seconds(now), 6),
            "by_kind": {k: round(v, 6)
                        for k, v in sorted(self.by_kind(now).items())},
            "instances": len(self._records),
        }


# ---------------------------------------------------------------------------
# config -> policy factories (deterministic: rebuilt identically on restore)
# ---------------------------------------------------------------------------
def make_assign_policy(config) -> AssignPolicy:
    name = getattr(config, "assign_policy", "hardness")
    if name == "hardness":
        return HardnessOrderPolicy()
    if name == "backfill":
        return BatchBackfillPolicy(batch=getattr(config, "assign_batch", 4))
    raise ValueError(f"unknown assign_policy: {name!r}")


def make_scale_policy(config) -> ScalePolicy:
    name = getattr(config, "scale_policy", "fixed")
    if name == "fixed":
        return FixedFleetPolicy()
    if name == "demand":
        return DemandScalePolicy(
            workers_hint=getattr(config, "workers_hint", 1),
            idle_timeout_s=getattr(config, "idle_timeout_s", 5.0))
    raise ValueError(f"unknown scale_policy: {name!r}")


def make_budget_policy(config):
    cap = getattr(config, "budget_cap", None)
    if cap is None:
        return None
    return BudgetPolicy(cap=cap,
                        reserve_s=getattr(config, "budget_reserve_s", 30.0))


def make_liveness_policy(config) -> LivenessPolicy:
    return LivenessPolicy(
        limit=getattr(config, "health_update_limit", 10.0),
        partition_grace_s=getattr(config, "partition_grace_s", 0.0))
