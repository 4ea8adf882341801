"""Sharded hierarchical scheduling (fleet scale).

A single ``SchedulerCore`` handles every client message and policy tick
of a run; past ~10k clients / 100k tasks the one scheduler process is
the bottleneck even with indexed hot paths.  This module is the pure
meta-scheduling layer that splits one experiment across K independent
primary(+backup) scheduler pairs:

  * :func:`partition_tasks` slices the hardness-sorted task table into K
    contiguous-hardness shards (each shard's ``MinHardSet`` then covers a
    compact region of the partial order, so frontiers stay small);
  * :class:`ShardCoordinator` tracks which frontier elements each shard
    has published and queues them for delivery to every *other* shard —
    cross-shard gossip makes the domino rule global: a hardness that
    timed out in shard j prunes dominated tasks everywhere, exactly as a
    single scheduler would have pruned them.  Delivery is queued per
    shard, so a shard whose primary is mid-takeover receives the gossip
    on the next pump instead of losing it;
  * :func:`merge_results` / :func:`merge_cost_summaries` reassemble the
    per-shard results tables and cost accounts into the one table a
    single-scheduler run would have produced (rows back in submission
    order, costs summed per kind).

Everything here is a pure state machine: hardness values in, hardness
values out.  Transport, clocks and engines live in the shells
(``repro_torch.core.sim.ShardedSimCluster`` drives K ``Server`` shells on one
event loop); this module must stay deterministic and snapshot-complete —
``ShardCoordinator.snapshot()``/``restore()`` round-trip the gossip
state so a sharded run can resume without re-gossiping or, worse,
re-delivering a pruning frontier only to some shards.
"""
from __future__ import annotations

from repro_torch.core.results import ResultsTable


def partition_tasks(tasks, n_shards: int) -> list[list[int]]:
    """Split ``tasks`` into ``n_shards`` contiguous slices of the
    hardness-sorted order, returning per-shard lists of *original*
    indices (the shard's task list is ``[tasks[i] for i in indices]``,
    in the returned order).  Uses the same sort key as ``SchedulerCore``
    (componentwise hardness values, stable), so shard k's tasks are
    never harder than shard k+1's under the total order the scheduler
    assigns in."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    order = sorted(range(len(tasks)),
                   key=lambda i: tuple(tasks[i].hardness().values))
    base, extra = divmod(len(order), n_shards)
    out: list[list[int]] = []
    pos = 0
    for k in range(n_shards):
        size = base + (1 if k < extra else 0)
        out.append(order[pos:pos + size])
        pos += size
    return out


class ShardCoordinator:
    """Cross-shard ``MinHardSet`` gossip state (the meta-scheduler).

    ``observe(k, frontier)`` diffs shard k's current frontier snapshot
    against everything gossiped so far and enqueues each fresh hardness
    for every other shard; ``take_pending(k)`` drains shard k's queue
    for delivery (``Server.apply_gossip``).  The seen-set is global —
    a hardness is gossiped at most once no matter how many shards
    independently discover it — while delivery is queued per shard, so
    a shard with no acting primary at pump time (takeover in flight)
    still receives the frontier later instead of silently missing it.
    """

    def __init__(self, n_shards: int):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.n_shards = n_shards
        self.seen: set = set()      # hardness value tuples gossiped so far
        # per-shard delivery queues of hardness value tuples
        self.pending: list[list] = [[] for _ in range(n_shards)]

    def observe(self, shard_id: int, frontier_values) -> list:
        """Record shard ``shard_id``'s frontier (an iterable of hardness
        value tuples, e.g. ``MinHardSet.snapshot()``); returns the fresh
        ones and queues them for every other shard."""
        fresh: list = []
        for hv in frontier_values:
            hv = tuple(hv)
            if hv in self.seen:
                continue
            self.seen.add(hv)
            fresh.append(hv)
            for j in range(self.n_shards):
                if j != shard_id:
                    self.pending[j].append(hv)
        return fresh

    def take_pending(self, shard_id: int) -> list:
        """Drain shard ``shard_id``'s queued gossip deliveries."""
        out, self.pending[shard_id] = self.pending[shard_id], []
        return out

    def snapshot(self) -> dict:
        return {
            "n_shards": self.n_shards,
            "seen": sorted(self.seen),
            "pending": [list(q) for q in self.pending],
        }

    @classmethod
    def restore(cls, snap: dict) -> ShardCoordinator:
        coord = cls.__new__(cls)
        coord.n_shards = snap["n_shards"]
        coord.seen = {tuple(hv) for hv in snap["seen"]}
        coord.pending = [[tuple(hv) for hv in q] for q in snap["pending"]]
        return coord


def pump_gossip(coordinator: ShardCoordinator, servers: dict) -> int:
    """One gossip round: publish every acting primary's frontier, then
    deliver queued hardnesses to each.  ``servers`` maps shard id to its
    acting primary ``Server`` (shards mid-takeover are simply absent —
    their queues keep accumulating).  Returns the number of deliveries
    performed (a delivery may be a no-op when the receiving frontier
    already dominates it; ``apply_gossip`` decides)."""
    for k, srv in servers.items():
        coordinator.observe(k, srv.min_hard.snapshot())
    delivered = 0
    for k, srv in servers.items():
        pending = coordinator.take_pending(k)
        if pending:
            # one batched delivery per shard per pump: the server fans
            # out a single counterless message per client for the lot
            srv.apply_gossip(pending)
            delivered += len(pending)
    return delivered


def merge_cost_summaries(summaries) -> dict | None:
    """Aggregate per-shard ``CostMeter.summary()`` dicts into one
    run-level account (totals and instance-seconds summed, ``by_kind``
    summed per kind, instance counts added).  ``None`` entries (shards
    without cost accounting) are skipped; all-``None`` yields ``None``.
    """
    present = [s for s in summaries if s]
    if not present:
        return None
    by_kind: dict = {}
    for s in present:
        for kind, v in (s.get("by_kind") or {}).items():
            by_kind[kind] = round(by_kind.get(kind, 0.0) + v, 6)
    return {
        "total": round(sum(s.get("total", 0.0) for s in present), 6),
        "instance_seconds": round(
            sum(s.get("instance_seconds", 0.0) for s in present), 6),
        "by_kind": dict(sorted(by_kind.items())),
        "instances": sum(s.get("instances", 0) for s in present),
    }


def merge_results(tables, shard_indices) -> ResultsTable:
    """Reassemble per-shard :class:`ResultsTable`s into the single table
    a one-scheduler run would have written: rows back in original
    submission order (via the ``partition_tasks`` index lists), per-row
    costs preserved, cost summaries merged.  Raises when a shard's row
    count disagrees with its index list — group retention
    (``min_group_size``) must not run per shard (a group split across
    shards would be dropped wrongly), so sharded runs reject it
    upstream and this merge insists on complete tables."""
    if len(tables) != len(shard_indices):
        raise ValueError(f"{len(tables)} tables for "
                         f"{len(shard_indices)} shards")
    have_costs = any(t is not None and t.row_costs is not None
                     for t in tables)
    merged: list = []
    for k, (table, idxs) in enumerate(zip(tables, shard_indices)):
        if table is None:
            raise ValueError(f"shard {k} has no results table yet")
        if table.dropped_groups:
            raise ValueError(
                f"shard {k} dropped groups {table.dropped_groups!r}: "
                "min_group_size retention cannot be applied per shard")
        if len(table.rows) != len(idxs):
            raise ValueError(
                f"shard {k} returned {len(table.rows)} rows for "
                f"{len(idxs)} tasks — every task must reach exactly one "
                "terminal status")
        costs = table.row_costs if table.row_costs is not None \
            else [None] * len(idxs)
        for gi, row, cost in zip(idxs, table.rows, costs):
            merged.append((gi, row, cost))
    merged.sort(key=lambda x: x[0])
    first = next((t for t in tables if t.rows), tables[0])
    return ResultsTable(
        parameter_titles=first.parameter_titles,
        result_titles=first.result_titles,
        rows=[row for _, row, _ in merged],
        dropped_groups=[],
        row_costs=[c for _, _, c in merged] if have_costs else None,
        cost=merge_cost_summaries([t.cost for t in tables]),
    )


__all__ = [
    "partition_tasks", "ShardCoordinator", "pump_gossip",
    "merge_results", "merge_cost_summaries",
]
