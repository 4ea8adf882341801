"""Results table (GROUP-BY retention, original task order) + client event
logs — the paper's "output folder" contents.
"""
from __future__ import annotations

import collections
import json
import os
from dataclasses import dataclass, field


class EventLog:
    def __init__(self):
        self._events: dict[str, list] = {}

    def ensure(self, client: str):
        self._events.setdefault(client, [])

    def log(self, client: str, t: float, kind: str, body):
        self._events.setdefault(client, []).append(
            {"t": t, "kind": kind, "body": body})

    def snapshot(self):
        return {c: list(v) for c, v in self._events.items()}

    def restore(self, snap):
        self._events = {c: list(v) for c, v in snap.items()}

    def for_client(self, client: str) -> list:
        return list(self._events.get(client, []))

    def write(self, out_dir: str):
        for client, events in self._events.items():
            d = os.path.join(out_dir, client)
            os.makedirs(d, exist_ok=True)
            with open(os.path.join(d, "events.jsonl"), "w") as f:
                for e in events:
                    f.write(json.dumps(e, default=str) + "\n")


@dataclass
class ResultsTable:
    parameter_titles: tuple
    result_titles: tuple
    rows: list                      # [(params, result, status)]
    dropped_groups: list = field(default_factory=list)
    # cost accounting (CostMeter, threaded engine -> server -> here):
    # per-row attributed cost (seconds the task ran x its instance's
    # $/instance-second rate; None for unsolved rows) + run-level summary
    row_costs: list | None = None
    cost: dict | None = None

    @classmethod
    def build(cls, tasks, original_index, status, results,
              min_group_size: int = 0, task_costs: dict | None = None,
              cost: dict | None = None) -> ResultsTable:
        if not tasks:
            return cls((), (), [], cost=cost)
        # group retention: a group is kept if #solved >= min_group_size
        solved_per_group = collections.Counter()
        for tid, task in enumerate(tasks):
            if tid in results:
                solved_per_group[task.group_key()] += 1
        dropped = set()
        if min_group_size > 0:
            for task in tasks:
                gk = task.group_key()
                if solved_per_group[gk] < min_group_size:
                    dropped.add(gk)
        # restore original order (paper: prior to printing results)
        by_original = sorted(range(len(tasks)),
                             key=lambda i: original_index[i])
        rows = []
        row_costs = [] if task_costs is not None else None
        for tid in by_original:
            task = tasks[tid]
            if min_group_size > 0 and task.group_key() in dropped:
                continue
            rows.append((task.parameters(), results.get(tid),
                         status[tid]))
            if row_costs is not None:
                row_costs.append(task_costs.get(tid))
        return cls(
            parameter_titles=tasks[0].parameter_titles(),
            result_titles=tasks[0].result_titles(),
            rows=rows,
            dropped_groups=sorted(dropped),
            row_costs=row_costs,
            cost=cost,
        )

    # ------------------------------------------------------------------
    def solved_rows(self):
        return [(p, r) for p, r, s in self.rows if r is not None]

    def to_csv(self) -> str:
        cost_col = ("cost",) if self.row_costs is not None else ()
        header = ",".join(map(str, self.parameter_titles + self.result_titles
                              + ("status",) + cost_col))
        lines = [header]
        for i, (params, result, status) in enumerate(self.rows):
            res = result if result is not None else ("",) * len(
                self.result_titles)
            cost = ()
            if self.row_costs is not None:
                c = self.row_costs[i]
                cost = (f"{c:.6g}" if c is not None else "",)
            lines.append(",".join(map(str, tuple(params) + tuple(res)
                                      + (status,) + cost)))
        return "\n".join(lines)

    def write(self, out_dir: str):
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "results.csv"), "w") as f:
            f.write(self.to_csv() + "\n")
        if self.cost is not None:
            with open(os.path.join(out_dir, "cost.json"), "w") as f:
                json.dump(self.cost, f, indent=2)
