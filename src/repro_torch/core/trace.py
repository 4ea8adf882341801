"""Timing-trace record/replay for the discrete-event simulator.

Gent & Kotthoff ("Reliability of Computational Experiments on Virtualised
Hardware") make the case that cloud timings are themselves experimental
data: a run's materialization latencies, message delays, task runtimes and
preemption times characterize the platform as much as the results do.
This module captures those timings as a structured JSON **trace** and
replays them through the event engine deterministically:

  * ``SimParams(record_trace=True)`` attaches a ``TraceRecorder`` to the
    engine's network/worker/creation hooks; ``SimCluster.trace()`` returns
    the ``Trace`` and ``write_trace(path)`` persists it.
  * ``SimParams(trace=path_or_Trace)`` attaches a ``TraceReplayer``:
    per-route message delays, per-instance creation delays and per-task
    runtimes are drawn from the trace instead of the latency/jitter/RNG
    parameters, and recorded preemptions are re-injected as scripted
    kills — so a replayed run reproduces the original's results table
    row-for-row (asserted in ``benchmarks/sim_chaos_bench.py``).
  * ``trace_from_run`` builds a trace from a *real* run's artifacts (the
    per-client event logs and the engine's billing records — the same
    hooks Local/GCE engines already expose), so real-cluster timings can
    be replayed through the simulator.

Keys are chosen for replay stability, not compactness: message delays are
FIFO lists per directed route (the protocol consumes a route's messages
in deterministic order), creation delays are keyed by instance name
(names are allocated deterministically by the core) and runtimes by task
id (the hardness-sorted table position, stable for a fixed task list).
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field


def _route_key(route) -> str:
    return f"{route[0]}->{route[1]}"


@dataclass
class Trace:
    """A recorded run's timing data (JSON-serializable)."""

    message_delays: dict = field(default_factory=dict)   # "a->b" -> [delay]
    creation_delays: dict = field(default_factory=dict)  # name -> delay
    task_runtimes: dict = field(default_factory=dict)    # str(tid) -> seconds
    preemptions: list = field(default_factory=list)      # [(t, name)]
    meta: dict = field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps({
            "message_delays": self.message_delays,
            "creation_delays": self.creation_delays,
            "task_runtimes": self.task_runtimes,
            "preemptions": [[t, n] for t, n in self.preemptions],
            "meta": self.meta,
        }, indent=2)

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")

    @classmethod
    def from_dict(cls, d: dict) -> Trace:
        return cls(
            message_delays={k: list(v)
                            for k, v in d.get("message_delays", {}).items()},
            creation_delays=dict(d.get("creation_delays", {})),
            task_runtimes=dict(d.get("task_runtimes", {})),
            preemptions=[(float(t), n) for t, n in d.get("preemptions", [])],
            meta=dict(d.get("meta", {})),
        )

    @classmethod
    def load(cls, path: str) -> Trace:
        with open(path) as f:
            return cls.from_dict(json.load(f))


def as_trace(trace) -> Trace:
    """Accepts a Trace, a dict, or a path to a trace JSON file."""
    if isinstance(trace, Trace):
        return trace
    if isinstance(trace, dict):
        return Trace.from_dict(trace)
    return Trace.load(trace)


class TraceRecorder:
    """Collects the timing samples of a live run (engine-attached)."""

    def __init__(self):
        self._delays: dict[str, list] = {}
        self._creations: dict[str, float] = {}
        self._runtimes: dict[str, float] = {}
        self._preemptions: list = []

    def record_delay(self, route, delay: float) -> None:
        self._delays.setdefault(_route_key(route), []).append(delay)

    def record_creation(self, name: str, delay: float) -> None:
        self._creations[name] = delay

    def record_runtime(self, tid, seconds: float) -> None:
        self._runtimes[str(tid)] = seconds

    def record_preemption(self, t: float, name: str) -> None:
        self._preemptions.append((t, name))

    def build(self, meta: dict | None = None) -> Trace:
        return Trace(
            message_delays={k: list(v) for k, v in self._delays.items()},
            creation_delays=dict(self._creations),
            task_runtimes=dict(self._runtimes),
            preemptions=list(self._preemptions),
            meta=dict(meta or {}),
        )


class TraceReplayer:
    """Feeds a recorded trace back through the engine hooks.

    Each delay list is consumed FIFO; when a sequence (or key) is
    exhausted the caller's default applies, so a trace recorded from a
    shorter or slightly different run degrades gracefully instead of
    failing."""

    def __init__(self, trace: Trace):
        self.trace = trace
        self._cursor: dict[str, int] = {}

    def next_delay(self, route, default: float) -> float:
        key = _route_key(route)
        seq = self.trace.message_delays.get(key)
        if not seq:
            return default
        i = self._cursor.get(key, 0)
        if i >= len(seq):
            return default
        self._cursor[key] = i + 1
        return seq[i]

    def creation_delay(self, name: str, default: float) -> float:
        return self.trace.creation_delays.get(name, default)

    def runtime(self, tid, default: float) -> float:
        return self.trace.task_runtimes.get(str(tid), default)

    def preemptions(self) -> list:
        return list(self.trace.preemptions)


def trace_from_run(events_by_client: dict, billing_records=None,
                   meta: dict | None = None) -> Trace:
    """Build a replayable trace from a *real* run's artifacts.

    ``events_by_client`` is the ``EventLog.snapshot()`` mapping (client ->
    [{"t", "kind", "body"}...]); task runtimes are reconstructed from the
    per-task ``started``/``done`` LOG events.  ``billing_records`` (the
    engine's ``billing_records()`` tuples) provide per-instance creation
    delays when the engine reports a requested-at time in ``meta``;
    otherwise creation delays are left to the replay defaults."""
    started: dict[int, float] = {}
    runtimes: dict[str, float] = {}
    for events in events_by_client.values():
        for e in events:
            body = e.get("body") or {}
            if not isinstance(body, dict):
                continue
            ev_name = body.get("event")
            if ev_name == "lifecycle":
                # combined per-wake form: start times under "started"
                for tid in body.get("started") or ():
                    started[tid] = e["t"]
                continue
            # clients batch lifecycle LOGs per wake ({"tids": [...]});
            # the single-tid form appears in pre-batching event logs
            tids = body.get("tids") if "tids" in body else (
                (body["tid"],) if "tid" in body else ())
            if ev_name == "started":
                for tid in tids:
                    started[tid] = e["t"]
            elif ev_name == "done":
                for tid in tids:
                    if tid in started:
                        runtimes[str(tid)] = e["t"] - started.pop(tid)
    trace = Trace(task_runtimes=runtimes, meta=dict(meta or {}))
    if billing_records:
        trace.meta["billing"] = [list(r) for r in billing_records]
    return trace
