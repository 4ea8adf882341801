"""The one-call experiment facade + streaming run handle.

Every scenario — simulated cloud, local processes, GCE, TPU pods — enters
through the same front door:

    exp = Experiment(space.bind(solve), engine="sim", scale="demand",
                     budget_cap=400.0, backup=True,
                     chaos=[SpotWave(at=8.0, fraction=0.5)])
    with exp.run() as run:
        for ev in run.events():
            ...                      # typed RunEvents as they happen
        table = run.results()        # ResultsTable incl. cost summary

``Experiment`` resolves engines through the :mod:`repro_torch.core.engines`
registry, so ``SimCluster`` scenarios (spot waves, partitions, traces)
and real engines are configured identically; ``run()`` returns a
:class:`RunHandle` that streams typed events, exposes ``results()``,
scopes shutdown to a ``with`` block and supports ``snapshot()`` /
``Experiment.resume()`` from the scheduler core's structured snapshot.
"""
from __future__ import annotations

import dataclasses
import pickle
import time as _time
from dataclasses import dataclass

from repro_torch.core import engines as _engines
from repro_torch.core.engine import AbstractEngine
from repro_torch.core.policy import CostMeter
from repro_torch.core.scheduler import DONE, PENDING, PRUNED, TIMED_OUT
from repro_torch.core.server import Server, ServerConfig
from repro_torch.core.sim import ShardedSimCluster, SimCluster
from repro_torch.core.space import ParamSpace, TaskFactory
from repro_torch.core.task import AbstractTask


# ---------------------------------------------------------------------------
# typed run events (streamed by RunHandle.events())
# ---------------------------------------------------------------------------
@dataclass
class RunEvent:
    """Base class; ``t`` is engine time (virtual seconds on the
    simulator, wall-clock seconds on real engines)."""

    t: float


@dataclass
class TaskSolved(RunEvent):
    params: tuple
    result: tuple


@dataclass
class TaskPruned(RunEvent):
    params: tuple


@dataclass
class TaskTimedOut(RunEvent):
    params: tuple


@dataclass
class InstanceCreated(RunEvent):
    name: str
    kind: str


@dataclass
class InstanceTerminated(RunEvent):
    name: str
    kind: str


@dataclass
class InstancePreempted(RunEvent):
    name: str


@dataclass
class CostTick(RunEvent):
    total: float
    by_kind: dict


@dataclass
class RunDone(RunEvent):
    solved: int
    pruned: int
    timed_out: int
    cost: float | None = None


# ---------------------------------------------------------------------------
# chaos directives (simulator only; see SimCluster for the mechanisms)
# ---------------------------------------------------------------------------
@dataclass
class SpotWave:
    """Kill ``fraction`` of the alive preemptible clients at time ``at``."""

    at: float
    fraction: float


@dataclass
class Partition:
    """Drop messages on the a<->b link (roles or client names), optionally
    scheduled (``at``) and auto-healing (``until``)."""

    a: str
    b: str
    direction: str = "both"
    at: float | None = None
    until: float | None = None


@dataclass
class KillPrimary:
    """Crash the primary server at time ``at`` (backup takeover drill)."""

    at: float


def _apply_chaos(cluster: SimCluster, directives) -> None:
    for c in directives:
        if isinstance(c, SpotWave):
            cluster.spot_wave(c.at, c.fraction)
        elif isinstance(c, Partition):
            cluster.partition(c.a, c.b, c.direction, at=c.at, until=c.until)
        elif isinstance(c, KillPrimary):
            cluster.at(c.at, lambda cl: cl.kill_primary())
        elif callable(c):
            c(cluster)           # escape hatch: arbitrary scripting
        else:
            raise TypeError(f"unknown chaos directive: {c!r}")


# ---------------------------------------------------------------------------
# state watcher: diffs observable scheduler/engine state into RunEvents
# ---------------------------------------------------------------------------
class _RunWatcher:
    def __init__(self, cost_tick_s: float):
        self.cost_tick_s = cost_tick_s
        self._prev_status: list | None = None
        self._created: set[str] = set()
        self._terminated: set[str] = set()
        self._alive_prev: dict[str, bool] = {}
        self._last_cost_tick: float | None = None
        self._meter = CostMeter()

    def poll(self, server: Server, engine, now: float) -> list[RunEvent]:
        evs: list[RunEvent] = []
        core = server.core
        st = core.status
        if self._prev_status is None or len(self._prev_status) != len(st):
            self._prev_status = [PENDING] * len(st)
        for tid, s in enumerate(st):
            if s == self._prev_status[tid]:
                continue
            self._prev_status[tid] = s
            params = core.tasks[tid].parameters()
            if s == DONE:
                evs.append(TaskSolved(now, params, core.results.get(tid)))
            elif s == TIMED_OUT:
                evs.append(TaskTimedOut(now, params))
            elif s == PRUNED:
                evs.append(TaskPruned(now, params))
        alive = getattr(engine, "alive", None)
        alive_changed = False
        if isinstance(alive, dict):
            for name, up in alive.items():
                if self._alive_prev.get(name, up) and not up:
                    evs.append(InstancePreempted(now, name))
            alive_changed = alive != self._alive_prev
            if alive_changed:
                self._alive_prev = dict(alive)
        tick_due = self._last_cost_tick is not None \
            and now - self._last_cost_tick >= self.cost_tick_s
        # materializing billing_records() every poll is the hot cost of
        # the streaming path: engines with a liveness dict (the sim) are
        # only polled when something observable changed or a tick is due
        if alive is None or alive_changed or evs or tick_due \
                or self._last_cost_tick is None:
            records = engine.billing_records() or []
            for rec in records:
                name, kind, _rate, _start, end = rec[:5]
                if name not in self._created:
                    self._created.add(name)
                    evs.append(InstanceCreated(now, name, kind))
                if end is not None and name not in self._terminated:
                    self._terminated.add(name)
                    evs.append(InstanceTerminated(now, name, kind))
            if self._last_cost_tick is None:
                self._last_cost_tick = now
            elif tick_due:
                self._last_cost_tick = now
                self._meter.sync(records)
                evs.append(CostTick(now, self._meter.accrued(now),
                                    self._meter.by_kind(now)))
        return evs


# ---------------------------------------------------------------------------
# the facade
# ---------------------------------------------------------------------------
def _server_config_fields():
    return {f.name for f in dataclasses.fields(ServerConfig)}


class Experiment:
    """One front door over sim/local/GCE/TPU runs.

    ``space_or_tasks`` — a (bound) :class:`ParamSpace`, or an iterable of
    ``AbstractTask`` objects.  ``task`` binds an unbound space.

    ``engine`` — a registry name (``"sim"``/``"local"``/``"gce"``/
    ``"tpu"`` or anything ``engines.register``-ed), or a ready
    ``AbstractEngine`` instance; ``engine_cfg`` is the registry factory's
    keyword config and ``sim=`` is sugar for ``engine_cfg`` field values
    of ``SimParams`` when ``engine="sim"``.

    ``scale`` / ``budget_cap`` / ``backup`` / ``max_clients`` /
    ``out_dir`` and any extra ``ServerConfig`` field passed as a keyword
    build the server config (or pass a full ``config=ServerConfig``).

    ``chaos`` — simulator-only fault script: :class:`SpotWave`,
    :class:`Partition`, :class:`KillPrimary`, or ``callable(cluster)``.

    ``shards`` — split the run across K independent primary(+backup)
    scheduler pairs (simulator only): the hardness-sorted task table is
    partitioned into K contiguous slices, each shard runs its own fleet
    under the per-shard ``ServerConfig`` (``max_clients`` etc. apply
    *per shard*), and timed-out hardness frontiers gossip across shards
    so domino pruning stays global.  ``results()`` returns the merged
    table in submission order, exactly as ``shards=1`` would.
    """

    def __init__(self, space_or_tasks, *, task=None, engine: object = "sim",
                 engine_cfg: dict | None = None, sim: object = None,
                 scale: str = "fixed", budget_cap: float | None = None,
                 backup: bool = False, max_clients: int = 4,
                 out_dir: str | None = None, chaos=(), shards: int = 1,
                 config: ServerConfig | None = None, **server_cfg):
        self.tasks = self._resolve_tasks(space_or_tasks, task)
        self.engine = engine
        self.shards = int(shards)
        if self.shards < 1:
            raise ValueError(f"shards must be >= 1, got {shards}")
        self.engine_cfg = dict(engine_cfg or {})
        if self.engine_cfg and not isinstance(engine, str):
            raise ValueError(
                "engine_cfg is only consumed by registry names; this "
                "engine is already constructed — configure it directly")
        if sim is not None:
            if engine != "sim":
                raise ValueError("sim= is only meaningful with engine='sim'")
            if isinstance(sim, dict):
                self.engine_cfg.update(sim)
            else:
                self.engine_cfg["params"] = sim
        self.chaos = tuple(chaos)
        # fail fast for the built-in real engines; custom registered
        # names are validated against the resolved spec at start time
        if self.chaos and (isinstance(engine, str)
                           and engine in ("local", "gce", "tpu")
                           or isinstance(engine, AbstractEngine)):
            raise ValueError("chaos directives require a simulator engine")
        if self.shards > 1:
            # sharding is a simulator feature: K Server shells on one
            # event loop.  Real engines run one scheduler per process.
            if isinstance(engine, AbstractEngine) or (
                    isinstance(engine, str)
                    and engine in ("local", "gce", "tpu")):
                raise ValueError(
                    "shards>1 requires the simulator engine "
                    "(engine='sim')")
            if self.chaos:
                raise ValueError(
                    "chaos directives are not supported with shards>1 "
                    "yet — script faults via the cluster directly")
        if config is not None:
            overridden = [k for k, v, d in (
                ("scale", scale, "fixed"), ("budget_cap", budget_cap, None),
                ("backup", backup, False), ("max_clients", max_clients, 4),
                ("out_dir", out_dir, None)) if v != d]
            if server_cfg or overridden:
                raise ValueError(
                    f"pass either config=ServerConfig(...) or field "
                    f"overrides, not both: "
                    f"{sorted(server_cfg) + sorted(overridden)}")
            self.config = config
        else:
            unknown = set(server_cfg) - _server_config_fields()
            if unknown:
                raise ValueError(
                    f"unknown ServerConfig fields: {sorted(unknown)}")
            self.config = ServerConfig(
                max_clients=max_clients, use_backup=backup,
                scale_policy=scale, budget_cap=budget_cap,
                out_dir=out_dir, **server_cfg)
        if self.shards > 1 and self.config.min_group_size > 0:
            raise ValueError(
                "min_group_size retention cannot run per shard (a group "
                "split across shards would be dropped wrongly) — use "
                "shards=1 or min_group_size=0")

    @staticmethod
    def _resolve_tasks(space_or_tasks, task) -> list:
        if isinstance(space_or_tasks, ParamSpace):
            space = space_or_tasks
            if task is not None:
                space = space.bind(task)
            return space.tasks()
        if isinstance(space_or_tasks, (TaskFactory,)) or \
                isinstance(task, ParamSpace):
            raise TypeError("pass the ParamSpace first and the @task "
                            "function as task= (or bind the space)")
        tasks = list(space_or_tasks)
        for t in tasks:
            if not isinstance(t, AbstractTask):
                raise TypeError(f"not an AbstractTask: {t!r}")
        return tasks

    # ------------------------------------------------------------------
    def run(self) -> RunHandle:
        """Start (lazily) and return the streaming run handle."""
        return RunHandle(self)

    def resume(self, snapshot: bytes) -> RunHandle:
        """Resume from a ``RunHandle.snapshot()`` blob: solved results are
        kept, in-flight assignments are requeued (at-least-once), and the
        run continues on a fresh fleet."""
        return RunHandle(self, resume_blob=snapshot)


class RunHandle:
    """Handle over a started experiment: stream events, fetch results,
    snapshot, and ``with``-scope the engine shutdown."""

    def __init__(self, exp: Experiment, resume_blob: bytes | None = None):
        self._exp = exp
        self._resume_blob = resume_blob
        self._cluster = None       # SimCluster | ShardedSimCluster
        self._server: Server | None = None
        self._engine = None
        self._table = None
        self._started = False
        self._closed = False
        self._sharded = False

    # ------------------------------------------------------------------
    # lazy start
    # ------------------------------------------------------------------
    def _start(self):
        if self._started:
            return
        self._started = True
        exp = self._exp
        spec = _engines.make(exp.engine, **exp.engine_cfg) \
            if isinstance(exp.engine, str) else exp.engine
        # a sharded snapshot carries its own shard count; resuming one
        # always takes the sharded path, whatever shards= says now
        resume_state = None
        if self._resume_blob is not None:
            resume_state = pickle.loads(self._resume_blob)
        sharded_blob = isinstance(resume_state, dict) \
            and "shards" in resume_state
        sharded = exp.shards > 1 or sharded_blob
        try:
            if exp.chaos and not isinstance(spec, _engines.SimSpec):
                raise ValueError(
                    "chaos directives require a simulator engine")
            if sharded and not isinstance(spec, _engines.SimSpec):
                raise ValueError(
                    "shards>1 requires the simulator engine (engine='sim')")
            if resume_state is not None and exp.shards > 1 \
                    and not sharded_blob:
                raise ValueError(
                    "resume blob is a single-scheduler snapshot — resume "
                    "with shards=1 (sharding cannot be added on resume)")
            if sharded:
                self._sharded = True
                self._cluster = ShardedSimCluster(
                    exp.tasks, exp.config, spec.params,
                    n_shards=exp.shards, _internal=True,
                    _resume=resume_state if sharded_blob else None)
                self._engine = self._cluster.engines[0]
            elif isinstance(spec, _engines.SimSpec):
                self._cluster = SimCluster(exp.tasks, exp.config,
                                           spec.params, _internal=True)
                self._engine = self._cluster.engine
                if self._resume_blob is not None:
                    srv = Server.resume_primary(self._resume_blob,
                                                self._engine)
                    self._cluster.server = srv
                    self._engine.backup_links = srv.config.use_backup
                _apply_chaos(self._cluster, exp.chaos)
            elif isinstance(spec, AbstractEngine):
                self._engine = spec
                self._server = (
                    Server.resume_primary(self._resume_blob, spec)
                    if self._resume_blob is not None
                    else Server(exp.tasks, spec, exp.config, _internal=True))
            else:
                raise TypeError(f"engine factory returned {spec!r}; "
                                f"expected an AbstractEngine or "
                                f"engines.SimSpec")
        except BaseException:
            # a constructed real engine must not leak (mp.Manager
            # processes, cloud state) when validation/wiring fails
            if isinstance(spec, AbstractEngine):
                spec.shutdown()
            raise

    # ------------------------------------------------------------------
    @property
    def cluster(self):
        """The underlying ``SimCluster``/``ShardedSimCluster`` (sim runs
        only) — the advanced scripting surface (``at``/``partition``/
        ``trace`` ...)."""
        self._start()
        if self._cluster is None:
            raise AttributeError("no cluster: this run uses a real engine")
        return self._cluster

    @property
    def engine(self):
        self._start()
        return self._engine

    @property
    def server(self) -> Server:
        """The acting primary server (single-scheduler runs)."""
        self._start()
        if self._sharded:
            raise AttributeError(
                "sharded run: there is no single primary — use "
                ".shard_servers")
        if self._cluster is not None:
            return self._cluster.acting_primary() or self._cluster.server
        return self._server

    @property
    def shard_servers(self) -> list[Server]:
        """The acting primary of every shard, in shard order (sharded
        runs; a single-scheduler run returns a one-element list)."""
        self._start()
        if not self._sharded:
            return [self.server]
        acting = self._cluster.acting_primaries()
        return [acting[k] for k in sorted(acting)]

    @property
    def table(self):
        """The final ResultsTable (None until the run completes)."""
        return self._table

    # ------------------------------------------------------------------
    # driving
    # ------------------------------------------------------------------
    def events(self, until: float = 1e9, max_steps: int = 200_000,
               poll_sleep: float = 0.02, cost_tick_s: float = 5.0):
        """Generator: drive the run, yielding typed :class:`RunEvent`s as
        scheduler/engine state changes, ending with :class:`RunDone`.
        ``max_steps`` bounds simulator runs, ``until`` bounds both
        (virtual seconds on sim, wall clock on real engines);
        ``poll_sleep`` paces real-engine polling; ``cost_tick_s`` is the
        CostTick cadence (in engine time).  On a real engine the stream
        owns the fleet: abandoning it before ``RunDone`` shuts the
        engine down (``snapshot()`` + ``Experiment.resume()`` continues
        the exploration on a fresh fleet; a later ``results()`` raises
        instead of hanging)."""
        self._start()
        if self._sharded:
            yield from self._sharded_sim_events(until, max_steps,
                                                cost_tick_s)
            return
        watcher = _RunWatcher(cost_tick_s)
        if self._cluster is not None:
            yield from self._sim_events(watcher, until, max_steps)
        else:
            yield from self._real_events(watcher, until, poll_sleep)

    def _sim_events(self, watcher, until, max_steps):
        cl = self._cluster
        prim = None
        for prim in cl.steps(until=until, max_steps=max_steps):
            yield from watcher.poll(self.server, self._engine,
                                    cl.clock.now())
            if prim is not None:
                break
        self._table = prim.final_results
        yield self._done_event(cl.clock.now())

    def _sharded_sim_events(self, until, max_steps, cost_tick_s):
        # one watcher per shard: each diffs its own scheduler core and
        # engine registry, so the merged stream interleaves shard events
        # in step order
        cl = self._cluster
        watchers = [_RunWatcher(cost_tick_s) for _ in range(cl.n_shards)]
        done = None
        for done in cl.steps(until=until, max_steps=max_steps):
            now = cl.clock.now()
            acting = cl.acting_primaries()
            for k, w in enumerate(watchers):
                srv = acting.get(k)
                if srv is not None:
                    yield from w.poll(srv, cl.engines[k], now)
            if done is not None:
                break
        self._table = cl.merged_results()
        yield self._done_event(cl.clock.now())

    def _real_events(self, watcher, until, poll_sleep):
        # the single real-engine drive loop (results() drains it too).
        # The generator owns the engine's lifetime on this path: both
        # normal exhaustion and an abandoned/failed iteration must reap
        # the client process groups (shutdown is idempotent with the
        # with-block path)
        if self._closed:
            raise RuntimeError(
                "engine already shut down (a previous event stream was "
                "abandoned before RunDone) — snapshot() before abandoning "
                "and Experiment.resume() to continue")
        try:
            srv = self._server
            t0 = _time.time()
            while not srv.done:
                if _time.time() - t0 >= until:
                    raise TimeoutError(f"run did not finish within {until}s")
                srv.step()
                yield from watcher.poll(srv, self._engine, srv.now())
                _time.sleep(poll_sleep)
            self._table = srv.final_results
            yield from watcher.poll(srv, self._engine, srv.now())
            yield self._done_event(srv.now())
        finally:
            self.shutdown()

    def _done_event(self, now: float) -> RunDone:
        rows = self._table.rows
        return RunDone(
            now,
            solved=sum(1 for _, r, _ in rows if r is not None),
            pruned=sum(1 for _, _, s in rows if s == PRUNED),
            timed_out=sum(1 for _, _, s in rows if s == TIMED_OUT),
            cost=(self._table.cost or {}).get("total"),
        )

    def results(self, until: float = 1e9, max_steps: int = 200_000,
                poll_sleep: float = 0.02):
        """Drive the run to completion (no per-step event diffing — the
        fast path) and return the final ``ResultsTable``.  ``until`` is
        virtual seconds on the simulator and a wall-clock bound on real
        engines (TimeoutError past it); ``max_steps`` bounds simulator
        steps only.  Real engines are shut down once results are in
        (instances already said BYE); simulator state stays inspectable
        via ``.cluster``."""
        if self._table is not None:
            return self._table
        self._start()
        if self._sharded:
            self._cluster.run(until=until, max_steps=max_steps)
            self._table = self._cluster.merged_results()
        elif self._cluster is not None:
            prim = self._cluster.run(until=until, max_steps=max_steps)
            self._table = prim.final_results
        else:
            # drain the one real drive loop, discarding the events (a
            # never-firing cost tick keeps the watcher diff-only)
            watcher = _RunWatcher(cost_tick_s=float("inf"))
            for _ in self._real_events(watcher, until, poll_sleep):
                pass
        return self._table

    # ------------------------------------------------------------------
    # snapshot / lifecycle
    # ------------------------------------------------------------------
    def snapshot(self) -> bytes:
        """Structured snapshot of the run's scheduler state — feed to
        ``Experiment.resume()`` to continue an interrupted run.  Sharded
        runs bundle every shard's core plus the gossip coordinator."""
        self._start()
        if self._sharded:
            return self._cluster.serialize_state()
        return self.server.serialize_state()

    def shutdown(self):
        if self._closed or self._engine is None:
            return
        self._closed = True
        if self._sharded:
            for eng in self._cluster.engines:
                eng.shutdown()
        else:
            self._engine.shutdown()

    def __enter__(self) -> RunHandle:
        self._start()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.shutdown()
        return False


__all__ = [
    "Experiment", "RunHandle",
    "RunEvent", "TaskSolved", "TaskPruned", "TaskTimedOut",
    "InstanceCreated", "InstanceTerminated", "InstancePreempted",
    "CostTick", "RunDone",
    "SpotWave", "Partition", "KillPrimary",
]
