"""Deterministic cloud simulator (virtual clock, discrete-event core).

The paper's local engine "is actually a simulation of performing the
experiment on the cloud ... a powerful tool to facilitate further
development".  We take that seriously: ``SimEngine`` runs the *same*
Server/Client protocol code as the real engines, but on a virtual clock
with scripted instance-creation delays, rate limits, message latency and
failure injection — so the fault-tolerance protocol (backup mirroring,
takeover, task reassignment, domino effect) is unit-testable and
benchmarkable with exact reproducibility.

The core is a **discrete-event engine**: a global event heap holds message
deliveries, worker completions, instance materializations, script
callbacks and per-node wake hints (health heartbeats, task deadlines,
creation-backoff expiries).  ``SimCluster.run()`` jumps the clock to the
next event and steps only the nodes that event concerns, doing O(events)
work instead of O(T/dt * nodes) polling.  The legacy fixed-``dt`` polling
loop is retained behind ``SimParams(mode="fixed")`` as a semantic
reference for equivalence tests and speedup benchmarks.

Scenario knobs the fixed-step loop could not afford:
  * heterogeneous instance types — per-kind ``creation_delay``,
    ``cost_per_instance_second`` and ``client_workers``
    (``SimParams.instance_types``),
  * scripted spot-preemption waves (``SimCluster.spot_wave``),
  * per-message latency jitter from a seeded RNG
    (``SimParams.latency_jitter`` / ``SimParams.seed``).
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
import pickle
import random
import warnings
from dataclasses import dataclass, field

from repro_torch.core import transport
from repro_torch.core.client import Client
from repro_torch.core.engine import AbstractEngine, PendingInstance, RateLimited
from repro_torch.core.server import Server, ServerConfig
from repro_torch.core.shard import (ShardCoordinator, merge_results,
                              partition_tasks, pump_gossip)
from repro_torch.core.task import AbstractTask
from repro_torch.core.trace import TraceRecorder, TraceReplayer, as_trace
from repro_torch.core.workerpool import SimWorkerPool


class Clock:
    def __init__(self):
        self.t = 0.0

    def now(self) -> float:
        return self.t

    def advance(self, dt: float):
        self.t += dt

    def advance_to(self, t: float):
        if t > self.t:
            self.t = t


# wake target meaning "every alive server node" — server-side wires cannot
# name their poller statically (the acting primary changes at takeover)
SERVERS = "@servers"


class EventLoop:
    """Global event heap over the virtual clock.

    Entries are ``(time, seq, kind, data)``; ``seq`` makes heap order
    deterministic for same-time events (insertion order).  ``wake`` entries
    are deduplicated per target: scheduling a wake at or after an already
    pending one is a no-op, so periodic rescheduling stays O(1) per event.
    """

    def __init__(self, clock: Clock):
        self.clock = clock
        self._heap: list = []
        self._seq = itertools.count()
        self._pending_wake: dict = {}     # target -> earliest scheduled t
        self.enabled = True               # disabled under mode="fixed"
        self.processed = 0                # events popped (benchmark metric)

    def schedule(self, t: float, kind: str, data=None):
        if not self.enabled:
            return
        heapq.heappush(self._heap, (t, next(self._seq), kind, data))

    def wake(self, target, t: float, quantum: float = 0.0):
        """Request that ``target`` be stepped at time ``t`` (coalesced up to
        ``quantum`` to batch near-simultaneous deliveries into one step)."""
        if not self.enabled:
            return
        if quantum > 0.0:
            q_t = math.ceil(round(t / quantum, 9)) * quantum
            if q_t < t:        # float fuzz must never round below t, or a
                q_t += quantum  # delivery could be polled before it's due
            t = q_t
        cur = self._pending_wake.get(target)
        if cur is not None and cur <= t:
            return
        self._pending_wake[target] = t
        self.schedule(t, "wake", target)

    def next_time(self) -> float | None:
        return self._heap[0][0] if self._heap else None

    def pop_due(self, now: float) -> list:
        out = []
        while self._heap and self._heap[0][0] <= now:
            ev = heapq.heappop(self._heap)
            self.processed += 1
            if ev[2] == "wake" and self._pending_wake.get(ev[3]) == ev[0]:
                del self._pending_wake[ev[3]]
            out.append(ev)
        return out


@dataclass
class InstanceType:
    """Per-kind overrides of the scalar SimParams fields (None -> inherit)."""
    creation_delay: float | None = None
    cost_per_instance_second: float | None = None
    client_workers: int | None = None
    preemptible: bool = True            # spot waves only hit preemptible kinds
    min_billing_s: float | None = None  # minimum billed commitment


@dataclass
class SimParams:
    creation_delay: float = 2.0        # VM boot time
    min_create_interval: float = 0.5   # platform rate limit
    client_workers: int = 4            # CPUs per client instance
    latency: float = 0.01              # message latency
    dt: float = 0.05                   # step size (mode="fixed" only)
    cost_per_instance_second: float = 1.0
    min_billing_s: float = 0.0         # per-instance minimum billed seconds
    #   (clouds bill a minimum commitment per started instance; makes
    #   over-provisioning visible to the cost account)
    mode: str = "events"               # "events" | "fixed" (legacy polling)
    latency_jitter: float = 0.0        # U[0, jitter) extra delay per message
    seed: int = 0                      # RNG seed (jitter + spot waves)
    wake_quantum: float = 0.05         # server wake coalescing granularity
    client_health_interval: float = 1.0   # heartbeat cadence of sim clients
    ready_poll: bool = True            # servers skip endpoints w/o deliveries
    instance_types: dict = field(default_factory=dict)  # kind -> InstanceType
    # chaos/trace layer (see repro_torch.core.trace and SimNetwork):
    record_trace: bool = False         # collect a replayable timing trace
    trace: object = None               # Trace | dict | path: replay mode —
    #   message delays, creation delays, task runtimes and preemptions come
    #   from the recorded trace instead of latency/jitter/RNG parameters


class SimEngine(AbstractEngine):
    def __init__(self, clock: Clock, params: SimParams | None = None, *,
                 loop: EventLoop | None = None, servers_target=SERVERS):
        self.clock = clock
        self.params = params or SimParams()
        # multi-scheduler runs (ShardedSimCluster) share ONE event loop
        # across K engines; each engine then wakes its own servers under
        # a distinct target (e.g. ``(SERVERS, shard_id)``) so the heap
        # routes server wakes to the right shard
        self.servers_target = servers_target
        if loop is None:
            self.loop = EventLoop(clock)
            self.loop.enabled = self.params.mode != "fixed"
        else:
            self.loop = loop
        self.rng = random.Random(self.params.seed)
        # fault/timing plane shared by every wire of this engine
        self.network = transport.SimNetwork(clock)
        if self.params.record_trace:
            self.network.recorder = TraceRecorder()
        if self.params.trace is not None:
            self.network.replayer = TraceReplayer(as_trace(self.params.trace))
        self.pending: dict[str, PendingInstance] = {}
        self.nodes: dict[str, object] = {}      # name -> Client|Server
        self.server_nodes: dict[str, Server] = {}   # subset of nodes
        self.alive: dict[str, bool] = {}
        self._instances: dict[str, float] = {}  # name -> created_at (billing)
        self._stopped_at: dict[str, float] = {}
        self._rates: dict[str, float] = {}      # name -> $/instance-second
        self._kinds: dict[str, str] = {}        # name -> kind (persistent
        #   registry: entries survive termination so instance_kind and
        #   billing_records stay answerable for closed instances)
        # ready-set polling: server-side wire -> earliest pending delivery
        # (servers skip draining endpoints with nothing due)
        self._wire_ready: dict = {}
        self._boot_eps: dict[str, tuple] = {}   # name -> client-side endpoints
        self._to_create: list = []              # (t, kind, name, payload)
        self._last_create = -1e18
        self._primary_eps: dict[str, transport.SimEndpoint] = {}
        self._backup_eps: dict[str, transport.SimEndpoint] = {}
        self._client_eps: dict[str, tuple] = {}
        # handshake is a control-plane wire: no jitter, so an instance's
        # HANDSHAKE is never observed after protocol messages it precedes.
        # It is labelled for trace replay but exempt from partitions (the
        # public partition API only addresses role/client labels)
        hs_srv, hs_cli = transport.sim_link(
            clock, self.params.latency,
            notify_a=self._notify(self.servers_target),
            label_a="control", label_b="instances", network=self.network)
        self.handshake_recv = hs_srv
        self._handshake_send = hs_cli
        self.cost_log: list = []                # (name, start, end, rate)
        # SimCluster clears this when the server config disables backups:
        # without a backup server the two-copy wires are never drained, so
        # minting them only doubles every client send
        self.backup_links = True
        if not self.params.ready_poll:
            # shadow the methods: servers fall back to draining everything
            self.ready_wires = None
            self.endpoint_drained = None

    # ------------------------------------------------------------------
    # event plumbing
    # ------------------------------------------------------------------
    def _notify(self, target):
        if target is None:
            return None
        quantum = self.params.wake_quantum \
            if target == self.servers_target else 0.0

        def cb(t, _target=target, _q=quantum):
            self.loop.wake(_target, t, _q)
        return cb

    def _link(self, recv_a=None, recv_b=None, label_a=None, label_b=None):
        a, b = transport.sim_link(
            self.clock, self.params.latency,
            jitter=self.params.latency_jitter, rng=self.rng,
            notify_a=self._notify(recv_a), notify_b=self._notify(recv_b),
            label_a=label_a, label_b=label_b, network=self.network)
        if recv_a == self.servers_target:
            self._track_server_wire(a)
        if recv_b == self.servers_target:
            self._track_server_wire(b)
        return a, b

    # ------------------------------------------------------------------
    # ready-set endpoint polling (ROADMAP item): every delivery into a
    # server-side wire records the earliest readable time, so the primary
    # (and backup) skip draining client endpoints with nothing due
    # ------------------------------------------------------------------
    def _track_server_wire(self, ep):
        wire = ep.recv_wire
        base = wire.on_deliver

        def cb(t, _w=wire, _base=base):
            cur = self._wire_ready.get(_w)
            if cur is None or t < cur:
                self._wire_ready[_w] = t
            if _base is not None:
                _base(t)
        wire.on_deliver = cb

    def ready_wires(self, now: float) -> list:
        """Server-side wires with a delivery due at or before ``now``.
        Servers map these back to clients through their own ownership
        table and drain only those endpoints — O(due wires) instead of
        O(clients) per step."""
        return [w for w, t in self._wire_ready.items() if t <= now]

    def endpoint_drained(self, ep) -> None:
        wire = getattr(ep, "recv_wire", None)
        if wire is None:
            return
        nxt = wire.next_delivery()
        if nxt is None:
            self._wire_ready.pop(wire, None)
        else:
            self._wire_ready[wire] = nxt   # future deliveries still queued

    # ------------------------------------------------------------------
    # heterogeneous instance types
    # ------------------------------------------------------------------
    def _type_attr(self, kind: str, attr: str):
        itype = self.params.instance_types.get(kind)
        if itype is not None:
            val = getattr(itype, attr)
            if val is not None:
                return val
        return getattr(self.params, attr)

    def preemptible(self, name: str) -> bool:
        itype = self.params.instance_types.get(self._kinds.get(name, ""))
        return itype.preemptible if itype is not None else True

    # ------------------------------------------------------------------
    def now(self) -> float:
        return self.clock.now()

    def create_instance(self, kind, name, payload=None):
        now = self.now()
        if now - self._last_create < self.params.min_create_interval:
            raise RateLimited()
        self._last_create = now
        delay = self._type_attr(kind, "creation_delay")
        if self.network.replayer is not None:
            delay = self.network.replayer.creation_delay(name, delay)
        if self.network.recorder is not None:
            self.network.recorder.record_creation(name, delay)
        due = now + delay
        # Register the pending record at *creation request* time, exactly
        # like LocalEngine/GCEEngine do — the server's max_clients gate
        # counts len(engine.pending), so deferring registration to
        # materialization silently over-creates instances while they boot.
        self._kinds[name] = kind
        if kind.startswith("backup"):
            pb_primary, pb_backup = self._link(recv_a=self.servers_target,
                                               recv_b=self.servers_target,
                                               label_a="primary",
                                               label_b="backup")
            self.pending[name] = PendingInstance(
                name, kind, now, primary_side=pb_primary, payload=payload)
            self._boot_eps[name] = (pb_backup,)
        else:
            p_srv, p_cli = self._link(recv_a=self.servers_target,
                                      recv_b=name,
                                      label_a="primary", label_b=name)
            self._primary_eps[name] = p_srv
            if self.backup_links:
                b_srv, b_cli = self._link(recv_a=self.servers_target,
                                          recv_b=name,
                                          label_a="backup", label_b=name)
                self._backup_eps[name] = b_srv
            else:
                b_srv = b_cli = None
            self.pending[name] = PendingInstance(
                name, kind, now, primary_side=p_srv, backup_side=b_srv)
            self._boot_eps[name] = (p_cli, b_cli)
        heapq.heappush(self._to_create, (due, kind, name, payload))
        self.loop.schedule(due, "materialize")

    def terminate_instance(self, name):
        self.nodes.pop(name, None)
        self.server_nodes.pop(name, None)
        self.alive.pop(name, None)
        self.pending.pop(name, None)
        self._boot_eps.pop(name, None)
        # _kinds is deliberately retained: the registry keeps answering
        # instance_kind / billing_records for terminated instances
        for ep in (self._primary_eps.pop(name, None),
                   self._backup_eps.pop(name, None)):
            if ep is not None:
                self._wire_ready.pop(getattr(ep, "recv_wire", None), None)
        if name in self._instances:
            rate = self._rates.pop(name, self.params.cost_per_instance_second)
            start = self._instances.pop(name)
            min_bill = self._type_attr(self._kinds.get(name, "client"),
                                       "min_billing_s")
            end = max(self.now(), start + min_bill)
            self.cost_log.append((name, start, end, rate))

    def list_instances(self):
        return list(self._instances)

    def primary_endpoints(self, name):
        return self._primary_eps.get(name)

    def backup_endpoint(self, name):
        return self._backup_eps.get(name)

    def rotate_client_channels(self, name):
        """Takeover bookkeeping: the backup-turned-primary now serves the
        client over the old *backup* link, so that link becomes the
        client's primary link and a fresh backup link is minted for the
        next backup server.  Returns the client-side end of the fresh link
        (shipped to the client inside SWAP_QUEUES).  Without this, a
        post-takeover backup would attach to the same endpoint the acting
        primary polls and steal its client messages."""
        old_p = self._primary_eps.get(name)
        if old_p is not None:
            # the dead primary's wire is abandoned: purge its ready mark
            # so ready_wires() stops returning it forever
            self._wire_ready.pop(getattr(old_p, "recv_wire", None), None)
        old_b = self._backup_eps.get(name)
        if old_b is not None:
            self._primary_eps[name] = old_b
            # the promoted link now carries primary traffic: relabel its
            # routes so partitions/traces keyed by role follow the role
            old_b.send_wire.route = ("primary", name)
            old_b.recv_wire.route = (name, "primary")
        b_srv, b_cli = self._link(recv_a=self.servers_target, recv_b=name,
                                  label_a="backup", label_b=name)
        self._backup_eps[name] = b_srv
        return b_cli

    # ------------------------------------------------------------------
    # fault injection: first-class network partitions (per-link,
    # per-direction) — deliveries on dark routes are silently dropped
    # ------------------------------------------------------------------
    def partition(self, a: str, b: str, direction: str = "both",
                  until: float | None = None):
        """Drop messages on the a<->b link.  ``a``/``b`` are role or
        instance labels ("primary", "backup", or a client name);
        ``direction`` is "both", "a2b" (a's sends to b are lost) or
        "b2a".  ``until`` auto-heals the partition at that virtual time
        (a server wake is scheduled so liveness reacts promptly)."""
        if direction not in ("both", "a2b", "b2a"):
            raise ValueError(f"bad partition direction: {direction!r}")
        if direction in ("both", "a2b"):
            self.network.partition(a, b, until)
        if direction in ("both", "b2a"):
            self.network.partition(b, a, until)
        if until is not None:
            self.loop.wake(self.servers_target, until)

    def heal(self, a: str, b: str):
        """Remove both directions of an a<->b partition."""
        self.network.heal(a, b)
        self.network.heal(b, a)
        self.loop.wake(self.servers_target, self.now())

    def link_down(self, a: str, b: str) -> bool:
        """True while either direction of the a<->b link is dark (server
        shells poll this as their partition detector — the simulator
        stand-in for the connection errors a real transport surfaces)."""
        return self.network.link_down(a, b)

    def faults_possible(self) -> bool:
        """Cheap fast-path guard for the shells' link sweeps: False means
        no partition was ever injected (or all were healed), so a
        per-client ``link_down`` sweep cannot find anything.  O(1) and
        conservative (may return True briefly after lazy auto-heal)."""
        return self.network.any_partitions()

    # ------------------------------------------------------------------
    def kill(self, name):
        """Crash an instance: it stops stepping and its links go dark, but
        it remains listed (the VM is still up and billing)."""
        if self.network.recorder is not None and self.alive.get(name, False):
            self.network.recorder.record_preemption(self.now(), name)
        self.alive[name] = False
        node = self.nodes.get(name)
        if node is not None and isinstance(node, Client):
            for ep in (node.primary, node.backup):
                if isinstance(ep, transport.SimEndpoint):
                    ep.brk()

    def materialize_due(self):
        now = self.now()
        while self._to_create and self._to_create[0][0] <= now:
            _, kind, name, payload = heapq.heappop(self._to_create)
            boot = self._boot_eps.pop(name, None)
            if boot is None or name not in self.pending:
                continue   # creation was cancelled while booting
            self._instances[name] = now
            self._rates[name] = self._type_attr(
                kind, "cost_per_instance_second")
            self.alive[name] = True
            if kind.startswith("backup"):
                (pb_backup,) = boot
                srv = Server.from_snapshot(payload, self, name)
                srv.backup_bootstrap(primary_endpoint=pb_backup,
                                     handshake_send=self._handshake_send)
                self.nodes[name] = srv
                self.server_nodes[name] = srv
                self.loop.wake(self.servers_target, now)
            else:
                p_cli, b_cli = boot
                pool = SimWorkerPool(
                    self._type_attr(kind, "client_workers"), self.clock,
                    notify=self._notify(name),
                    runtime_fn=self._task_runtime)
                client = Client(name, p_cli, b_cli, pool,
                                clock=self.clock.now,
                                handshake=self._handshake_send,
                                health_interval=self.params
                                .client_health_interval)
                self.nodes[name] = client
                self.loop.wake(name, now)

    def _task_runtime(self, tid, default: float) -> float:
        """Trace hook: worker pools resolve each task's virtual runtime
        here, so a loaded trace overrides scripted durations and a
        recorder captures the ones actually used."""
        d = default
        if self.network.replayer is not None:
            d = self.network.replayer.runtime(tid, d)
        if self.network.recorder is not None:
            self.network.recorder.record_runtime(tid, d)
        return d

    def _min_billed_end(self, name: str, start: float, now: float) -> float:
        min_bill = self._type_attr(self._kinds.get(name, "client"),
                                   "min_billing_s")
        return max(now, start + min_bill)

    def total_cost(self) -> float:
        now = self.now()
        base = self.params.cost_per_instance_second
        cost = sum((end - start) * rate
                   for _, start, end, rate in self.cost_log)
        cost += sum((self._min_billed_end(name, start, now) - start)
                    * self._rates.get(name, base)
                    for name, start in self._instances.items())
        return cost

    def cost_rate(self, kind: str) -> float:
        return self._type_attr(kind, "cost_per_instance_second")

    def billing_records(self):
        """Exact virtual-clock billing intervals for the CostMeter.  Open
        instances carry their minimum-billing commitment as ``min_end``
        so budget projections see spend that is locked in but not yet
        elapsed (closed intervals were already floored at termination)."""
        base = self.params.cost_per_instance_second
        recs = [(name, self._kinds.get(name, "client"), rate, start, end)
                for name, start, end, rate in self.cost_log]
        for name, start in self._instances.items():
            kind = self._kinds.get(name, "client")
            min_bill = self._type_attr(kind, "min_billing_s")
            recs.append((name, kind, self._rates.get(name, base), start,
                         None, start + min_bill))
        return recs


# ---------------------------------------------------------------------------
# the harness
# ---------------------------------------------------------------------------
class SimCluster:
    """Primary server + engine on a shared virtual clock, with an event
    script: ``at(t, fn)`` callbacks fire once when the clock passes t."""

    def __init__(self, tasks, config: ServerConfig | None = None,
                 params: SimParams | None = None, _internal: bool = False):
        if not _internal:
            warnings.warn(
                "hand-wiring SimCluster(tasks, config, params) is "
                "deprecated; use repro_torch.core.Experiment(tasks, engine='sim', "
                "sim=...) — chaos scripting stays available via the run "
                "handle's .cluster", DeprecationWarning, stacklevel=2)
        self.clock = Clock()
        self.params = params or SimParams()
        self.engine = SimEngine(self.clock, self.params)
        self.loop = self.engine.loop
        self.server = Server(tasks, self.engine, config, _internal=True)
        self.engine.backup_links = self.server.config.use_backup
        self.engine._instances["primary"] = 0.0
        self.engine._kinds["primary"] = "server"
        self.engine._rates["primary"] = self.engine.cost_rate("server")
        self.engine.alive["primary"] = True
        self._script: list = []   # (t, fn) sorted
        self._primary_killed = False
        self.loop.wake(SERVERS, 0.0)
        # trace replay: re-inject the recorded preemptions as scripted
        # kills (the recording run's spot waves / scripted kills are part
        # of the trace, so the replay run must not re-script them)
        if self.engine.network.replayer is not None:
            for t, name in self.engine.network.replayer.preemptions():
                if name == "primary":
                    self.at(t, lambda c: c.kill_primary())
                else:
                    self.at(t, lambda c, _n=name: c.engine.kill(_n))

    def at(self, t: float, fn):
        self._script.append((t, fn))
        self._script.sort(key=lambda x: x[0])
        self.loop.schedule(t, "script")

    # ------------------------------------------------------------------
    # chaos scripting: network partitions (see SimEngine.partition)
    # ------------------------------------------------------------------
    def partition(self, a: str, b: str, direction: str = "both",
                  at: float | None = None, until: float | None = None):
        """Partition the a<->b link, immediately or at virtual time
        ``at``; ``until`` auto-heals."""
        if at is None:
            self.engine.partition(a, b, direction, until)
        else:
            self.at(at, lambda c: c.engine.partition(a, b, direction, until))

    def heal(self, a: str, b: str, at: float | None = None):
        if at is None:
            self.engine.heal(a, b)
        else:
            self.at(at, lambda c: c.engine.heal(a, b))

    # ------------------------------------------------------------------
    # trace record/replay
    # ------------------------------------------------------------------
    def trace(self):
        """The recorded Trace of this run (requires
        ``SimParams(record_trace=True)``)."""
        rec = self.engine.network.recorder
        if rec is None:
            raise ValueError("run with SimParams(record_trace=True) "
                             "to record a trace")
        return rec.build(meta={"makespan_s": self.clock.now(),
                               "seed": self.params.seed})

    def write_trace(self, path: str):
        self.trace().write(path)

    def spot_wave(self, t: float, fraction: float):
        """Script a spot-preemption wave: at time ``t`` kill ``fraction`` of
        the alive preemptible client instances (engine RNG, seeded)."""
        def fn(c):
            eng = c.engine
            victims = [name for name, node in eng.nodes.items()
                       if isinstance(node, Client)
                       and eng.alive.get(name, False)
                       and eng.preemptible(name)]
            k = min(int(round(len(victims) * fraction)), len(victims))
            for name in eng.rng.sample(victims, k):
                eng.kill(name)
        self.at(t, fn)

    def kill_primary(self):
        rec = self.engine.network.recorder
        if rec is not None and self.engine.alive.get("primary", False):
            rec.record_preemption(self.clock.now(), "primary")
        self.engine.alive["primary"] = False
        self._primary_killed = True

    def clients(self) -> list[Client]:
        return [n for n in self.engine.nodes.values()
                if isinstance(n, Client)]

    def servers(self) -> list[Server]:
        """Alive server nodes, keyed by the engine registry (a node's own
        ``name`` attribute becomes "primary*" after takeover and must not
        be used for liveness lookups)."""
        out = []
        if self.engine.alive.get("primary", False):
            out.append(self.server)
        out += [n for key, n in self.engine.server_nodes.items()
                if self.engine.alive.get(key, False)]
        return out

    def acting_primary(self) -> Server | None:
        for key, n in self.engine.server_nodes.items():
            if n.role == "primary" and self.engine.alive.get(key, False):
                return n
        if self.engine.alive.get("primary", False):
            return self.server
        return None

    # ------------------------------------------------------------------
    # discrete-event stepping
    # ------------------------------------------------------------------
    def step(self):
        if self.params.mode == "fixed":
            self._step_fixed()
        else:
            self._step_events()

    def _step_events(self):
        """Jump the clock to the next scheduled event and process every
        event due at that instant, stepping only the nodes concerned."""
        t = self.loop.next_time()
        if t is None:
            # quiescent (nothing scheduled): nudge time forward so callers
            # looping on step() still make progress
            self.clock.advance(self.params.dt)
        else:
            self.clock.advance_to(t)
        now = self.clock.now()
        events = self.loop.pop_due(now)

        # script callbacks fire first (matches the fixed-step loop order)
        while self._script and self._script[0][0] <= now:
            _, fn = self._script.pop(0)
            fn(self)
        self.engine.materialize_due()

        wake_servers = False
        wake_clients: list = []
        for _, _, kind, data in events:
            if kind == "wake":
                if data == SERVERS:
                    wake_servers = True
                else:
                    wake_clients.append(data)
            elif kind in ("script", "materialize"):
                # handled above; a script may also demand a server step
                # (e.g. a kill that the survivors must react to)
                wake_servers = True

        if wake_servers:
            self._step_servers(now)
        for name in wake_clients:
            node = self.engine.nodes.get(name)
            if node is None or not self.engine.alive.get(name, False):
                continue
            node.step()
            self.loop.wake(name, node.next_wake(now))

    def _step_servers(self, now: float):
        nxt = None
        for srv in self.servers():
            srv.step()
            w = srv.next_wake(now)
            nxt = w if nxt is None else min(nxt, w)
        if nxt is not None:
            # intrinsic wakes (heartbeats, creation backoffs) stay exact;
            # only message-delivery wakes are coalesced by wake_quantum
            self.loop.wake(SERVERS, nxt)

    # ------------------------------------------------------------------
    # legacy fixed-dt stepping (semantic reference; O(T/dt * nodes))
    # ------------------------------------------------------------------
    def _step_fixed(self):
        now = self.clock.now()
        while self._script and self._script[0][0] <= now:
            _, fn = self._script.pop(0)
            fn(self)
        self.engine.materialize_due()
        if self.engine.alive.get("primary", False):
            self.server.step()
        for name, node in list(self.engine.nodes.items()):
            if not self.engine.alive.get(name, False):
                continue
            node.step()
        self.clock.advance(self.params.dt)

    def steps(self, until: float = 1e9, max_steps: int = 200_000,
              stop_when_done: bool = True):
        """Generator form of the drive loop: yields after every step —
        ``None`` while running, the done acting primary on the final
        yield (so streaming consumers can observe each step).  Raises
        TimeoutError when the bounds expire with no done primary."""
        events_mode = self.params.mode != "fixed"
        for _ in range(max_steps):
            if events_mode:
                nt = self.loop.next_time()
                if nt is None or nt >= until:
                    break
            elif self.clock.now() >= until:
                break
            self.step()
            if stop_when_done:
                prim = self._done_primary()
                if prim is not None:
                    yield prim
                    return
            yield None
        prim = self._done_primary()
        if prim is not None:
            yield prim
            return
        raise TimeoutError(
            f"simulation did not finish by t={self.clock.now():.1f}")

    def run(self, until: float = 1e9, max_steps: int = 200_000,
            stop_when_done: bool = True) -> Server:
        """Steps until some acting primary reports done. Returns it."""
        for prim in self.steps(until, max_steps, stop_when_done):
            if prim is not None:
                return prim

    def _done_primary(self):
        if self.engine.alive.get("primary", False):
            return self.server if self.server.done else None
        for name, node in self.engine.server_nodes.items():
            if node.role == "primary" \
                    and self.engine.alive.get(name, False) and node.done:
                return node
        return None


# ---------------------------------------------------------------------------
# sharded harness: K primary(+backup) scheduler pairs on ONE event loop
# ---------------------------------------------------------------------------
class ShardedSimCluster:
    """K independent scheduler shards sharing one virtual clock and one
    event heap.  Each shard is a full ``SchedulerCore``/``Server`` stack
    on its own ``SimEngine`` (own network, own fleet, instance names
    namespaced ``s<k>-``), woken under the per-shard target
    ``(SERVERS, k)``; the :class:`repro_torch.core.shard.ShardCoordinator`
    gossips every shard's ``MinHardSet`` frontier to the others after
    each server round, so the domino rule prunes globally exactly as a
    single scheduler would."""

    def __init__(self, tasks, config: ServerConfig | None = None,
                 params: SimParams | None = None, n_shards: int = 2,
                 _internal: bool = False, _resume: dict | None = None):
        if not _internal:
            warnings.warn(
                "hand-wiring ShardedSimCluster is deprecated; use "
                "repro_torch.core.Experiment(tasks, engine='sim', shards=K)",
                DeprecationWarning, stacklevel=2)
        self.params = params or SimParams()
        if self.params.mode == "fixed":
            raise ValueError("sharded simulation requires the event "
                             "engine (SimParams.mode='events')")
        self.clock = Clock()
        self.loop = EventLoop(self.clock)
        self.tasks = list(tasks)
        base = config or ServerConfig()
        if base.min_group_size > 0:
            raise ValueError(
                "min_group_size retention cannot run per shard (a group "
                "split across shards would be dropped wrongly)")
        if _resume is not None:
            n_shards = len(_resume["shards"])
        self.n_shards = int(n_shards)
        if self.n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        if _resume is not None:
            self.shard_indices = [list(ix) for ix in _resume["indices"]]
            self.coordinator = ShardCoordinator.restore(
                _resume["coordinator"])
        else:
            self.shard_indices = partition_tasks(self.tasks, self.n_shards)
            self.coordinator = ShardCoordinator(self.n_shards)
        self.engines: list[SimEngine] = []
        self.servers: list[Server] = []   # the initial primaries (a
        #   shard's *acting* primary moves on takeover — use
        #   acting_primaries() for live lookups)
        self._script: list = []           # (t, fn) sorted
        self._home: dict = {}             # client name -> engine (lazy)
        for k in range(self.n_shards):
            eng = SimEngine(self.clock, self.params, loop=self.loop,
                            servers_target=(SERVERS, k))
            if _resume is not None:
                srv = Server.resume_primary(_resume["shards"][k], eng)
            else:
                cfg = dataclasses.replace(base, name_prefix=f"s{k}-")
                shard_tasks = [self.tasks[i]
                               for i in self.shard_indices[k]]
                srv = Server(shard_tasks, eng, cfg, _internal=True)
            eng.backup_links = srv.config.use_backup
            eng._instances["primary"] = 0.0
            eng._kinds["primary"] = "server"
            eng._rates["primary"] = eng.cost_rate("server")
            eng.alive["primary"] = True
            self.engines.append(eng)
            self.servers.append(srv)
            self.loop.wake(eng.servers_target, 0.0)

    # ------------------------------------------------------------------
    def at(self, t: float, fn):
        """Script a callback ``fn(cluster)`` at virtual time ``t``."""
        self._script.append((t, fn))
        self._script.sort(key=lambda x: x[0])
        self.loop.schedule(t, "script")

    def clients(self) -> list[Client]:
        return [n for eng in self.engines for n in eng.nodes.values()
                if isinstance(n, Client)]

    def shard_servers(self, k: int) -> list[Server]:
        """Alive server nodes of shard ``k`` (initial primary + any
        booted backups/takeover primaries), engine-registry keyed."""
        eng = self.engines[k]
        out = []
        if eng.alive.get("primary", False):
            out.append(self.servers[k])
        out += [n for key, n in eng.server_nodes.items()
                if eng.alive.get(key, False)]
        return out

    def acting_primaries(self) -> dict[int, Server]:
        """shard id -> acting primary, omitting shards mid-takeover."""
        out: dict[int, Server] = {}
        for k, eng in enumerate(self.engines):
            found = None
            for key, n in eng.server_nodes.items():
                if n.role == "primary" and eng.alive.get(key, False):
                    found = n
                    break
            if found is None and eng.alive.get("primary", False):
                found = self.servers[k]
            if found is not None:
                out[k] = found
        return out

    # ------------------------------------------------------------------
    # discrete-event stepping (one heap, K server groups)
    # ------------------------------------------------------------------
    def step(self):
        t = self.loop.next_time()
        if t is None:
            self.clock.advance(self.params.dt)
        else:
            self.clock.advance_to(t)
        now = self.clock.now()
        events = self.loop.pop_due(now)

        while self._script and self._script[0][0] <= now:
            _, fn = self._script.pop(0)
            fn(self)
        for eng in self.engines:
            eng.materialize_due()

        wake_shards: set[int] = set()
        wake_clients: list = []
        for _, _, kind, data in events:
            if kind == "wake":
                if isinstance(data, tuple) and len(data) == 2 \
                        and data[0] == SERVERS:
                    wake_shards.add(data[1])
                else:
                    wake_clients.append(data)
            elif kind in ("script", "materialize"):
                wake_shards.update(range(self.n_shards))

        for k in sorted(wake_shards):
            self._step_shard(k, now)
        if wake_shards:
            # gossip after the server round: publish frontiers that just
            # changed and deliver queued cross-shard prunes promptly
            pump_gossip(self.coordinator, self.acting_primaries())
        for name in wake_clients:
            eng = self._engine_of(name)
            if eng is None:
                continue
            node = eng.nodes.get(name)
            if node is None or not eng.alive.get(name, False):
                continue
            node.step()
            self.loop.wake(name, node.next_wake(now))

    def _step_shard(self, k: int, now: float):
        nxt = None
        for srv in self.shard_servers(k):
            srv.step()
            w = srv.next_wake(now)
            nxt = w if nxt is None else min(nxt, w)
        if nxt is not None:
            self.loop.wake(self.engines[k].servers_target, nxt)

    def _engine_of(self, name) -> SimEngine | None:
        eng = self._home.get(name)
        if eng is not None:
            return eng
        for eng in self.engines:
            if name in eng.nodes or name in eng.pending:
                self._home[name] = eng   # names are never reused, so a
                #   terminated entry just resolves to a dead node (skip)
                return eng
        return None

    # ------------------------------------------------------------------
    def _done_primaries(self) -> dict | None:
        acting = self.acting_primaries()
        if len(acting) == self.n_shards \
                and all(s.done for s in acting.values()):
            return acting
        return None

    def steps(self, until: float = 1e9, max_steps: int = 2_000_000,
              stop_when_done: bool = True):
        """Generator drive loop: yields ``None`` while running and the
        ``{shard: done primary}`` dict on the final yield."""
        for _ in range(max_steps):
            nt = self.loop.next_time()
            if nt is None or nt >= until:
                break
            self.step()
            if stop_when_done:
                acting = self._done_primaries()
                if acting is not None:
                    yield acting
                    return
            yield None
        acting = self._done_primaries()
        if acting is not None:
            yield acting
            return
        raise TimeoutError(
            f"sharded simulation did not finish by t={self.clock.now():.1f}")

    def run(self, until: float = 1e9, max_steps: int = 2_000_000,
            stop_when_done: bool = True) -> dict:
        """Steps until every shard's acting primary is done; returns the
        ``{shard: primary}`` map."""
        for acting in self.steps(until, max_steps, stop_when_done):
            if acting is not None:
                return acting

    def merged_results(self):
        """The per-shard results tables merged back into submission
        order (see :func:`repro_torch.core.shard.merge_results`)."""
        acting = self.acting_primaries()
        tables = [acting[k].final_results if k in acting else None
                  for k in range(self.n_shards)]
        return merge_results(tables, self.shard_indices)

    # ------------------------------------------------------------------
    def serialize_state(self) -> bytes:
        """Snapshot every shard's scheduler core plus the coordinator's
        gossip state — feed to ``Experiment.resume()``."""
        acting = self.acting_primaries()
        missing = [k for k in range(self.n_shards) if k not in acting]
        if missing:
            raise RuntimeError(
                f"shards {missing} have no acting primary (takeover in "
                "flight) — snapshot once a primary is acting")
        return pickle.dumps({
            "version": 1,
            "shards": [acting[k].serialize_state()
                       for k in range(self.n_shards)],
            "indices": [list(ix) for ix in self.shard_indices],
            "coordinator": self.coordinator.snapshot(),
        })


# ---------------------------------------------------------------------------
# scripted tasks for simulation
# ---------------------------------------------------------------------------
class SimTask(AbstractTask):
    """A task with scripted virtual duration; run() returns its fields."""

    def __init__(self, params: tuple, titles: tuple, hardness_values: tuple,
                 sim_duration: float, deadline: float | None = None,
                 result: tuple | None = None,
                 group_titles: tuple | None = None):
        self._params = tuple(params)
        self._titles = tuple(titles)
        self._hard = tuple(hardness_values)
        self.sim_duration = sim_duration
        self._deadline = deadline
        self._result = result if result is not None else (sim_duration,)
        self._group_titles = group_titles

    def parameter_titles(self):
        return self._titles

    def parameters(self):
        return self._params

    def hardness_parameters(self):
        return self._hard

    def result_titles(self):
        return ("value",) * len(self._result) if self._result else ("value",)

    def run(self):
        return self._result

    def timeout(self):
        return self._deadline

    def group_parameter_titles(self):
        if self._group_titles is not None:
            return self._group_titles
        return super().group_parameter_titles()
