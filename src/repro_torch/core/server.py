"""The primary (and backup) server — a thin shell around SchedulerCore.

The scheduling brain lives in ``repro_torch.core.scheduler`` (pure, typed
events in / typed effects out) with swappable policies in
``repro_torch.core.policy``.  This module is the transport/engine shell:

  * the **primary** polls real channels, feeds each client message and a
    periodic ``Tick`` into the core, and executes the emitted effects
    (sends, instance creation with exponential backoff, terminations),
    plus the engine-facing plumbing the core never sees: handshakes,
    backup creation (freeze -> snapshot -> create), pending-instance
    reaping and peer heartbeats;
  * the **backup** replays the primary's FORWARDed copies into its own
    restored core (mirroring replies on the backup channels), buffers
    the clients' direct copies, and takes over on primary silence —
    takeover is "replay the same event stream into the same core";
  * the ``CostMeter`` is synced from the engine's billing records and
    surfaces as cost columns in the results table.

run-loop actions (paper §"The primary server" b):
  1. health update to the backup,
  2. handshakes from new instances,
  3. client messages (each forwarded to the backup),
  4. instance creation (backup precedence; exponential backoff),
  5. terminate unhealthy instances (+ reassign their tasks),
  6. output results when everything is done.
"""
from __future__ import annotations

import pickle
import warnings

from repro_torch.core.hardness import Hardness
from repro_torch.core.messages import Message, MsgType
from repro_torch.core.policy import CostMeter
from repro_torch.core.results import ResultsTable
from repro_torch.core.scheduler import (ASSIGNED, DONE, FAILED_POOL, PENDING,
                                  PRUNED, TIMED_OUT, ClientInfo,
                                  ClientMessage, CreateInstance,
                                  SchedulerCore, Send, ServerConfig,
                                  TerminateInstance, Tick)

__all__ = [
    "Server", "ServerConfig", "ClientInfo",
    "PENDING", "ASSIGNED", "DONE", "TIMED_OUT", "PRUNED", "FAILED_POOL",
]

# instance-name counter floor applied after restoring any snapshot: the
# snapshotting primary may allocate more names before this server acts
# on the restored core, and colliding instance names would cross wires
_RESTORE_NAME_FLOOR = 10_000


def _restore_core(blob: bytes):
    """Restore a serialized core (see ``Server.serialize_state``).
    Returns (core, replication-stream position)."""
    st = pickle.loads(blob)
    core = SchedulerCore.restore(st["core"])
    core._client_counter = max(core._client_counter, _RESTORE_NAME_FLOOR)
    return core, st.get("rep", 0)


class Server:
    def __init__(self, tasks, engine, config: ServerConfig | None = None,
                 name: str = "primary", role: str = "primary",
                 _internal: bool = False):
        if not _internal:
            warnings.warn(
                "hand-wiring Server(tasks, engine, config) is deprecated; "
                "use repro_torch.core.Experiment(tasks, engine=...) — the facade "
                "wires engines, policies and results identically across "
                "sim/local/gce/tpu", DeprecationWarning, stacklevel=2)
        self.engine = engine
        self.config = config or ServerConfig()
        self.name = name
        self.role = role
        self.core = SchedulerCore(tasks, self.config)
        self._init_shell_state()

    def _init_shell_state(self):
        self.cost_meter = CostMeter()
        self._final_results: ResultsTable | None = None
        self._results_written = False

        # backup coordination
        self.backup_endpoint = None          # primary's channel to backup
        self.backup_name = None
        self.backup_last_health = None
        self.backup_pending = False
        self.frozen = False
        self.primary_endpoint = None         # backup's channel to primary
        self.primary_last_health = None
        self._direct_buffer: dict[str, list[Message]] = {}
        self._deferred_handshakes: list[Message] = []

        # replication-stream numbering: every state-bearing message to the
        # backup (FORWARD / NEW_CLIENT / CLIENT_TERMINATED / BROADCAST)
        # carries a contiguous counter, so a backup behind a partition
        # detects the gap on the first message that gets through and
        # resyncs from a fresh snapshot instead of silently split-braining
        self._rep_seq = 0                    # primary: next number to send
        self._expect_rep = 0                 # backup: next number expected
        self._resync_pending = False
        self._last_resync_req = -1e18

        # client-link partition tracking (LinkLost/LinkHealed into the core)
        self._links_down: set[str] = set()
        self._last_link_poll = -1e18
        self._peer_was_down = False

        # ready-set polling: recv-wire -> client name (and the reverse),
        # so engines that track deliveries let us drain only endpoints
        # with something due instead of sweeping every client
        self._wire_owner: dict = {}
        self._owned_wires: dict[str, object] = {}

        # instance creation backoff
        self._next_create_at = 0.0
        self._backoff = self.config.create_backoff_init
        # server<->server heartbeats go out at health_interval cadence (the
        # same cadence clients use), not once per loop iteration — under the
        # event-driven simulator a per-step heartbeat would wake the peer,
        # whose step sends one back, pinging forever at latency granularity
        self._last_peer_health_sent = -1e18

    # ------------------------------------------------------------------
    # core-state delegation (the core owns all scheduling state)
    # ------------------------------------------------------------------
    @property
    def clients(self) -> dict[str, ClientInfo]:
        return self.core.clients

    @property
    def tasks(self):
        return self.core.tasks

    @property
    def original_index(self):
        return self.core.original_index

    @property
    def status(self):
        return self.core.status

    @property
    def next_ptr(self):
        return self.core.next_ptr

    @property
    def tasks_from_failed(self):
        return self.core.tasks_from_failed

    @property
    def min_hard(self):
        return self.core.min_hard

    @property
    def results(self):
        return self.core.results

    @property
    def attempts(self):
        return self.core.attempts

    @property
    def events(self):
        return self.core.events

    @property
    def done(self) -> bool:
        return self.core.done

    @property
    def final_results(self):
        """Final results table, built lazily on first access once the
        core is done — table building is reporting, not scheduling, so
        it stays out of the run loop (and out of the fleet benchmark's
        measured window)."""
        if self._final_results is None and self.core.done:
            self._final_results = self.output_results()
        return self._final_results

    # ------------------------------------------------------------------
    def now(self) -> float:
        return self.engine.now()

    # ------------------------------------------------------------------
    # ready-set endpoint bookkeeping
    # ------------------------------------------------------------------
    def _own_endpoint(self, ci: ClientInfo):
        wire = getattr(ci.endpoint, "recv_wire", None)
        if wire is not None:
            self._wire_owner[wire] = ci.name
            self._owned_wires[ci.name] = wire

    def _disown_endpoint(self, cname: str):
        wire = self._owned_wires.pop(cname, None)
        if wire is not None:
            self._wire_owner.pop(wire, None)

    def _mark_drained(self, ep):
        """Re-arm or clear an endpoint's ready mark after an
        unconditional drain (server<->server wires are polled directly,
        outside the ready-set path)."""
        drained = getattr(self.engine, "endpoint_drained", None)
        if drained is not None and ep is not None:
            drained(ep)

    def _drain_ready(self, now: float, drain_one):
        """Drain client endpoints with pending deliveries.  ``drain_one``
        is called with each ClientInfo whose endpoint must be polled; with
        an engine that tracks deliveries only the due endpoints are
        visited, otherwise every client is swept."""
        ready = getattr(self.engine, "ready_wires", None)
        drained = getattr(self.engine, "endpoint_drained", None)
        if ready is not None:
            for wire in ready(now):
                cname = self._wire_owner.get(wire)
                if cname is None:
                    continue           # another server's wire
                ci = self.core.clients.get(cname)
                if ci is None or ci.endpoint is None:
                    continue
                drain_one(ci)
                if drained is not None:
                    drained(ci.endpoint)
        else:
            for cname in list(self.core.clients):
                ci = self.core.clients.get(cname)
                if ci is None or ci.endpoint is None:
                    continue
                drain_one(ci)

    # ------------------------------------------------------------------
    # effect execution
    # ------------------------------------------------------------------
    def _send_backup(self, mtype, body: dict):
        """Numbered send on the replication stream (primary -> backup)."""
        if self.backup_endpoint is None:
            return
        body = dict(body)
        body["rep"] = self._rep_seq
        self._rep_seq += 1
        self.backup_endpoint.send(Message(mtype, self.name, body))

    def _apply(self, eff, now: float):
        if isinstance(eff, Send):
            ci = self.core.clients.get(eff.client)
            # the endpoint can be gone already: a backup may learn of a
            # client whose instance the primary terminated while the
            # notification was in flight — the send just goes nowhere,
            # like a deleted VM's queue
            if ci is not None and ci.endpoint is not None:
                ci.endpoint.send(Message(eff.mtype, self.name, eff.body,
                                         srv_seq=eff.srv_seq,
                                         ctrl_seq=eff.ctrl_seq))
        elif isinstance(eff, TerminateInstance):
            self._disown_endpoint(eff.name)
            if self.role == "primary":
                self.engine.terminate_instance(eff.name)
                self._send_backup(MsgType.CLIENT_TERMINATED,
                                  {"name": eff.name})
        elif isinstance(eff, CreateInstance):
            self._execute_create(eff, now)

    def _execute_create(self, eff: CreateInstance, now: float):
        from repro_torch.core.engine import RateLimited

        try:
            self.engine.create_instance(eff.kind, eff.name)
            self._backoff = self.config.create_backoff_init
            self._next_create_at = now + self._backoff
        except RateLimited:
            self._backoff = min(self._backoff * 2,
                                self.config.create_backoff_max)
            self._next_create_at = now + self._backoff

    def process_client_message(self, msg: Message):
        now = self.now()
        for eff in self.core.on_message(msg, now):
            self._apply(eff, now)

    def _broadcast(self, mtype, now: float):
        for eff in self.core.control_broadcast(mtype):
            self._apply(eff, now)
        # the backup mirrors the broadcast (consuming the same ctrl_seq in
        # its own core and re-sending on the backup channels — the clients
        # dedup, and a takeover's ctrl counter stays aligned)
        self._send_backup(MsgType.BROADCAST, {"mtype": mtype})

    def apply_gossip(self, hardness_values) -> int:
        """Inject a batch of cross-shard hardnesses (ShardCoordinator
        gossip) into this server's core and notify its clients — one
        counterless message per client for the whole batch.  Replicated
        to the backup via the BROADCAST replication notice — gossip never
        arrives as a FORWARDable client message, so this is its only path
        into the mirror.  Returns the number of hardnesses that grew the
        frontier (i.e. pruned something new here)."""
        now = self.now()
        retained, effects = self.core.gossip_hardness(
            [Hardness(tuple(hv)) for hv in hardness_values])
        if not retained:
            return 0
        for eff in effects:
            self._apply(eff, now)
        self._send_backup(MsgType.BROADCAST,
                          {"mtype": MsgType.APPLY_DOMINO_EFFECT,
                           "body": {"hardnesses": list(retained)}})
        return len(retained)

    # ------------------------------------------------------------------
    # the run loop (paper §b)
    # ------------------------------------------------------------------
    def step(self):
        if self.role == "primary":
            self._step_primary()
        else:
            self._step_backup()

    def _step_primary(self):
        now = self.now()
        # 1. health update to the backup
        if self.backup_endpoint is not None \
                and now - self._last_peer_health_sent \
                >= self.config.health_interval:
            self.backup_endpoint.send(
                Message(MsgType.HEALTH_UPDATE, self.name))
            self._last_peer_health_sent = now

        # 2. handshakes (while frozen, only the backup's handshake is
        #    accepted — client handshakes are deferred, per the paper's
        #    "stops accepting handshake requests from new client instances")
        self._handle_handshakes()
        # poll backup health (and resync requests after a partition)
        if self.backup_endpoint is not None:
            while True:
                m = self.backup_endpoint.poll()
                if m is None:
                    break
                if m.type == MsgType.HEALTH_UPDATE:
                    self.backup_last_health = now
                elif m.type == MsgType.RESYNC_REQUEST:
                    # the backup missed part of the replication stream
                    # (partitioned pb link): ship a fresh snapshot — it
                    # re-bases on it instead of drifting or split-braining
                    self.backup_endpoint.send(
                        Message(MsgType.SYNC_STATE, self.name,
                                {"state": self.serialize_state()}))
            self._mark_drained(self.backup_endpoint)

        # client-link partition detection -> typed core events
        self._poll_client_links(now)

        # 3. client messages (deferred entirely while frozen so the backup
        #    snapshot + forwarded stream is a consistent replay); engines
        #    with delivery tracking let us visit only endpoints with a
        #    delivery due (ready-set polling) instead of sweeping all
        if not self.frozen:
            self._drain_ready(now, self._drain_primary_endpoint)

        # 4. instance creation (backup takes precedence) + policy tick
        can_create = now >= self._next_create_at
        if can_create and self.config.use_backup \
                and self.backup_endpoint is None and not self.backup_pending:
            self._create_backup(now)
            can_create = False
        for eff in self.core.on_tick(self._make_tick(now, can_create)):
            self._apply(eff, now)

        # 5. reap pending instances that never handshook; backup health
        self._reap_pending(now)
        self._check_backup_health(now)

        # 6. results — the table itself builds lazily on first access of
        #    ``final_results`` (reporting, not scheduling); only the
        #    output-folder side effect stays in the loop
        if self.core.done and self.config.out_dir \
                and not self._results_written:
            self._results_written = True
            self.final_results.write(self.config.out_dir)
            self.core.events.write(self.config.out_dir)

    def _drain_primary_endpoint(self, ci: ClientInfo):
        # the whole burst goes through core.handle_batch as ONE wake:
        # per-client ACK effects coalesce into a single send.  Each
        # message is still FORWARDed individually — the backup replays
        # them one at a time, which is exactly why ACKs are counterless
        # (see SchedulerCore.handle_batch)
        now = self.now()
        batch: list = []
        while True:
            msg = ci.endpoint.poll()
            if msg is None:
                break
            self._send_backup(MsgType.FORWARD, {"msg": msg})
            batch.append(ClientMessage(msg, now))
        if batch:
            for eff in self.core.handle_batch(batch):
                self._apply(eff, now)

    def _poll_client_links(self, now: float):
        """Diff the engine's link-state view of this server's client links
        (at heartbeat cadence) into LinkLost/LinkHealed core events, so
        liveness can grant partition grace.  Engines without a fault plane
        (Local/GCE) simply never report a partition."""
        down_fn = getattr(self.engine, "link_down", None)
        if down_fn is None \
                or now - self._last_link_poll < self.config.health_interval:
            return
        self._last_link_poll = now
        # fleet-scale fast path: nothing is partitioned anywhere and no
        # link is currently suspected — skip the O(clients) sweep
        faults = getattr(self.engine, "faults_possible", None)
        if faults is not None and not self._links_down and not faults():
            return
        label = "primary" if self.role == "primary" else "backup"
        for cname in list(self.core.clients):
            down = down_fn(label, cname)
            if down and cname not in self._links_down:
                self._links_down.add(cname)
                self.core.on_link_lost(cname, now)
            elif not down and cname in self._links_down:
                self._links_down.discard(cname)
                self.core.on_link_healed(cname, now)

    def _make_tick(self, now: float, can_create: bool) -> Tick:
        pending_map = getattr(self.engine, "pending", None) or {}
        pending = len(pending_map)
        pending_clients = sum(
            1 for p in pending_map.values()
            if getattr(p, "kind", "client") == "client")
        accrued = burn = 0.0
        client_rate = 1.0
        if self.config.budget_cap is not None:
            self._sync_meter()
            accrued = self.cost_meter.accrued(now)
            burn = self.cost_meter.burn_rate(now)
            rate_fn = getattr(self.engine, "cost_rate", None)
            if rate_fn is not None:
                client_rate = rate_fn("client")
        return Tick(now, pending_instances=pending,
                    pending_clients=pending_clients, can_create=can_create,
                    accrued_cost=accrued, burn_rate=burn,
                    client_rate=client_rate)

    def _sync_meter(self):
        records = getattr(self.engine, "billing_records", None)
        if records is not None:
            self.cost_meter.sync(records())

    def _handle_handshakes(self):
        todo = self._deferred_handshakes
        self._deferred_handshakes = []
        while True:
            msg = self.engine.handshake_recv.poll()
            if msg is None:
                break
            todo.append(msg)
        for msg in todo:
            if msg.type != MsgType.HANDSHAKE:
                continue
            kind = msg.body["kind"]
            name = msg.sender
            if self.frozen and kind == "client":
                self._deferred_handshakes.append(msg)  # handled post-thaw
                continue
            pending = self.engine.pending.pop(name, None)
            if pending is None:
                continue
            if kind == "client":
                ci = self.core.client_joined(name, self.now(),
                                             endpoint=pending.primary_side)
                self._own_endpoint(ci)
                self._send_backup(MsgType.NEW_CLIENT,
                                  {"name": name, "srv_seq": ci.srv_seq,
                                   "last_client_seq": ci.last_client_seq})
            elif kind == "backup":
                self.backup_endpoint = pending.primary_side
                self.backup_name = name
                self.backup_last_health = self.now()
                self.backup_pending = False
                # register existing clients with the new backup (it starts
                # expecting rep numbers from the counter embedded in the
                # snapshot it restored, which is exactly where we are)
                for cname, ci in self.core.clients.items():
                    self._send_backup(MsgType.NEW_CLIENT,
                                      {"name": cname, "srv_seq": ci.srv_seq,
                                       "last_client_seq": ci.last_client_seq})
                # unfreeze: clients may resume
                self._broadcast(MsgType.RESUME, self.now())
                self.frozen = False

    def _create_backup(self, now: float):
        """Freeze the world, snapshot, create the backup (paper §a)."""
        from repro_torch.core.engine import RateLimited

        try:
            self.frozen = True
            self._broadcast(MsgType.STOP, now)
            snapshot = self.serialize_state()
            name = self.core.alloc_instance_name("backup")
            self.engine.create_instance("backup", name, payload=snapshot)
            self.backup_pending = True
            self._backoff = self.config.create_backoff_init
            self._next_create_at = now + self._backoff
        except RateLimited:
            self._backoff = min(self._backoff * 2,
                                self.config.create_backoff_max)
            self._next_create_at = now + self._backoff
            if self.frozen and self.backup_pending is False:
                # failed to even create the backup: unfreeze and retry later
                self._broadcast(MsgType.RESUME, now)
                self.frozen = False

    def _reap_pending(self, now: float):
        max_na = self.config.instance_max_non_active_time
        for name, pending in list(self.engine.pending.items()):
            if now - pending.created_at > max_na:
                self.engine.terminate_instance(name)
                self.engine.pending.pop(name, None)
                if pending.kind == "backup":
                    self.backup_pending = False
                    if self.frozen:
                        self._broadcast(MsgType.RESUME, now)
                        self.frozen = False

    def _peer_link_down(self) -> bool:
        down_fn = getattr(self.engine, "link_down", None)
        return down_fn is not None and down_fn("primary", "backup")

    def _peer_liveness(self, now: float, last_health):
        """Liveness allowance for the server peer (the pb link), shared by
        backup reaping and takeover: silence behind a *known* partition
        gets partition_grace_s (it explains the silence — killing/taking
        over a live peer would lose state or split-brain), and a heal
        restarts the health window (the peer's first post-heal heartbeat
        may still be in flight).  Returns (limit, last_health)."""
        limit = self.config.health_update_limit
        down = self._peer_link_down()
        if down:
            limit += self.config.partition_grace_s
        elif self._peer_was_down and last_health is not None:
            last_health = max(last_health, now)
        self._peer_was_down = down
        return limit, last_health

    def _check_backup_health(self, now: float):
        limit, self.backup_last_health = \
            self._peer_liveness(now, self.backup_last_health)
        if self.backup_endpoint is not None \
                and self.backup_last_health is not None \
                and now - self.backup_last_health > limit:
            self.engine.terminate_instance(self.backup_name)
            self.backup_endpoint = None
            self.backup_name = None
            self.backup_last_health = None

    # ------------------------------------------------------------------
    def output_results(self) -> ResultsTable:
        now = self.now()
        self._sync_meter()
        task_costs = {
            tid: (t1 - t0) * self.cost_meter.rate_of(cname)
            for tid, (cname, t0, t1) in self.core.task_spans.items()}
        return ResultsTable.build(
            tasks=self.core.tasks,
            original_index=self.core.original_index,
            status=self.core.status,
            results=self.core.results,
            min_group_size=self.config.min_group_size,
            task_costs=task_costs,
            cost=self.cost_meter.summary(now),
        )

    # ------------------------------------------------------------------
    # backup-server machinery (paper §fault tolerance)
    # ------------------------------------------------------------------
    def serialize_state(self) -> bytes:
        # "rep" pins where the replication stream stands at snapshot time:
        # the restoring backup expects the next numbered message from here
        return pickle.dumps({"core": self.core.snapshot(),
                             "rep": self._rep_seq})

    @classmethod
    def from_snapshot(cls, blob: bytes, engine, name: str = "backup"):
        srv = cls.__new__(cls)
        srv.engine = engine
        srv.core, expect_rep = _restore_core(blob)
        srv.config = srv.core.config
        srv.name = name
        srv.role = "backup"
        srv._init_shell_state()
        srv._expect_rep = expect_rep
        return srv

    @classmethod
    def resume_primary(cls, blob: bytes, engine, name: str = "primary"):
        """Resume an interrupted run from a serialized snapshot as a fresh
        *primary* on a fresh engine: solved results and pruning state are
        kept; clients of the old fleet are gone, so their in-flight
        assignments are requeued (at-least-once — a task that finished
        but whose RESULT missed the snapshot re-runs)."""
        srv = cls.from_snapshot(blob, engine, name=name)
        srv.role = "primary"
        now = srv.now()
        for cname in list(srv.core.clients):
            # effects are dropped: the old instances don't exist here
            srv.core.drop_client(cname, now, reassign=True)
        return srv

    def backup_bootstrap(self, primary_endpoint, handshake_send):
        """assume_backup_role: connect to the primary, register clients'
        backup channels, handshake."""
        self.primary_endpoint = primary_endpoint
        self.primary_last_health = self.now()
        for cname, ci in self.core.clients.items():
            ci.endpoint = self.engine.backup_endpoint(cname)
            ci.last_health = self.now()     # liveness clock starts here
            self._own_endpoint(ci)
            self._direct_buffer.setdefault(cname, [])
        handshake_send.send(Message(MsgType.HANDSHAKE, self.name,
                                    body={"kind": "backup"}))

    # message types whose loss desyncs the backup's mirror — all carry a
    # contiguous "rep" number so the first one through after a partition
    # exposes the gap
    _REPLICATED = (MsgType.FORWARD, MsgType.NEW_CLIENT,
                   MsgType.CLIENT_TERMINATED, MsgType.BROADCAST)

    def _request_resync(self, now: float):
        self._resync_pending = True
        self._last_resync_req = now
        self.primary_endpoint.send(
            Message(MsgType.RESYNC_REQUEST, self.name))

    def _apply_sync_state(self, blob: bytes, now: float):
        """Re-base the mirror on a fresh primary snapshot (post-partition
        recovery): restore the core, re-own the clients' backup channels
        and drop buffered direct copies the snapshot already covers."""
        self.core, self._expect_rep = _restore_core(blob)
        self._resync_pending = False
        self._wire_owner.clear()
        self._owned_wires.clear()
        for cname, ci in self.core.clients.items():
            ci.endpoint = self.engine.backup_endpoint(cname)
            ci.last_health = now
            self._own_endpoint(ci)
            buf = self._direct_buffer.get(cname, [])
            self._direct_buffer[cname] = [
                m for m in buf if m.seq > ci.last_client_seq]
        for cname in list(self._direct_buffer):
            if cname not in self.core.clients:
                self._direct_buffer.pop(cname)

    def _step_backup(self):
        now = self.now()
        # health to primary
        if now - self._last_peer_health_sent >= self.config.health_interval:
            self.primary_endpoint.send(
                Message(MsgType.HEALTH_UPDATE, self.name))
            self._last_peer_health_sent = now
        # an unanswered resync request is re-sent at heartbeat cadence
        # (the request itself crosses the same partitioned link)
        if self._resync_pending \
                and now - self._last_resync_req >= self.config.health_interval:
            self._request_resync(now)
        # messages from the primary
        while True:
            m = self.primary_endpoint.poll()
            if m is None:
                break
            if m.type in self._REPLICATED:
                rep = (m.body or {}).get("rep")
                if rep is not None:
                    if self._resync_pending:
                        # stale mirror: everything until SYNC_STATE is
                        # already covered by the snapshot we asked for
                        continue
                    if rep != self._expect_rep:
                        self._request_resync(now)
                        continue
                    self._expect_rep = rep + 1
            if m.type == MsgType.HEALTH_UPDATE:
                self.primary_last_health = now
            elif m.type == MsgType.SYNC_STATE:
                self._apply_sync_state(m.body["state"], now)
                self.primary_last_health = now
            elif m.type == MsgType.FORWARD:
                inner: Message = m.body["msg"]
                self._pop_direct(inner)
                self.process_client_message(inner)
            elif m.type == MsgType.BROADCAST:
                # mirror the primary's control broadcast: consume the same
                # ctrl_seq in our core and re-send on the backup channels
                # (clients dedup whichever copy arrives second)
                bbody = (m.body or {}).get("body")
                if m.body["mtype"] is MsgType.APPLY_DOMINO_EFFECT \
                        and bbody is not None:
                    # cross-shard gossip notice: absorb into the mirror's
                    # min_hard too (the state change is the point; the
                    # replication stream guarantees retained-ness agrees)
                    vals = bbody.get("hardnesses") \
                        or (bbody["hardness"],)
                    _, effects = self.core.gossip_hardness(
                        [Hardness(tuple(v)) for v in vals])
                else:
                    effects = self.core.control_broadcast(m.body["mtype"])
                for eff in effects:
                    self._apply(eff, now)
            elif m.type == MsgType.NEW_CLIENT:
                b = m.body
                ci = self.core.register_client(
                    b["name"], b["srv_seq"], b["last_client_seq"], now,
                    endpoint=self.engine.backup_endpoint(b["name"]))
                self._own_endpoint(ci)
                self._direct_buffer.setdefault(b["name"], [])
            elif m.type == MsgType.CLIENT_TERMINATED:
                self.core.forget_client(m.body["name"])
                self._disown_endpoint(m.body["name"])
                self._direct_buffer.pop(m.body["name"], None)
        self._mark_drained(self.primary_endpoint)
        # client-link partition detection -> typed core events
        self._poll_client_links(now)
        # direct copies from clients -> buffer (a client's endpoint can be
        # None when its instance was deleted while the registration flew)
        def buffer_direct(ci: ClientInfo):
            while True:
                m = ci.endpoint.poll()
                if m is None:
                    break
                if m.seq <= ci.last_client_seq:
                    continue  # processed by primary before the snapshot
                self._direct_buffer.setdefault(ci.name, []).append(m)
                if m.type == MsgType.HEALTH_UPDATE:
                    ci.last_health = now
        self._drain_ready(now, buffer_direct)
        # primary failure -> take over.  Silence across a *known*
        # partition gets partition_grace_s first: taking over while the
        # primary is alive behind a healable link would split-brain —
        # beyond the grace we must assume real death and proceed
        limit, self.primary_last_health = \
            self._peer_liveness(now, self.primary_last_health)
        if now - self.primary_last_health > limit:
            self._take_over()

    def _pop_direct(self, inner: Message):
        buf = self._direct_buffer.get(inner.sender)
        if not buf:
            return
        self._direct_buffer[inner.sender] = [
            m for m in buf if m.key() != inner.key()]

    def _take_over(self):
        """The backup becomes the primary (paper §c)."""
        self.role = "primary"
        self.name = "primary*"
        # swap queues on every client via their (old) primary channels; the
        # engine rotates the channel registry (old backup link -> primary
        # link) and mints a fresh backup link per client, shipped inside
        # SWAP_QUEUES — a later backup must not attach to the endpoint this
        # server now polls, or it would steal client messages
        rotate = getattr(self.engine, "rotate_client_channels", None)
        for cname in self.core.clients:
            ep = self.engine.primary_endpoints(cname)
            new_backup = rotate(cname) if rotate is not None else None
            if ep is not None:
                ep.send(Message(MsgType.SWAP_QUEUES, self.name,
                                {"new_backup": new_backup}))
        # force re-grant verification of every in-flight assignment: if
        # the mirror missed a RESULT (lost FORWARD, no resync before the
        # primary died) the task would otherwise stay ASSIGNED to a client
        # that already finished it.  A client still holding the task just
        # re-ACKs the grant; one that finished re-runs it (at-least-once)
        for ci in self.core.clients.values():
            for tid in ci.assigned:
                ci.unacked[tid] = -1e18
        # process buffered direct messages in order
        for cname in list(self._direct_buffer):
            if cname not in self.core.clients:
                continue
            for m in sorted(self._direct_buffer.pop(cname, []),
                            key=lambda m: m.seq):
                self.process_client_message(m)
        # dangling-instance cleanup: delete instances with no client object.
        # Backup servers are recognized by the engine's kind registry, not
        # by their name (a client named "backup…" must still be reaped).
        known = set(self.core.clients) | {self.name}
        kind_of = getattr(self.engine, "instance_kind", None)
        for iname in self.engine.list_instances():
            if iname in known:
                continue
            kind = kind_of(iname) if kind_of is not None else None
            if kind == "backup" or \
                    (kind is None and iname.startswith("backup")):
                continue   # name-prefix fallback for registry-less engines
            self.engine.terminate_instance(iname)
        self.backup_endpoint = None
        self.backup_name = None
        self.backup_pending = False
        self._resync_pending = False
        # the old primary may have died frozen (mid backup creation, after
        # STOP): release any stopped clients — clients that already
        # resumed dedup the ctrl_seq or no-op on a second RESUME
        self._broadcast(MsgType.RESUME, self.now())

    # ------------------------------------------------------------------
    def next_wake(self, now: float) -> float:
        """Earliest future time this server needs attention absent incoming
        messages: the next heartbeat tick (which also bounds how late the
        liveness checks run) or a pending instance-creation backoff expiry.
        Scheduling hint for the discrete-event simulator only."""
        nxt = now + self.config.health_interval
        if self.role == "primary" and now < self._next_create_at:
            nxt = min(nxt, self._next_create_at)
        return max(nxt, now + 1e-6)

    # ------------------------------------------------------------------
    def run(self, poll_sleep: float = 0.02, stop_when_done: bool = True):
        """Drive the loop with the engine's real clock (LocalEngine/GCE).
        The paper keeps servers alive after results are output; callers who
        want that behaviour pass stop_when_done=False and stop externally.
        """
        import time as _t

        while True:
            self.step()
            if self.done and stop_when_done:
                return self.final_results
            _t.sleep(poll_sleep)
