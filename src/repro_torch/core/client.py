"""The client (paper §"The clients").

Main-loop actions per iteration (paper order):
  1. send health update to the servers,
  2. process worker events,
  3. request tasks subject to idle workers (counting outstanding requests),
  4. process messages from the primary (and dedup the backup's mirrors),
  5. start workers for granted tasks,
plus timeout enforcement (terminate + REPORT_HARD_TASK) and the domino
effect.  Exits when NO_FURTHER_TASKS was received and all workers are done;
sends BYE so the server can delete this instance (cost saving).
"""
from __future__ import annotations

import collections
import heapq
import time

from repro_torch.core.hardness import Hardness
from repro_torch.core.messages import Message, MsgType
from repro_torch.core.workerpool import WorkerEvent


class Client:
    def __init__(self, name, primary_channel, backup_channel, pool, clock,
                 handshake=None, health_interval: float = 1.0,
                 request_retry: float = 8.0):
        self.name = name
        self.primary = primary_channel
        self.backup = backup_channel
        self.pool = pool
        # zero-copy running view when the pool offers one (hot-path
        # sweeps run every step; copying the dict three times per wake
        # dominated fleet-scale client cost)
        self._pool_running = getattr(pool, "running_ref", pool.running)
        self._drain_started = getattr(pool, "drain_started", None)
        # grant receipts acknowledged this step; flushed with the started
        # tids as one "lifecycle" LOG after phase 5 instead of one wire
        # message per GRANT
        self._granted_pending: list[int] = []
        self.clock = clock
        self.health_interval = health_interval
        self._last_health = -1e18
        # outstanding task requests are presumed lost (one-way link loss
        # drops GRANTs silently) after this long and re-issued; grants
        # normally settle within ~2 RTT so healthy runs never retry
        self.request_retry = request_retry
        self._last_request = -1e18

        self.tasks: dict[int, object] = {}     # tid -> task (granted)
        self.queue: collections.deque[int] = collections.deque()  # granted,
        #   not yet started (deque: starts pop from the front in O(1))
        # (deadline, tid) min-heap of running tasks' timeout instants —
        # the per-step sweep and next_wake pop/peek this instead of
        # scanning every running task every wake.  Entries go stale when
        # a task completes or is terminated (domino/regrant); consumers
        # verify against the live running set and drop or re-push
        self._deadline_heap: list[tuple[float, int]] = []
        self.outstanding = 0                   # requested, not yet granted
        self.no_further = False
        self.stopped = False
        self.finished = False

        # two-copy dedup state (srv_seq: per-client sends; ctrl_seq:
        # control broadcasts — separate counter spaces, separate sets)
        self._processed_srv_seqs: set[int] = set()
        self._processed_ctrl_seqs: set[int] = set()
        self._backup_buffer: list[Message] = []

        # at-least-once delivery for state-bearing reports: RESULT /
        # REPORT_HARD_TASK / EXCEPTION stay in the outbox (same Message,
        # same seq — the server's handling is idempotent) and are re-sent
        # until the server ACKs them, so a partition that swallows a
        # RESULT cannot strand its task in ASSIGNED forever
        self._outbox: dict[int, list] = {}     # msg.seq -> [Message, t_sent]

        if handshake is not None:
            handshake.send(Message(MsgType.HANDSHAKE, self.name,
                                   body={"kind": "client"}))

    # ------------------------------------------------------------------
    _NEEDS_ACK = (MsgType.RESULT, MsgType.REPORT_HARD_TASK,
                  MsgType.EXCEPTION)

    def send_to_servers(self, mtype, body=None):
        msg = Message(mtype, self.name, body)
        self.primary.send(msg)
        if self.backup is not None:
            self.backup.send(msg)    # the copy (same seq) for the backup
        if mtype in self._NEEDS_ACK:
            self._outbox[msg.seq] = [msg, self.clock()]

    # ------------------------------------------------------------------
    def step(self) -> bool:
        """One main-loop iteration; returns True when the client is done."""
        now = self.clock()
        # 1. health updates (sent even while STOPped — paper)
        if now - self._last_health >= self.health_interval:
            self.send_to_servers(MsgType.HEALTH_UPDATE)
            self._last_health = now

        # 2. worker events — uploads are batched per wake: lifecycle LOGs
        #    as one {"tids": [...]} message and RESULTs as one
        #    {"results": [[tid, result], ...]} message riding a single
        #    at-least-once outbox entry (the server's per-item handling is
        #    idempotent, so a retried batch just re-applies no-ops).
        #    EXCEPTION stays per-task (rare, carries a traceback payload).
        #    No separate "done" LOG rides the wire: the server synthesizes
        #    the log entry from the RESULT batch itself
        started: list = []
        results: list = []
        for ev in self.pool.poll():
            if ev.kind == WorkerEvent.STARTED:
                started.append(ev.task_id)
            elif ev.kind == WorkerEvent.DONE:
                results.append((ev.task_id, ev.payload))
                self.tasks.pop(ev.task_id, None)
            elif ev.kind == WorkerEvent.ERROR:
                self.send_to_servers(MsgType.EXCEPTION,
                                     {"tid": ev.task_id, "error": ev.payload})
                self.tasks.pop(ev.task_id, None)
        if results:
            self.send_to_servers(MsgType.RESULT, {"results": results})
        # the "started" LOG is sent after phase 5, so tasks started later
        # this same step (sim pools drain synchronously) ride along

        # 6 (interleaved). timeout enforcement: pop due entries off the
        # deadline heap instead of scanning every running task every wake
        # (collect first, mutate after).  A popped entry is re-verified
        # against the live running set — completed/terminated tasks left
        # stale entries, and a re-granted task's fresh start time gets a
        # corrected entry pushed back
        timed_out = None
        heap = self._deadline_heap
        if heap and heap[0][0] < now:
            running = self._pool_running()
            while heap and heap[0][0] < now:
                _, tid = heapq.heappop(heap)
                task = self.tasks.get(tid)
                if task is None:
                    continue
                t0 = running.get(tid)
                if t0 is None:
                    continue
                deadline = task.timeout()
                if deadline is None:
                    continue
                if now - t0 > deadline:
                    if timed_out is None:
                        timed_out = []
                    timed_out.append((tid, task))
                else:
                    heapq.heappush(heap, (t0 + deadline, tid))
        if timed_out:
            for tid, task in timed_out:
                self.pool.terminate(tid)
                self.tasks.pop(tid, None)
            # one batched report + one batched LOG for the whole sweep
            self.send_to_servers(
                MsgType.REPORT_HARD_TASK,
                {"reports": [(tid, task.hardness().values)
                             for tid, task in timed_out]})
            self.send_to_servers(
                MsgType.LOG,
                {"event": "timeout", "tids": [tid for tid, _ in timed_out]})

        # 2b. re-send unacknowledged reports (lost to a partition)
        for _seq, entry in list(self._outbox.items()) if self._outbox else ():
            msg, t_sent = entry
            if now - t_sent > self.request_retry:
                self.primary.send(msg)
                if self.backup is not None:
                    self.backup.send(msg)
                entry[1] = now

        # 3. request tasks (an unanswered request eventually retries —
        #    its GRANT may have been lost to a partition)
        if not self.stopped and not self.no_further:
            if self.outstanding > 0 \
                    and now - self._last_request > self.request_retry:
                self.outstanding = 0
            want = self.pool.idle() - self.outstanding - len(self.queue)
            if want > 0:
                self.send_to_servers(MsgType.REQUEST_TASKS, {"n": want})
                self.outstanding += want
                self._last_request = now

        # 4. process messages
        while True:
            msg = self.primary.poll()
            if msg is None:
                break
            self._act(msg)
        if self.backup is not None:
            while True:
                msg = self.backup.poll()
                if msg is None:
                    break
                self._buffer_backup(msg)

        # 5. start workers
        if not self.stopped:
            while self.queue and self.pool.idle() > 0:
                tid = self.queue.popleft()
                task = self.tasks.get(tid)
                if task is not None:
                    self.pool.start(tid, task)
                    deadline = task.timeout()
                    if deadline is not None:
                        heapq.heappush(self._deadline_heap,
                                       (now + deadline, tid))
        # sim pools surface STARTED synchronously (drain_started) so the
        # lifecycle LOG for tasks started *this* step goes out now rather
        # than one wake later; process pools report via phase 2 instead
        if self._drain_started is not None:
            started.extend(self._drain_started())
        # one combined lifecycle LOG per wake: grant receipts (phase 4)
        # and worker starts (phase 5) ride the same message
        if started or self._granted_pending:
            granted_ack = self._granted_pending
            self._granted_pending = []
            self.send_to_servers(MsgType.LOG,
                                 {"event": "lifecycle",
                                  "granted": granted_ack,
                                  "started": started})

        # exit condition (pending un-ACKed reports hold the client alive:
        # saying BYE before the server confirmed receipt loses results)
        if self.no_further and not self.queue and not self.tasks \
                and not self._pool_running() and not self._outbox \
                and not self.finished:
            self.send_to_servers(MsgType.BYE)
            self.finished = True
        return self.finished

    def run(self, poll_sleep: float = 0.02):
        while not self.step():
            time.sleep(poll_sleep)
        self.pool.shutdown()

    def next_wake(self, now: float) -> float:
        """Earliest future time this client needs attention absent incoming
        messages or worker completions: the next health heartbeat or the
        earliest running task's deadline.  Scheduling hint for the
        discrete-event simulator; no effect on protocol semantics."""
        nxt = self._last_health + self.health_interval
        next_done = getattr(self.pool, "next_completion", lambda: None)()
        if next_done is not None:
            nxt = min(nxt, next_done)
        # earliest plausible deadline: peek the heap, lazily dropping
        # entries whose task is gone.  A stale-early entry (re-granted
        # task) only wakes the client sooner than needed — the sweep
        # re-verifies and corrects it
        heap = self._deadline_heap
        running = self._pool_running() if heap else None
        while heap:
            dl, tid = heap[0]
            if tid not in self.tasks or tid not in running:
                heapq.heappop(heap)
                continue
            # timeout check is strict (now - t0 > deadline)
            nxt = min(nxt, dl + 1e-6)
            break
        return max(nxt, now + 1e-6)

    # ------------------------------------------------------------------
    def _buffer_backup(self, msg: Message):
        if msg.type == MsgType.SWAP_QUEUES:
            # arrives on the backup-turned-primary path too; handle directly
            self._act(msg)
            return
        if msg.srv_seq is None and msg.ctrl_seq is None:
            # counterless plane (ACKs, domino broadcasts): no counter to
            # match a primary copy against, so act on the mirror
            # immediately — outbox pops and frontier unions are
            # idempotent, and buffering would accumulate them forever
            self._act(msg)
            return
        if msg.srv_seq is not None and msg.srv_seq in self._processed_srv_seqs:
            return  # mirror of an already-processed primary message: pop
        if msg.ctrl_seq is not None \
                and msg.ctrl_seq in self._processed_ctrl_seqs:
            return  # mirror of an already-processed control broadcast
        self._backup_buffer.append(msg)

    def _act(self, msg: Message):
        if msg.ctrl_seq is not None:
            if msg.ctrl_seq in self._processed_ctrl_seqs:
                return
            self._processed_ctrl_seqs.add(msg.ctrl_seq)
            self._backup_buffer = [
                m for m in self._backup_buffer
                if m.ctrl_seq != msg.ctrl_seq]
        elif msg.srv_seq is not None:
            if msg.srv_seq in self._processed_srv_seqs:
                return
            self._processed_srv_seqs.add(msg.srv_seq)
            # pop any buffered mirror of this message
            self._backup_buffer = [
                m for m in self._backup_buffer
                if m.srv_seq != msg.srv_seq]
        t = msg.type
        if t == MsgType.ACK:
            # single {"seq": n} (backup mirror / unbatched) or coalesced
            # {"seqs": [...]} (primary's per-wake batch) — both idempotent
            body = msg.body or {}
            for seq in body.get("seqs") or (body.get("seq"),):
                self._outbox.pop(seq, None)
        elif t == MsgType.GRANT_TASKS:
            # the server may piggyback ACKed seqs on the grant (same-wake
            # coalescing) — idempotent outbox pops, mirror-safe
            for seq in msg.body.get("acks") or ():
                self._outbox.pop(seq, None)
            granted = msg.body["tasks"]   # list[(tid, task)]
            # The server echoes how many tasks the request asked for; a
            # partial grant (fewer tasks than requested) must still settle
            # the whole request, otherwise the shortfall stays counted as
            # outstanding forever and this client under-requests for the
            # rest of the run, idling workers.
            requested = msg.body.get("requested", len(granted))
            self.outstanding = max(0, self.outstanding - requested)
            for tid, task in granted:
                if tid in self.tasks:
                    continue   # re-granted while the original survived
                self.tasks[tid] = task
                self.queue.append(tid)
            # receipt is flushed after phase 5 in the combined
            # "lifecycle" LOG (one wire message per wake, not per grant)
            self._granted_pending.extend(tid for tid, _ in granted)
        elif t == MsgType.NO_FURTHER_TASKS:
            for seq in (msg.body or {}).get("acks") or ():
                self._outbox.pop(seq, None)
            self.no_further = True
            self.outstanding = 0
        elif t == MsgType.APPLY_DOMINO_EFFECT:
            # single {"hardness": (...)} (backup mirror / unbatched) or
            # coalesced {"hardnesses": [...]} (per-wake batch / gossip
            # pump) — both idempotent frontier unions
            body = msg.body or {}
            hs = [Hardness(tuple(v))
                  for v in body.get("hardnesses") or (body["hardness"],)]
            for tid in list(self.pool.running()):
                task = self.tasks.get(tid)
                if task is not None \
                        and any(task.hardness().geq(h) for h in hs):
                    self.pool.terminate(tid)
                    self.tasks.pop(tid, None)
                    self.send_to_servers(
                        MsgType.LOG, {"event": "dominoed", "tid": tid})
            for tid in list(self.queue):
                task = self.tasks.get(tid)
                if task is not None \
                        and any(task.hardness().geq(h) for h in hs):
                    self.queue.remove(tid)
                    self.tasks.pop(tid, None)
        elif t == MsgType.STOP:
            self.stopped = True
        elif t == MsgType.RESUME:
            self.stopped = False
        elif t == MsgType.SWAP_QUEUES:
            # the backup became the primary: swap the channel pair and
            # process the backup's buffered (unmatched) messages in order.
            # The message carries a fresh backup-channel end (the engine
            # re-registered the queues) — pointing `backup` at the old
            # object would double-send every message to the new primary.
            if self.backup is not None:
                self.primary = self.backup
            self.backup = (msg.body or {}).get("new_backup")
            buffered, self._backup_buffer = self._backup_buffer, []
            # control broadcasts (srv_seq None) sort ahead of data sends;
            # within each space the counters give the true order
            for m in sorted(buffered,
                            key=lambda m: (0, m.ctrl_seq or 0)
                            if m.srv_seq is None else (1, m.srv_seq)):
                self._act(m)
