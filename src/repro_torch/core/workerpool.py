"""Worker pools: one worker per task (paper: "a client creates and manages
worker processes; each worker is responsible for executing a single task").

``ProcessWorkerPool`` uses real OS processes (LocalEngine / cloud clients);
``SimWorkerPool`` executes tasks on the virtual clock using each task's
``sim_duration`` attribute (deterministic tests/benchmarks).
"""
from __future__ import annotations

import multiprocessing as mp
import queue as _queue
import time
import traceback


class WorkerEvent:
    STARTED = "WORKER_STARTED"
    DONE = "WORKER_DONE"
    ERROR = "WORKER_ERROR"

    __slots__ = ("kind", "task_id", "payload")

    def __init__(self, kind, task_id, payload=None):
        self.kind = kind
        self.task_id = task_id
        self.payload = payload


def _worker_main(task_id, task, q):
    q.put(WorkerEvent(WorkerEvent.STARTED, task_id))
    try:
        result = task.run()
        q.put(WorkerEvent(WorkerEvent.DONE, task_id, result))
    except BaseException as e:  # noqa: BLE001 — reported upstream
        q.put(WorkerEvent(WorkerEvent.ERROR, task_id,
                          f"{type(e).__name__}: {e}\n{traceback.format_exc()}"))


class ProcessWorkerPool:
    def __init__(self, n_workers: int):
        self.n_workers = n_workers
        self._q = mp.Queue()
        self._procs: dict[int, mp.Process] = {}
        self._started: dict[int, float] = {}

    def idle(self) -> int:
        return self.n_workers - len(self._procs)

    def running(self) -> dict[int, float]:
        return dict(self._started)

    def running_ref(self) -> dict[int, float]:
        """Internal start-time map, NOT copied — read-only view for hot
        paths that only scan (the client's per-step timeout sweep)."""
        return self._started

    def start(self, task_id: int, task) -> None:
        p = mp.Process(target=_worker_main, args=(task_id, task, self._q),
                       daemon=True)
        p.start()
        self._procs[task_id] = p
        self._started[task_id] = time.time()

    def poll(self) -> list[WorkerEvent]:
        events = []
        while True:
            try:
                ev = self._q.get_nowait()
            except _queue.Empty:
                break
            events.append(ev)
            if ev.kind in (WorkerEvent.DONE, WorkerEvent.ERROR):
                self._reap(ev.task_id)
        # reap processes that died without reporting (hard crash)
        for tid, p in list(self._procs.items()):
            if not p.is_alive():
                p.join(timeout=1)
                self._reap(tid)
                events.append(WorkerEvent(WorkerEvent.ERROR, tid,
                                          "worker died (no report)"))
        return events

    def terminate(self, task_id: int) -> None:
        p = self._procs.get(task_id)
        if p is not None and p.is_alive():
            p.terminate()
            p.join(timeout=5)
        self._reap(task_id)

    def _reap(self, task_id):
        self._procs.pop(task_id, None)
        self._started.pop(task_id, None)

    def shutdown(self):
        for tid in list(self._procs):
            self.terminate(tid)


class SimWorkerPool:
    """Virtual-clock pool: each task must carry ``sim_duration`` (seconds of
    virtual time); completion fires when the clock passes start+duration.

    ``notify`` (optional, set by the discrete-event engine) is called with
    the timestamp of every scheduled completion so the owning client is
    woken exactly then instead of being polled every ``dt``.
    ``runtime_fn(task_id, default)`` (optional) resolves the virtual
    duration — the engine's trace record/replay hook."""

    def __init__(self, n_workers: int, clock, notify=None, runtime_fn=None):
        self.n_workers = n_workers
        self._clock = clock
        self._running: dict[int, tuple] = {}   # id -> (task, start, end)
        self._running_view: dict | None = None  # lazy running_ref() cache
        self._next_end: float | None = None     # lazy min-end cache
        self._pending_started: list[int] = []
        self.notify = notify
        self.runtime_fn = runtime_fn

    def idle(self) -> int:
        return self.n_workers - len(self._running)

    def running(self) -> dict[int, float]:
        return {tid: t0 for tid, (_, t0, _) in self._running.items()}

    def running_ref(self):
        """Read-only {tid: t0} view for hot paths.  Built lazily and
        invalidated on every start/terminate/poll-completion — the
        client's per-step sweeps would otherwise rebuild the dict three
        times per wake."""
        if self._running_view is None:
            self._running_view = {tid: t0 for tid, (_, t0, _)
                                  in self._running.items()}
        return self._running_view

    def next_completion(self) -> float | None:
        """Earliest scheduled completion time, or None when idle (used by
        the client's next_wake hint and poll()'s nothing-due fast path).
        Cached; invalidated whenever the running set changes."""
        if self._next_end is None and self._running:
            self._next_end = min(end for _, _, end in self._running.values())
        return self._next_end

    def start(self, task_id: int, task) -> None:
        now = self._clock.now()
        dur = getattr(task, "sim_duration", 1.0)
        if self.runtime_fn is not None:
            dur = self.runtime_fn(task_id, dur)
        self._running[task_id] = (task, now, now + dur)
        self._running_view = None
        if self._next_end is not None and now + dur < self._next_end:
            self._next_end = now + dur
        self._pending_started.append(task_id)
        if self.notify is not None:
            # completion wake only: the client drains STARTED events
            # synchronously via drain_started() in the same step that
            # started the workers, so no extra wake is needed for them
            self.notify(now + dur)

    def drain_started(self) -> list[int]:
        """Pop and return tids whose STARTED event is pending — called by
        the client right after starting workers so the lifecycle LOG goes
        out in the same step instead of one wake later."""
        out = self._pending_started
        self._pending_started = []
        return out

    def poll(self) -> list[WorkerEvent]:
        now = self._clock.now()
        if not self._pending_started:
            # nothing-due fast path: most wakes deliver messages, not
            # completions — skip the running-set scan entirely
            nxt = self.next_completion()
            if nxt is None or now < nxt:
                return []
        events = [WorkerEvent(WorkerEvent.STARTED, tid)
                  for tid in self._pending_started]
        self._pending_started.clear()
        completed = False
        for tid, (task, _t0, t_end) in list(self._running.items()):
            if now >= t_end:
                completed = True
                del self._running[tid]
                self._running_view = None
                try:
                    result = task.run()
                except BaseException as e:  # noqa: BLE001
                    events.append(WorkerEvent(WorkerEvent.ERROR, tid, str(e)))
                else:
                    events.append(WorkerEvent(WorkerEvent.DONE, tid, result))
        if completed:
            self._next_end = None
        return events

    def terminate(self, task_id: int) -> None:
        self._running.pop(task_id, None)
        self._running_view = None
        self._next_end = None

    def shutdown(self):
        self._running.clear()
        self._running_view = None
        self._next_end = None
