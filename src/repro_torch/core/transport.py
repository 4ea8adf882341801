"""Transport abstraction under the server/client protocol.

The paper uses two-way SyncManager queues; we keep that for the local
engine (``MPTransport``) and add a deterministic in-memory transport for
the simulator (``SimTransport``, driven by a virtual clock with optional
latency and scripted link failures).  Server/client code only ever sees
``Channel`` objects, so the *same* protocol code runs under both.
"""
from __future__ import annotations

import collections
import queue as _queue


class Channel:
    """One direction of a two-way link."""

    def send(self, msg) -> None:
        raise NotImplementedError

    def poll(self):
        """Non-blocking receive; returns a Message or None."""
        raise NotImplementedError

    def drain(self, limit: int = 1000) -> list:
        out = []
        for _ in range(limit):
            m = self.poll()
            if m is None:
                break
            out.append(m)
        return out


class Endpoint(Channel):
    """A two-way channel end (send one way, poll the other)."""


# ---------------------------------------------------------------------------
# multiprocessing transport (LocalEngine)
# ---------------------------------------------------------------------------
class MPChannel(Channel):
    def __init__(self, send_q, recv_q):
        self._send = send_q
        self._recv = recv_q

    def send(self, msg):
        self._send.put(msg)

    def poll(self):
        try:
            return self._recv.get_nowait()
        except (_queue.Empty, OSError, EOFError):
            return None


def mp_pipe(manager):
    """Two-way channel pair over a multiprocessing.Manager."""
    q1, q2 = manager.Queue(), manager.Queue()
    return MPChannel(q1, q2), MPChannel(q2, q1)


# ---------------------------------------------------------------------------
# simulated network fault/timing plane (SimEngine)
# ---------------------------------------------------------------------------
class SimNetwork:
    """Shared per-route state for every ``SimWire`` of one engine: the
    partition table (fault injection) and the trace record/replay hooks.

    A *route* is a directed label pair ``(src, dst)``; wires carry their
    route and consult this object on every ``put``.  A dark route drops
    the delivery silently — like a real one-way link loss, the sender
    gets no error and the receiver no event.  Partitions optionally
    auto-heal at ``until`` (lazily: the first query at or past the
    deadline removes the entry, so both the event-driven and the legacy
    fixed-dt loop agree on when a route is dark)."""

    def __init__(self, clock):
        self._clock = clock
        self._dark: dict[tuple, float | None] = {}  # route -> until | None
        self.recorder = None            # TraceRecorder (optional)
        self.replayer = None            # TraceReplayer (optional)
        self.messages_sent = 0          # deliveries accepted onto wires
        #   (benchmark metric: counts every non-dropped put)

    # -- partitions -----------------------------------------------------
    def partition(self, src: str, dst: str, until: float | None = None):
        self._dark[(src, dst)] = until

    def heal(self, src: str, dst: str):
        self._dark.pop((src, dst), None)

    def is_dark(self, route) -> bool:
        if not self._dark:
            return False
        until = self._dark.get(route, "missing")
        if until == "missing":
            return False
        if until is not None and self._clock.now() >= until:
            del self._dark[route]       # lazy auto-heal
            return False
        return True

    def link_down(self, a: str, b: str) -> bool:
        """True when either direction of the a<->b link is dark."""
        return self.is_dark((a, b)) or self.is_dark((b, a))

    def dark_routes(self) -> list:
        return [r for r in list(self._dark) if self.is_dark(r)]

    def any_partitions(self) -> bool:
        """True while any route *might* be dark.  Conservative: an
        expired auto-heal entry counts until a query lazily purges it —
        callers use this as a cheap fast-path guard (skip the per-link
        sweep when no partition was ever injected), never as a per-route
        verdict."""
        return bool(self._dark)

    # -- trace hooks ----------------------------------------------------
    def delay(self, route, default: float) -> float:
        """Per-message delay for ``route``: replayed from a trace when one
        is loaded, otherwise ``default`` (latency + jitter); recorded when
        a recorder is attached."""
        d = default
        if self.replayer is not None and route is not None:
            d = self.replayer.next_delay(route, default)
        if self.recorder is not None and route is not None:
            self.recorder.record_delay(route, d)
        return d


# ---------------------------------------------------------------------------
# simulated transport (SimEngine)
# ---------------------------------------------------------------------------
class SimWire:
    """One-directional wire with latency on a virtual clock.

    ``on_deliver`` (optional) is called with the delivery timestamp of every
    accepted message — the discrete-event engine uses it to wake the
    receiving node exactly when the message becomes readable, instead of
    polling every ``dt``.  ``jitter`` adds U[0, jitter) seconds per message
    from a seeded ``rng`` (delivery order within a wire stays FIFO: a
    message is never readable before its predecessors).  ``route`` labels
    the wire's direction ``(src, dst)`` and ``network`` (a ``SimNetwork``)
    supplies fault injection (dark routes drop deliveries) and trace
    record/replay of per-message delays."""

    def __init__(self, clock, latency: float = 0.0, jitter: float = 0.0,
                 rng=None, on_deliver=None, route=None, network=None):
        self._clock = clock
        self.latency = latency
        self.jitter = jitter
        self._rng = rng
        self._q = collections.deque()   # (deliver_at, msg)
        self.broken = False             # scripted link failure
        self.on_deliver = on_deliver
        self.route = route
        self.network = network

    def put(self, msg):
        if self.broken:
            return  # dropped, like a dead instance's socket
        net = self.network
        # fast paths: skip the partition/trace hooks entirely while no
        # partition was ever injected and no trace is attached — put() is
        # the hottest call of a fleet-scale run (one per message)
        if net is not None and self.route is not None and net._dark \
                and net.is_dark(self.route):
            return  # partitioned: silently dropped, never deferred
        delay = self.latency
        if self.jitter > 0.0 and self._rng is not None:
            delay += self._rng.uniform(0.0, self.jitter)
        if net is not None:
            if net.recorder is not None or net.replayer is not None:
                delay = net.delay(self.route, delay)
            net.messages_sent += 1
        deliver_at = self._clock.now() + delay
        if self._q and self._q[-1][0] > deliver_at:
            deliver_at = self._q[-1][0]   # FIFO: never overtake
        self._q.append((deliver_at, msg))
        if self.on_deliver is not None:
            self.on_deliver(deliver_at)

    def get(self):
        if self._q and self._q[0][0] <= self._clock.now():
            return self._q.popleft()[1]
        return None

    def next_delivery(self) -> float | None:
        """Delivery time of the oldest queued message (None when empty) —
        lets the engine's ready-set tracking skip drained wires."""
        return self._q[0][0] if self._q else None


class SimEndpoint(Endpoint):
    def __init__(self, send_wire: SimWire, recv_wire: SimWire):
        self._send = send_wire
        self._recv = recv_wire

    @property
    def recv_wire(self) -> SimWire:
        return self._recv

    @property
    def send_wire(self) -> SimWire:
        return self._send

    def send(self, msg):
        self._send.put(msg)

    def poll(self):
        return self._recv.get()

    def brk(self):
        self._send.broken = True
        self._recv.broken = True


def sim_link(clock, latency: float = 0.0, jitter: float = 0.0, rng=None,
             notify_a=None, notify_b=None, label_a=None, label_b=None,
             network=None):
    """Returns (endpoint_a, endpoint_b) — a two-way simulated link.

    ``notify_a``/``notify_b`` are delivery callbacks for messages *received*
    by endpoint a / endpoint b respectively (wire direction b->a feeds a).
    ``label_a``/``label_b`` name the two ends for the fault/trace plane:
    the a->b wire gets route ``(label_a, label_b)`` and vice versa."""
    route_ab = route_ba = None
    if label_a is not None and label_b is not None:
        route_ab = (label_a, label_b)
        route_ba = (label_b, label_a)
    ab = SimWire(clock, latency, jitter, rng, on_deliver=notify_b,
                 route=route_ab, network=network)
    ba = SimWire(clock, latency, jitter, rng, on_deliver=notify_a,
                 route=route_ba, network=network)
    return SimEndpoint(ab, ba), SimEndpoint(ba, ab)
