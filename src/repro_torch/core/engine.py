"""Compute-engine abstraction (paper: "To adapt to a given cloud platform,
one needs to merely provide an extension class with methods to create,
terminate and list compute instances").

Engines shipped:
  * LocalEngine  — real OS processes on this machine (the paper's local
    engine; doubles as the cloud simulation for development).
  * SimEngine    — deterministic virtual-clock simulator with failure
    injection (core/sim.py) used by tests/benchmarks.
  * GCEEngine    — Google Compute Engine via the gcloud CLI (the paper's
    proof-of-concept platform; builds the exact commands, executes them only
    if gcloud is available).
  * TPUPodEngine — TPU pod slices via queued resources (same contract; the
    create/list/delete verbs map onto `gcloud compute tpus queued-resources`).
"""
from __future__ import annotations

import contextlib
import multiprocessing as mp
import os
import shutil
import signal
import subprocess
import time
import warnings
from dataclasses import dataclass

from repro_torch.core import transport


class RateLimited(Exception):
    """Instance creation rejected — caller must back off (paper: exponential
    delays between creation attempts)."""


class EngineUnavailable(Exception):
    pass


@dataclass
class PendingInstance:
    name: str
    kind: str                      # 'client' | 'backup'
    created_at: float
    primary_side: transport.Endpoint | None = None   # server-side endpoint
    backup_side: transport.Endpoint | None = None
    payload: object = None


class AbstractEngine:
    """Creation is asynchronous: the engine starts the instance; the
    instance handshakes with the primary server on the engine's handshake
    channel.  The server polls ``pending`` for endpoint records."""

    def now(self) -> float:
        raise NotImplementedError

    def create_instance(self, kind: str, name: str, payload=None) -> None:
        raise NotImplementedError

    def terminate_instance(self, name: str) -> None:
        raise NotImplementedError

    def list_instances(self) -> list:
        raise NotImplementedError

    # --- instance-kind registry -------------------------------------
    # Engines record the kind passed to create_instance so protocol code
    # (e.g. takeover's dangling-instance cleanup) never has to infer an
    # instance's role from its name.
    def instance_kind(self, name: str) -> str | None:
        return getattr(self, "_kinds", {}).get(name)

    # --- cost accounting ---------------------------------------------
    # ``billing_records()`` yields (name, kind, rate, start, end|None)
    # tuples the server's CostMeter syncs from; ``cost_rate`` is the
    # $/instance-second of one instance of ``kind``.  The base engine
    # bills nothing; concrete engines override (exact virtual-clock
    # accounting on SimEngine, wall-clock proxies on LocalEngine/GCE).
    def billing_records(self) -> list:
        return []

    def cost_rate(self, kind: str) -> float:
        return 1.0

    # --- lifecycle ---------------------------------------------------
    # Every engine is a context manager: ``with engines.make(...) as e``
    # guarantees instances/processes are reaped even when an exception
    # fires between create_instance and an explicit shutdown() call.
    def shutdown(self) -> None:
        """Release engine resources.  Idempotent; base engine holds none."""

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.shutdown()
        return False

    # server-side attach: engines own the handshake channel + endpoint books
    handshake_recv: transport.Channel
    pending: dict

    def primary_endpoints(self, name: str) -> transport.Endpoint:
        """Server-side endpoint of an instance's primary queues (used by a
        backup at takeover to send SWAP_QUEUES — the queues are globally
        addressable, as with SyncManager registration in the paper)."""
        raise NotImplementedError


# ---------------------------------------------------------------------------
# Local engine: real processes (no backup server, as in the paper)
# ---------------------------------------------------------------------------
def _client_process_main(name, primary_send, primary_recv, handshake_q,
                         n_workers):
    from repro_torch.core.client import Client
    from repro_torch.core.workerpool import ProcessWorkerPool

    # own process group: the engine can reap this client *and* the worker
    # processes it spawned with one killpg, even after a hard error path
    with contextlib.suppress(OSError):
        os.setpgrp()
    chan = transport.MPChannel(primary_send, primary_recv)
    hs = transport.MPChannel(handshake_q, handshake_q)
    client = Client(name, chan, backup_channel=None,
                    pool=ProcessWorkerPool(n_workers), clock=time.time,
                    handshake=hs)
    client.run()


class LocalEngine(AbstractEngine):
    """Paper's local engine: each "instance" is a local process using
    ``n_workers_per_client`` worker processes (all CPUs by default)."""

    def __init__(self, n_workers_per_client: int | None = None):
        self._mgr = mp.Manager()
        self._procs: dict[str, mp.Process] = {}
        self.pending: dict[str, PendingInstance] = {}
        self._hq = self._mgr.Queue()
        self.handshake_recv = transport.MPChannel(self._hq, self._hq)
        self.n_workers = n_workers_per_client or max(1, mp.cpu_count())
        self._kinds: dict[str, str] = {}
        self._billing: dict[str, list] = {}   # name -> [kind, rate, t0, t1]

    def now(self) -> float:
        return time.time()

    def create_instance(self, kind, name, payload=None):
        if kind != "client":
            raise EngineUnavailable("LocalEngine runs without a backup server")
        if self._mgr is None:
            raise EngineUnavailable("LocalEngine already shut down")
        q_c2s, q_s2c = self._mgr.Queue(), self._mgr.Queue()
        server_side = transport.MPChannel(q_s2c, q_c2s)  # send s->c, recv c->s
        proc = mp.Process(
            target=_client_process_main,
            args=(name, q_c2s, q_s2c, self._hq, self.n_workers),
            daemon=False)  # clients spawn worker processes (no daemon)
        proc.start()
        self._procs[name] = proc
        self._kinds[name] = kind
        self._billing[name] = [kind, self.cost_rate(kind), self.now(), None]
        self.pending[name] = PendingInstance(
            name, kind, self.now(), primary_side=server_side)

    @staticmethod
    def _kill_group(p: mp.Process, sig) -> bool:
        """Signal the client's whole process group (client + its worker
        processes — the child called setpgrp, so pgid == its pid)."""
        try:
            os.killpg(p.pid, sig)
            return True
        except (ProcessLookupError, PermissionError, OSError):
            return False

    def terminate_instance(self, name):
        p = self._procs.pop(name, None)
        if p is not None:
            if p.is_alive():
                if not self._kill_group(p, signal.SIGTERM):
                    p.terminate()
                p.join(timeout=5)
            if p.is_alive():          # stuck past SIGTERM: escalate
                if not self._kill_group(p, signal.SIGKILL):
                    p.kill()
                p.join(timeout=5)
            else:
                # the client may have died on its own (crash/OOM),
                # orphaning daemon workers in its process group — reap
                # the group regardless (no-op if it is already gone)
                self._kill_group(p, signal.SIGKILL)
        self.pending.pop(name, None)
        rec = self._billing.get(name)
        if rec is not None and rec[3] is None:
            rec[3] = self.now()

    def billing_records(self):
        """Wall-clock proxy billing: one cost unit per instance-second."""
        return [(name, kind, rate, t0, t1)
                for name, (kind, rate, t0, t1) in self._billing.items()]

    def list_instances(self):
        return list(self._procs)

    def shutdown(self):
        for name in list(self._procs):
            self.terminate_instance(name)
        if self._mgr is not None:
            self._mgr.shutdown()
            self._mgr = None


# ---------------------------------------------------------------------------
# GCE engine (the paper's proof of concept) — gcloud CLI contract
# ---------------------------------------------------------------------------
class GCEEngine(AbstractEngine):
    """Command contract follows the paper's config keys.  Execution requires
    the gcloud CLI + network; command *construction* is covered by tests
    against a fake gcloud shim."""

    def __init__(self, config: dict, runner=None):
        required = {"prefix", "project", "zone", "server_image",
                    "client_image", "root_folder", "project_folder"}
        missing = required - set(config)
        if missing:
            raise ValueError(f"GCE config missing keys: {sorted(missing)}")
        self.config = dict(config)
        self._run = runner or self._default_runner
        self.pending: dict[str, PendingInstance] = {}
        self._kinds: dict[str, str] = {}
        self._billing: dict[str, list] = {}   # name -> [kind, rate, t0, t1]
        self._rate_fallback_warned: set[str] = set()

    def now(self) -> float:
        return time.time()

    def cost_rate(self, kind: str) -> float:
        """$/instance-second from the ``cost_rates`` config key (scalar or
        kind->rate mapping).  An unconfigured kind falls back to 1.0 with
        a once-per-kind warning — a silent 1.0 would make real-run cost
        summaries quietly wrong."""
        rates = self.config.get("cost_rates")
        if isinstance(rates, dict):
            if kind in rates:
                return float(rates[kind])
        elif rates is not None:
            return float(rates)
        if kind not in self._rate_fallback_warned:
            self._rate_fallback_warned.add(kind)
            warnings.warn(
                f"{type(self).__name__}: no cost rate configured for "
                f"instance kind {kind!r}; falling back to 1.0 "
                f"$/instance-second — set config['cost_rates'] "
                f"(scalar or {{kind: rate}}) for true cost summaries",
                stacklevel=2)
        return 1.0

    def billing_records(self):
        return [(name, kind, rate, t0, t1)
                for name, (kind, rate, t0, t1) in self._billing.items()]

    @staticmethod
    def _default_runner(cmd: list[str]) -> str:
        if shutil.which(cmd[0]) is None:
            raise EngineUnavailable(f"{cmd[0]} not on PATH")
        return subprocess.run(cmd, check=True, capture_output=True,
                              text=True).stdout

    def _instance_name(self, name: str) -> str:
        return f"{self.config['prefix']}-{name}"

    def create_command(self, kind: str, name: str) -> list[str]:
        image = self.config["server_image"] if kind == "backup" \
            else self.config["client_image"]
        return [
            "gcloud", "compute", "instances", "create",
            self._instance_name(name),
            f"--project={self.config['project']}",
            f"--zone={self.config['zone']}",
            f"--source-machine-image={image}",
        ]

    def delete_command(self, name: str) -> list[str]:
        return [
            "gcloud", "compute", "instances", "delete",
            self._instance_name(name), "--quiet",
            f"--project={self.config['project']}",
            f"--zone={self.config['zone']}",
        ]

    def list_command(self) -> list[str]:
        return [
            "gcloud", "compute", "instances", "list",
            f"--project={self.config['project']}",
            f"--filter=name~^{self.config['prefix']}-",
            "--format=value(name)",
        ]

    def create_instance(self, kind, name, payload=None):
        self._run(self.create_command(kind, name))
        self._kinds[name] = kind
        self._billing[name] = [kind, self.cost_rate(kind), self.now(), None]
        self.pending[name] = PendingInstance(name, kind, self.now())

    def terminate_instance(self, name):
        self._run(self.delete_command(name))
        self.pending.pop(name, None)
        rec = self._billing.get(name)
        if rec is not None and rec[3] is None:
            rec[3] = self.now()

    def list_instances(self):
        out = self._run(self.list_command())
        prefix = self.config["prefix"] + "-"
        return [line[len(prefix):] for line in out.splitlines() if line]

    def shutdown(self):
        """Best-effort: delete every instance this engine created whose
        billing interval is still open (real VMs keep billing after the
        driver process dies — the context-manager exit is the backstop)."""
        for name, rec in list(self._billing.items()):
            if rec[3] is None:
                try:
                    self.terminate_instance(name)
                except Exception as e:   # noqa: BLE001 — best-effort reap
                    warnings.warn(f"shutdown: could not delete instance "
                                  f"{name!r}: {e}", stacklevel=2)


class TPUPodEngine(GCEEngine):
    """TPU pod slices via queued resources: same create/terminate/list
    contract, different verbs.  ``accelerator_type`` e.g. 'v5litepod-256'
    — one ExpoCloud 'instance' == one pod slice == one mesh job."""

    def __init__(self, config: dict, runner=None):
        config = dict(config)
        config.setdefault("accelerator_type", "v5litepod-256")
        config.setdefault("runtime_version", "v2-alpha-tpuv5-lite")
        super().__init__(config, runner=runner)

    def create_command(self, kind, name):
        return [
            "gcloud", "compute", "tpus", "queued-resources", "create",
            self._instance_name(name),
            f"--project={self.config['project']}",
            f"--zone={self.config['zone']}",
            f"--accelerator-type={self.config['accelerator_type']}",
            f"--runtime-version={self.config['runtime_version']}",
            f"--node-id={self._instance_name(name)}",
        ]

    def delete_command(self, name):
        return [
            "gcloud", "compute", "tpus", "queued-resources", "delete",
            self._instance_name(name), "--quiet", "--force",
            f"--project={self.config['project']}",
            f"--zone={self.config['zone']}",
        ]

    def list_command(self):
        return [
            "gcloud", "compute", "tpus", "queued-resources", "list",
            f"--project={self.config['project']}",
            f"--zone={self.config['zone']}",
            f"--filter=name~{self.config['prefix']}-",
            "--format=value(name)",
        ]
