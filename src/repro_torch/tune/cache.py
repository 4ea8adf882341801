"""Persistent best-config cache for the port's tuned kernel parameters.

Entries are keyed by ``(kernel, shape_bucket, dtype, backend)``:

* ``kernel``  — the ops-layer name (``flash_attention``, ``ssd_scan``,
  ``decode_attention``, ``decode_attention_paged``);
* ``shape_bucket`` — every shape field rounded up to a power of two
  (``b1-s256-h4-kvh2-d64``), so nearby shapes share an entry;
* ``dtype``   — the input dtype's name (``bfloat16``, ``float32``);
* ``backend`` — the route the entry applies to (``dispatch_backend``):
  ``cpu`` for the plain versions, ``cuda:<device name>`` for the kernels
  on a card, so a tuning taken on one card model is never served on
  another.

The store is a single versioned JSON file.  Writes are atomic (temp file
in the same directory + ``os.replace``), so a crash mid-write can never
corrupt a previously-good cache.  Every entry records a hash of the
kernel's wrapper module together with its CUDA source and the headers that
source includes; a lookup against a since-edited kernel is a miss (stale
tunings are never served).  ``REPRO_TORCH_TUNE_CACHE`` overrides the cache
path (empty or ``0`` disables the cache entirely); the default lives under
``~/.cache/repro_torch/tune_cache.json``.

This module imports nothing from ``repro_torch`` (nor torch) at module
level: ``kernels/ops.py`` consults it on every dispatch, so it must be
cheap and cycle-free to import.  It must be cheap to call, too: the
reference consults its cache while jit traces, once a compile, but the
port's eager ops consult it on every call.  So a cache checks its file's
mtime at most once every ``REFRESH_S`` (a stat is a system call, which a
sandboxed host makes dear) and memoizes each lookup's answer until its
entries change.
"""
from __future__ import annotations

import contextlib
import functools
import hashlib
import importlib.util
import json
import math
import os
import re
import tempfile
import time
from pathlib import Path

CACHE_VERSION = 1
ENV_VAR = "REPRO_TORCH_TUNE_CACHE"
DEFAULT_PATH = os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                            "tune_cache.json")

# kernel name -> (wrapper module, CUDA source under its package's csrc/);
# the hash of both (and the source's headers) gates entry staleness
KERNEL_SOURCES = {
    "flash_attention": ("repro_torch.kernels.flash_attention",
                        "flash_attention.cu"),
    "ssd_scan": ("repro_torch.kernels.ssd_scan", "ssd_scan.cu"),
    "decode_attention": ("repro_torch.kernels.decode_attention",
                         "decode_attention.cu"),
    "decode_attention_paged": ("repro_torch.kernels.decode_attention",
                               "decode_attention.cu"),
}
# seconds between two checks of the file's mtime by one cache instance (a
# long-lived process picks up a concurrent tuner's entries within this)
REFRESH_S = 1.0
_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)

_hash_cache: dict[str, str] = {}


def _with_includes(source: Path) -> list[Path]:
    """``source`` and every header it includes with quotes, transitively,
    each once, in the order first met."""
    seen, todo = [], [source]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        todo.extend(path.parent / name.decode()
                    for name in _INCLUDE.findall(path.read_bytes()))
    return seen


def kernel_source_hash(kernel: str) -> str:
    """Short sha256 of the kernel's wrapper module, its CUDA source and the
    headers that source includes.  The module is found via ``find_spec``
    (not executed) and the hash memoized per process."""
    if kernel not in KERNEL_SOURCES:
        raise KeyError(f"unknown kernel {kernel!r}")
    h = _hash_cache.get(kernel)
    if h is None:
        module, cu = KERNEL_SOURCES[kernel]
        wrapper = Path(importlib.util.find_spec(module).origin)
        digest = hashlib.sha256()
        for path in (wrapper, *_with_includes(wrapper.parent / "csrc" / cu)):
            digest.update(path.name.encode())
            digest.update(path.read_bytes())
        h = _hash_cache[kernel] = digest.hexdigest()[:12]
    return h


@functools.cache
def _card_name(index: int) -> str:
    import torch

    return torch.cuda.get_device_name(index)


# device (as given) -> route, for devices that name their card
_routes: dict = {}


def dispatch_backend(device) -> str:
    """The route ``kernels/ops.py`` takes for tensors on ``device`` (a
    ``torch.device`` or its string): ``cpu`` for the plain versions,
    ``cuda:<device name>`` for the kernels on that card, ``meta`` for a
    dry-run's trace (no sweep measures there, so it finds no entry and
    takes the defaults).  Naming the card initialises CUDA, so a process
    that forks afterwards calls this last."""
    route = _routes.get(device)
    if route is not None:
        return route
    import torch

    dev = torch.device(device)
    if dev.type in ("cpu", "meta"):
        route = dev.type
    elif dev.type != "cuda":
        raise ValueError(f"no kernel route for device {dev}")
    elif dev.index is None:        # the current card: not remembered
        return f"cuda:{_card_name(torch.cuda.current_device())}"
    else:
        route = f"cuda:{_card_name(dev.index)}"
    _routes[device] = route
    return route


def dtype_name(dtype) -> str:
    """``torch.bfloat16`` / ``"bfloat16"`` -> ``"bfloat16"``."""
    return str(dtype).removeprefix("torch.")


def _bucket_field(v) -> int:
    v = int(v)
    if v <= 1:
        return 1
    return 1 << math.ceil(math.log2(v))


def shape_bucket(shape: dict) -> str:
    """Canonical bucket string: fields in sorted order, each rounded up
    to the next power of two."""
    return "-".join(f"{k}{_bucket_field(v)}" for k, v in
                    sorted(shape.items()))


def _entry_key(kernel: str, bucket: str, dtype: str, backend: str) -> str:
    return f"{kernel}|{backend}|{dtype}|{bucket}"


def _bucket_distance(a: dict, b: dict) -> float:
    """Log2 distance between two shape dicts; infinite when the field
    sets differ (no meaningful fallback across different workload
    identities)."""
    if set(a) != set(b):
        return float("inf")
    return sum(abs(math.log2(_bucket_field(a[k])) -
                   math.log2(_bucket_field(b[k]))) for k in a)


class TuneCache:
    """One JSON best-config store (see module docstring).  Instances
    reload from disk when the file's mtime changes (checked at most once
    every ``REFRESH_S``), so a long-lived process picks up a concurrent
    ``repro_torch.tune`` run."""

    def __init__(self, path: str | None = None):
        self.path = path if path is not None else _env_path()
        self._entries: dict[str, dict] = {}
        self._loaded_mtime: float | None = None
        self._checked_at: float | None = None    # monotonic, last stat
        self._memo: dict[tuple, dict | None] = {}  # lookup -> its answer
        self.hits = 0
        self.misses = 0

    # -- persistence ---------------------------------------------------
    def _refresh(self, force: bool = False) -> None:
        """Reload the entries if the file changed; unless ``force``, look
        at most once every ``REFRESH_S``."""
        if not self.path:
            return
        now = time.monotonic()
        if (not force and self._checked_at is not None
                and now - self._checked_at < REFRESH_S):
            return
        self._checked_at = now
        try:
            mtime = os.stat(self.path).st_mtime_ns
        except OSError:
            if self._entries or self._loaded_mtime is not None:
                self._memo.clear()
            self._entries, self._loaded_mtime = {}, None
            return
        if mtime == self._loaded_mtime:
            return
        self._memo.clear()
        try:
            with open(self.path, encoding="utf-8") as fh:
                payload = json.load(fh)
        except (OSError, json.JSONDecodeError, UnicodeDecodeError):
            # a corrupt cache must never break dispatch — treat as empty
            payload = {}
        if payload.get("version") != CACHE_VERSION:
            payload = {}
        self._entries = dict(payload.get("entries", {}))
        self._loaded_mtime = mtime

    def _write(self) -> None:
        payload = {"version": CACHE_VERSION, "entries": self._entries}
        d = os.path.dirname(os.path.abspath(self.path)) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(prefix=".tune_cache.", suffix=".tmp",
                                   dir=d)
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as fh:
                json.dump(payload, fh, indent=2, sort_keys=True)
                fh.write("\n")
            os.replace(tmp, self.path)      # atomic on POSIX
        except BaseException:
            with contextlib.suppress(OSError):
                os.unlink(tmp)
            raise
        self._loaded_mtime = os.stat(self.path).st_mtime_ns
        self._memo.clear()

    # -- API -----------------------------------------------------------
    def store(self, kernel: str, shape: dict, dtype: str, backend: str,
              config: dict, *, runtime_us: float,
              default_us: float | None = None, meta: dict | None = None,
              ) -> str:
        """Insert/replace the best config for one key; returns the key.
        Re-reads the file first so concurrent tuners merge instead of
        clobbering each other's kernels."""
        if not self.path:
            raise RuntimeError(
                f"tune cache disabled ({ENV_VAR} is empty) — cannot store")
        self._refresh(force=True)
        bucket = shape_bucket(shape)
        key = _entry_key(kernel, bucket, dtype, backend)
        self._entries[key] = {
            "kernel": kernel, "backend": backend, "dtype": dtype,
            "bucket": bucket, "shape": {k: int(v) for k, v in shape.items()},
            "config": {k: int(v) for k, v in config.items()},
            "runtime_us": round(float(runtime_us), 3),
            "default_us": (round(float(default_us), 3)
                           if default_us is not None else None),
            "src_hash": kernel_source_hash(kernel),
            **({"meta": meta} if meta else {}),
        }
        self._write()
        return key

    def lookup(self, kernel: str, shape: dict, dtype: str,
               backend: str) -> dict | None:
        """Best config for the key, or None.  Exact bucket first, then
        the nearest bucket with the same field set (shape-bucket
        fallback); entries whose kernel source hash is stale never
        match."""
        if not self.path:
            return None
        self._refresh()
        memo_key = (kernel, tuple(shape.items()), dtype, backend)
        if memo_key in self._memo:
            config = self._memo[memo_key]
            if config is None:
                self.misses += 1
                return None
            self.hits += 1
            return dict(config)
        config = self._lookup(kernel, shape, dtype, backend)
        self._memo[memo_key] = config
        if config is None:
            self.misses += 1
            return None
        self.hits += 1
        return dict(config)

    def _lookup(self, kernel: str, shape: dict, dtype: str,
                backend: str) -> dict | None:
        want_hash = kernel_source_hash(kernel)
        bucket = shape_bucket(shape)
        entry = self._entries.get(_entry_key(kernel, bucket, dtype, backend))
        if entry is not None and entry.get("src_hash") == want_hash:
            return dict(entry["config"])
        best, best_d = None, float("inf")
        for e in self._entries.values():
            if (e.get("kernel") != kernel or e.get("backend") != backend
                    or e.get("dtype") != dtype
                    or e.get("src_hash") != want_hash):
                continue
            d = _bucket_distance(shape, e.get("shape", {}))
            if d < best_d:
                best, best_d = e, d
        return None if best is None else dict(best["config"])

    def empty(self) -> bool:
        """True when the store holds no entry (checked as ``lookup``
        checks the file): every lookup would miss."""
        if not self.path:
            return True
        self._refresh()
        return not self._entries

    def entries(self) -> dict:
        self._refresh(force=True)
        return {k: dict(v) for k, v in self._entries.items()}


# ---------------------------------------------------------------------------
# process-level singleton (what kernels/ops.py consults)
# ---------------------------------------------------------------------------
def _env_path() -> str:
    p = os.environ.get(ENV_VAR)
    if p is None:
        return DEFAULT_PATH
    if p in ("", "0"):
        return ""                  # disabled
    return p


_cache: TuneCache | None = None


def get_cache() -> TuneCache:
    """The shared cache instance, re-created when
    ``REPRO_TORCH_TUNE_CACHE`` changes (tests flip it per-case)."""
    global _cache
    path = _env_path()
    if _cache is None or _cache.path != path:
        _cache = TuneCache(path)
    return _cache


def reset() -> None:
    """Drop the singleton (tests)."""
    global _cache
    _cache = None
    _hash_cache.clear()


def best_config(kernel: str, shape: dict, dtype, device) -> dict | None:
    """Dispatch-time lookup: the tuned config for tensors of ``dtype`` on
    ``device``, or None on any miss (absent cache, stale hash, disabled).
    A disabled cache never names the device's route."""
    cache = get_cache()
    if cache.empty():
        cache.misses += 1
        return None
    return cache.lookup(kernel, shape, dtype_name(dtype),
                        dispatch_backend(device))


__all__ = ["TuneCache", "get_cache", "reset", "best_config",
           "shape_bucket", "dispatch_backend", "dtype_name",
           "kernel_source_hash", "CACHE_VERSION", "ENV_VAR",
           "KERNEL_SOURCES"]
