"""Checkpointing in the JAX package's layout (a port of
``repro/checkpoint/checkpointer.py``), so a checkpoint crosses frameworks
both ways.

Layout:  <dir>/step_<N>/arrays.npz + meta.json   (tmp-dir + rename = atomic)

* keys are the tree's paths joined by ``/`` (``params/segments/0/ln1``,
  ``opt/m/embed``, ``opt/count``), as JAX's ``_flatten`` writes them;
* numpy has no bfloat16, so a bf16 leaf is stored as its ``uint16`` bits
  and named ``"bfloat16"`` in ``meta["dtypes"]``; restore reads it back bit
  for bit (no ``jax``, no ``ml_dtypes``);
* ``save`` copies every leaf to host memory before it returns (from CPU
  tensors too), then writes inline or on a writer thread
  (``async_write=True``), so training, which updates the params and the
  optimizer state in place, can go on while the file is written;
* ``restore`` takes a *like* tree (tensors, or ``meta``-device tensors when
  nothing should be allocated) for structure, dtype and shape.

On a mesh a leaf may be sharded (``shardings``, a tree of
``sharding.rules.NamedSharding`` over the leaves it names): the params
over the model axis, ZeRO-1's optimizer state over the data axes too.
``save`` gathers each such leaf whole (every rank takes part) and rank 0
alone writes, so a checkpoint is the same file on any mesh; ``restore``
cuts each leaf to this rank's slice of the target layout, the torch form
of the reference's ``jax.device_put(arr, sh[key])``: an elastic restart
onto another mesh.
"""
from __future__ import annotations

import contextlib
import json
import os
import shutil
import threading
import time

import numpy as np
import torch
import torch.distributed as dist


def _flatten(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: tree}
    out: dict = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _unflatten(tree, values: dict, prefix: str = ""):
    """``tree``'s structure with each leaf replaced by ``values[path]``."""
    if isinstance(tree, dict):
        return {k: _unflatten(v, values, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_unflatten(v, values, f"{prefix}/{i}" if prefix else str(i))
                for i, v in enumerate(tree)]
    return values[prefix]


def _to_host(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """A host copy of ``t`` (a copy on the CPU too: the train step updates
    its tensors in place while an async writer still reads the copy)."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:  # npz can't round-trip bf16
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def is_writer() -> bool:
    """Whether this process writes checkpoints: rank 0, or a process
    outside any process group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def save(directory: str, step: int, tree, *, metadata: dict | None = None,
         async_write: bool = False, shardings=None) -> threading.Thread | None:
    """Snapshot ``tree`` for ``step``. Returns the writer thread if async.
    With ``shardings``, every rank calls this; the sharded leaves are
    gathered whole and rank 0 writes (the others return None)."""
    sh = {} if shardings is None else _flatten(shardings)
    leaves = {k: (sh[k].full(v) if sh.get(k) is not None else v)
              for k, v in _flatten(tree).items()}
    if not is_writer():
        return None
    host, dtypes = {}, {}
    for k, v in leaves.items():
        host[k], dtypes[k] = _to_host(v)
    meta = dict(metadata or {}, step=step, time=time.time(), dtypes=dtypes)

    def write():
        os.makedirs(directory, exist_ok=True)
        tmp = os.path.join(directory, f".tmp_step_{step}_{os.getpid()}")
        final = os.path.join(directory, f"step_{step}")
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"), **host)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)

    if async_write:
        t = threading.Thread(target=write, daemon=True)
        t.start()
        return t
    write()
    return None


def available_steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_"):
            with contextlib.suppress(ValueError):
                steps.append(int(name.split("_", 1)[1]))
    return sorted(steps)


def _from_host(arr: np.ndarray, stored: str | None, like: torch.Tensor,
               device, sharding=None) -> torch.Tensor:
    # np.ascontiguousarray makes a 0-dim array 1-dim: keep the shape
    arr = np.ascontiguousarray(arr).reshape(arr.shape)
    if stored == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.copy())
    if sharding is not None:
        t = sharding.local(t).clone(memory_format=torch.contiguous_format)
    if tuple(t.shape) != tuple(like.shape):
        raise ValueError(f"shape {tuple(t.shape)}, expected "
                         f"{tuple(like.shape)}")
    return t.to(device=device, dtype=like.dtype)


def restore(directory: str, like, *, step: int | None = None,
            device: str | torch.device | None = None, shardings=None):
    """Restore into the structure of ``like``: each leaf takes the dtype of
    ``like``'s leaf and lands on ``device`` (default: the like leaf's
    device); a leaf that ``shardings`` names is cut to this rank's slice
    first (``like`` then holds the slice's shape).  Returns (tree, step,
    meta)."""
    steps = available_steps(directory)
    if not steps:
        raise FileNotFoundError(f"no checkpoints in {directory}")
    step = steps[-1] if step is None else step
    path = os.path.join(directory, f"step_{step}")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    dtype_map = meta.get("dtypes", {})
    sh = {} if shardings is None else _flatten(shardings)
    out = {}
    with np.load(os.path.join(path, "arrays.npz")) as arrays:
        for key, leaf in _flatten(like).items():
            if key not in arrays:
                raise KeyError(f"checkpoint missing leaf {key}")
            try:
                out[key] = _from_host(
                    arrays[key], dtype_map.get(key), leaf,
                    leaf.device if device is None else device, sh.get(key))
            except ValueError as e:
                raise ValueError(f"checkpoint leaf {key}: {e}") from None
    return _unflatten(like, out), step, meta


def prune(directory: str, keep: int = 3):
    steps = available_steps(directory)
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s}"), ignore_errors=True)
