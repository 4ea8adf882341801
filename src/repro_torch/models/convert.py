"""Weight bridge: the JAX package's parameter tree <-> the port's.

Both trees have the same paths and shapes (``embed``,
``segments/0/ln1``, ``segments/0/mixer/wq``, ..., ``final_norm``; each
segment keeps its stacked leading layer axis; a list subtree such as
DeepSeek's ``mtp/0/block/...`` is indexed by position).  Leaves cross as
numpy arrays, each in its own dtype (the MoE router and bias stay
fp32).  numpy has no bfloat16, so a bfloat16 leaf crosses as its
``uint16`` bit pattern, as ``repro/checkpoint/checkpointer.py`` stores
it: a ``uint16`` leaf (or one whose dtype is named ``bfloat16``) is read
back as bfloat16 bit for bit.  The JAX initialiser cannot be reproduced
in torch, so parity tests build parameters in JAX and carry them across
with ``params_from_numpy``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def _to_tensor(arr: np.ndarray, device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype == np.uint16 or arr.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.uint16).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(arr).copy()).to(device)


def _insert(tree, parts: list[str], value):
    head, rest = parts[0], parts[1:]
    if head.isdigit():
        idx = int(head)
        while len(tree) <= idx:
            tree.append(None)
        if rest:
            if tree[idx] is None:
                tree[idx] = [] if rest[0].isdigit() else {}
            _insert(tree[idx], rest, value)
        else:
            tree[idx] = value
        return
    if rest:
        if head not in tree:
            tree[head] = [] if rest[0].isdigit() else {}
        _insert(tree[head], rest, value)
    else:
        tree[head] = value


def params_from_numpy(arrays: dict[str, np.ndarray],
                      device: str | torch.device = "cuda", parts=None):
    """``{"segments/0/mixer/wq": ndarray, ...}`` -> the port's nested tree
    of tensors on ``device`` (dicts for names, lists for indices).  With
    ``parts`` (``{path: Part or None}``, this rank's model-axis part of
    each leaf: ``sharding/tp.py::param_parts`` flattened) each whole array
    is cut to this rank's slice first."""
    dev = resolve_device(device)
    tree: dict = {}
    for path in sorted(arrays):
        arr = arrays[path]
        part = None if parts is None else parts[path]
        if part is not None:
            arr = part.take(np.asarray(arr))
        _insert(tree, path.split("/"), _to_tensor(arr, dev))
    return tree


def params_to_numpy(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """The inverse of ``params_from_numpy``: flat ``path -> ndarray`` with
    bfloat16 leaves as their ``uint16`` bit patterns."""
    out: dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        t = tree.detach().cpu()
        if t.dtype == torch.bfloat16:
            return {prefix: t.view(torch.int16).numpy().view(np.uint16)}
        return {prefix: t.numpy()}
    for k, v in items:
        out.update(params_to_numpy(v, f"{prefix}/{k}" if prefix else k))
    return out
