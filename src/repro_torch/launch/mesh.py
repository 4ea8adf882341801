"""Production meshes (a port of ``repro/launch/mesh.py``), as
``torch.distributed`` device meshes over this world's ranks.

Functions, not module-level constants: importing this module starts no
process group (the reference's rule: importing never touches device
state).  ``make_mesh`` joins the default group (``distributed.init``) the
first time one is made.  In the dry-run's fake world
(``distributed.init_fake``) a mesh of its size is built on ``meta`` for
the lower stage and on ``cuda`` for the card stage: the production meshes
over 256 or 512 ranks of which this process is one.
"""
from __future__ import annotations

import math
import os

import torch
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch import distributed


def device_count_required(multi_pod: bool) -> int:
    return 512 if multi_pod else 256


def make_production_mesh(*, multi_pod: bool = False,
                         device: str | torch.device = "cuda") -> DeviceMesh:
    """Single pod: 16x16 = 256 ranks (data, model).  Multi-pod: 2 pods x
    256 ranks (pod, data, model); 'pod' is the outer data axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = device_count_required(multi_pod)
    have = _world()
    if have < need:
        raise RuntimeError(f"the production mesh {shape} {axes} needs "
                           f"device_count_required(multi_pod={multi_pod}) = "
                           f"{need} ranks; this world has {have}")
    return make_mesh(shape, axes, device=device)


def make_mesh(shape: tuple, axes: tuple,
              device: str | torch.device = "cuda") -> DeviceMesh:
    """A mesh of ``shape`` over this world's ranks (row-major), with the
    reference's axis names; its size must be the world size."""
    shape, axes = tuple(shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} vs axes {axes}")
    dev = distributed.init(device)
    world = torch.distributed.get_world_size()
    if math.prod(shape) != world:
        raise RuntimeError(f"a mesh of {shape} needs {math.prod(shape)} "
                           f"ranks; this world has {world}")
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def _world() -> int:
    """This world's size, read without joining it."""
    if torch.distributed.is_initialized():
        return torch.distributed.get_world_size()
    return int(os.environ.get("WORLD_SIZE", 1))
