"""Device meshes (port of ``repro/launch/mesh.py``), built by functions:
importing this module touches no device or process-group state.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named
dimensions over the default process group, which must be initialised
(``dist/group.py`` starts one) with a world size equal to the product of
the shape.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def make_mesh(shape, axes, *, device="cuda"):
    """A mesh of ``shape`` with dimension names ``axes`` on ``device``'s
    type (every rank's tensors on its own device of that type)."""
    shape, axes = tuple(shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group is initialised "
                           "(repro_torch.dist.group.run starts one)")
    if dist.get_world_size() != math.prod(shape):
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} ranks, the "
                         f"group has {dist.get_world_size()}")
    return init_device_mesh(torch.device(device).type, shape, mesh_dim_names=axes)
