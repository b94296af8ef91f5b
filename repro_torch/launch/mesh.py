"""Production mesh definitions (counterpart of ``repro.launch.mesh``).

Functions, not module constants: importing this module touches no
process group (the dry run initialises its fake group first).  Each
builds a ``DeviceMesh`` over the default process group, which must hold
at least as many ranks as the mesh.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def world_size(device: torch.device) -> int:
    """The drivers' rank count: the initialised default group's, else
    the environment's ``WORLD_SIZE`` (as ``torchrun`` sets it), the group
    then initialised from the environment (``nccl`` for the card,
    ``gloo`` for the CPU); 1 with neither."""
    if not dist.is_initialized():
        if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
            return 1
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    return dist.get_world_size()


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_debug_mesh(shape=(2, 2), axes=("data", "model"),
                    device_type: str = "cpu") -> DeviceMesh:
    """Small mesh for multi-rank tests (a gloo group on the CPU)."""
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))
