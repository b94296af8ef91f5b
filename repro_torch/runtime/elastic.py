"""Elastic re-meshing (counterpart of ``repro.runtime.elastic``): choose
a production mesh for whatever set of cards survives, and re-shard a
checkpoint onto it.

Policy: the model axis is fixed (its extent set by the config's
divisibility constraints); failures shrink the data / pod axes.
Checkpoints store global arrays (``runtime/checkpoint.py``), so
re-sharding is a restore with the new mesh's shardings
(``checkpoint.restore(..., shardings=...)``): no resharding pass.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


@dataclass(frozen=True)
class MeshPlan:
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    dropped_chips: int


def plan_remesh(chips_alive: int, model_parallel: int = 16,
                pods: Optional[int] = None) -> MeshPlan:
    """Largest (pod?, data, model) mesh fitting the surviving chips.

    The data extent is the largest power of two such that
    ``pods·data·model <= chips_alive`` (a power of two keeps the batch
    divisible at the standard global-batch choices).
    """
    if chips_alive < model_parallel:
        raise ValueError(f"need >= {model_parallel} chips, have {chips_alive}")
    if pods is not None and pods > 1:
        per_pod = chips_alive // pods
        data = 1
        while pods * (data * 2) * model_parallel <= chips_alive and \
                (data * 2) * model_parallel <= per_pod * model_parallel:
            data *= 2
        while pods * data * model_parallel > chips_alive:
            data //= 2
        if data < 1:
            raise ValueError("not enough chips for requested pod count")
        used = pods * data * model_parallel
        return MeshPlan((pods, data, model_parallel), ("pod", "data", "model"),
                        chips_alive - used)
    data = 1
    while (data * 2) * model_parallel <= chips_alive:
        data *= 2
    used = data * model_parallel
    return MeshPlan((data, model_parallel), ("data", "model"),
                    chips_alive - used)


def build_mesh(plan: MeshPlan, device_type: str = "cuda") -> DeviceMesh:
    """The plan's mesh over the first ``prod(plan.shape)`` ranks of the
    default process group (which must be initialised), its dimensions
    named by ``plan.axes``."""
    return init_device_mesh(device_type, plan.shape,
                            mesh_dim_names=plan.axes)
