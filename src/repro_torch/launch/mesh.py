"""Meshes (port of ``repro.launch.mesh``): the production mesh over the
ranks of a ``torch.distributed`` process group, the rule set for a mesh,
and the rank layouts of the mesh router on one card.

Defined as functions (never module-level constants), so importing this
module touches no process group and no device.

A JAX mesh places one rank per device. On one card every rank of a
``RankLayout`` lives on the device its segments lie on, and the router
runs the ranks one after the other there; the layout carries what the
router reads from a JAX mesh, ``shape`` and ``axis_names``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch.distributed as dist

from repro_torch.distributed.sharding import (AxisRules, MULTI_POD_RULES,
                                              SINGLE_POD_RULES, axis_names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """A ``DeviceMesh`` of shape (16, 16) over ("data", "model"), or
    (2, 16, 16) over ("pod", "data", "model"), on the initialized default
    process group, which must hold exactly 256 (512) ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 1
    for s in shape:
        need *= s
    have = dist.get_world_size() if dist.is_initialized() else None
    if have != need:
        raise ValueError(
            f"the {'multi' if multi_pod else 'single'}-pod production mesh "
            f"{shape} needs a process group of {need} ranks; "
            + ("none is initialized" if have is None else f"it has {have}"))
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def rules_for(mesh) -> AxisRules:
    """The rule set for a ``DeviceMesh``, a ``RankLayout`` or any mesh
    with ``axis_names``: multi-pod when it has a ``pod`` axis."""
    return (MULTI_POD_RULES if "pod" in axis_names(mesh)
            else SINGLE_POD_RULES)


@dataclasses.dataclass(frozen=True)
class RankLayout:
    """``shape`` maps each axis name to its size, in ``axis_names``
    order."""
    shape: Dict[str, int]
    axis_names: Tuple[str, ...]


def make_debug_mesh(data: int = 1, model: int = 1) -> RankLayout:
    """A ``("data", "model")`` layout of ``data x model`` ranks."""
    if data < 1 or model < 1:
        raise ValueError("mesh axes must have size >= 1")
    return RankLayout(shape={"data": int(data), "model": int(model)},
                      axis_names=("data", "model"))
