"""Rank layouts for the mesh router on one card (the one-card
counterpart of ``repro.launch.mesh.make_debug_mesh``).

A JAX mesh places one rank per device. On one card every rank of the
layout lives on the device its segments lie on: the router runs the
ranks one after the other there. The layout carries what the router
reads from a JAX mesh, ``shape`` and ``axis_names``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple


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
