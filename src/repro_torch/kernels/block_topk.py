"""The block-tile ranking kernel (CUDA, ``csrc/block_topk.cu``) and its
wrapper.

``block_topk(queries, tiles, top_m, metric)`` gives, for queries [Q, D]
and each query's gathered block tiles [Q, eps, D] (f32), the distances
[Q, eps] f32 by the norm expansion ``max(|t|^2 + |q|^2 - 2 q.t, 0)`` (or
``-q.t`` for ``ip``) and the ``top_m`` slots [Q, top_m] i32 by ascending
distance, the lower slot first on ties. It replaces ``repro.kernels.
block_topk.block_topk`` (``_rank_kernel``), the §5.1 block-search inner
loop, and is the kernel API's ``ops.block_rank``; no path of the package
calls it. One warp per query, on registers only (any eps); bound by the
bytes of the tiles, see the note at the top of the CUDA source.

For ``top_m`` > eps it does what the TPU kernel does: every slot past
the eps-th holds index 0 (the masked argmin of an all-masked row).

For CPU tensors the wrapper runs the plain version (``ref.
block_topk_ref``); for CUDA tensors it launches the kernel, or raises.
Each launch adds one to ``LAUNCHES["block_topk"]``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

LAUNCHES = {"block_topk": 0}


def reset_launches() -> None:
    LAUNCHES["block_topk"] = 0


def block_topk(queries: torch.Tensor, tiles: torch.Tensor, top_m: int,
               metric: str = "l2"):
    """queries [Q, D] x tiles [Q, eps, D] -> (dists [Q, eps] f32,
    top_idx [Q, top_m] i32)."""
    if metric not in ("l2", "ip"):
        raise ValueError(f"unknown metric {metric!r} (l2 | ip)")
    if (queries.dim() != 2 or tiles.dim() != 3
            or tiles.shape[0] != queries.shape[0]
            or tiles.shape[2] != queries.shape[1] or tiles.shape[1] < 1
            or top_m < 0):
        raise ValueError(f"block_topk: shapes {tuple(queries.shape)} and "
                         f"{tuple(tiles.shape)}, top_m {top_m} do not pair")
    if queries.device.type == "cpu":
        return ref.block_topk_ref(queries, tiles, top_m, metric)
    _build.require("block_topk", queries=(queries, torch.float32),
                   tiles=(tiles, torch.float32))
    qn, eps, d = tiles.shape
    dists = torch.empty((qn, eps), dtype=torch.float32, device=tiles.device)
    idx = torch.empty((qn, top_m), dtype=torch.int32, device=tiles.device)
    lib = _build.load("block_topk")
    _build.check(lib.block_topk(
        queries.data_ptr(), tiles.data_ptr(), qn, eps, d, top_m,
        1 if metric == "ip" else 0, dists.data_ptr(), idx.data_ptr(),
        _build.stream()), "block_topk")
    LAUNCHES["block_topk"] += 1
    return dists, idx
