"""The tiled exact-distance kernel (CUDA, ``csrc/l2_tile.cu``) and its
wrapper.

``l2_tile(q, x, metric)`` gives the [Q, N] f32 matrix of squared L2
distances ``max(|q|^2 + |x|^2 - 2 q.x, 0)`` (or ``-q.x`` for ``ip``) of
q [Q, D] and x [N, D], f32 or bf16. It replaces ``repro.kernels.l2_tile.
l2_tile`` and carries the segment build's brute force
(``core.distances``). The product is the kernel's own f32 FMA loop, never
TF32 or the tensor cores, so the kNN graph and the ground truth keep f32
order. The kernel is bound by operations (2·Q·N·D), see the note at the
top of the CUDA source; for ``l2`` a short pass of its own sums the
squared norms first.

For CPU tensors the wrapper runs the plain version
(``ref.pairwise_l2_ref``); for CUDA tensors it launches the kernel, or
raises. Each call that launches adds one to ``LAUNCHES["l2_tile"]`` (the
norm pass included) and its operations 2·Q·N·D to ``OPS["l2_tile"]``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

LAUNCHES = {"l2_tile": 0}
OPS = {"l2_tile": 0}                 # 2·Q·N·D summed over the launches
_DTYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    LAUNCHES["l2_tile"] = 0
    OPS["l2_tile"] = 0


def l2_tile(q: torch.Tensor, x: torch.Tensor,
            metric: str = "l2") -> torch.Tensor:
    """q [Q, D] x x [N, D] -> [Q, N] f32 distances."""
    if metric not in ("l2", "ip"):
        raise ValueError(f"unknown metric {metric!r} (l2 | ip)")
    if q.dim() != 2 or x.dim() != 2 or q.shape[1] != x.shape[1]:
        raise ValueError(f"l2_tile: shapes {tuple(q.shape)} and "
                         f"{tuple(x.shape)} do not pair")
    if q.device.type == "cpu":
        return ref.pairwise_l2_ref(q, x, metric)
    _build.require("l2_tile", q=(q, _DTYPES), x=(x, q.dtype))
    qn, d = q.shape
    n = x.shape[0]
    ip = metric == "ip"
    out = torch.empty((qn, n), dtype=torch.float32, device=q.device)
    norms = None if ip else torch.empty(qn + n, dtype=torch.float32,
                                        device=q.device)
    lib = _build.load("l2_tile")
    fn = lib.l2_tile_f32 if q.dtype == torch.float32 else lib.l2_tile_bf16
    _build.check(fn(q.data_ptr(), x.data_ptr(), qn, n, d, int(ip),
                    None if ip else norms.data_ptr(), out.data_ptr(),
                    _build.stream()), "l2_tile")
    LAUNCHES["l2_tile"] += 1
    OPS["l2_tile"] += 2 * qn * n * d
    return out
