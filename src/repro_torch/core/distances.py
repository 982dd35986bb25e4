"""Distance primitives of the segment build (port of ``repro.core.
distances``).

Conventions: ``l2`` is the *squared* Euclidean distance; ``ip`` the
negated inner product, so smaller is always better.

Two float forms, each at the same sites as in the JAX package, so that
near-ties resolve the same way:
  * the norm expansion ``max(|a|^2 + |b|^2 - 2 a.b, 0)``: ``pairwise``
    and the brute force (``brute_force_knn``, ``brute_force_range``,
    ``knn_graph``), which go through ``kernels.ops.pairwise_l2`` — the
    ``l2_tile`` CUDA kernel on the card, its plain version on the CPU;
  * the explicit difference ``sum((x - q)^2)``: ``point_to_points``,
    numpy on the host for numpy inputs, torch for tensors.

The top-k selection reproduces ``jax.lax.top_k(-d, k)``: ascending
distance, the lower index first among equal distances (``torch.topk``
alone breaks ties arbitrarily).
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from repro_torch.kernels import ops

# the largest distance block (rows x columns) one brute-force step holds
_BLOCK_ELEMS = {"cuda": 2 ** 31, "cpu": 2 ** 26}


def as_tensor(a, device) -> torch.Tensor:
    """f32 tensor on ``device`` (numpy arrays are copied there)."""
    return torch.as_tensor(np.asarray(a, np.float32) if isinstance(
        a, np.ndarray) else a, device=device).to(torch.float32)


def pairwise(a, b, metric: str = "l2", device="cuda") -> torch.Tensor:
    """[Na, D] x [Nb, D] -> [Na, Nb] f32 on ``device`` (norm expansion)."""
    return ops.pairwise_l2(as_tensor(a, device), as_tensor(b, device),
                           metric=metric)


def point_to_points(q, x, metric: str = "l2"):
    """q [..., D] x x [..., N, D] -> [..., N] by the explicit difference
    (``ip``: -x.q). numpy inputs give numpy (``repro``'s einsum),
    tensors give tensors on their device."""
    if isinstance(x, np.ndarray):
        q = np.asarray(q, np.float32)
        x = np.asarray(x, np.float32)
        if metric == "ip":
            return -(x @ q)
        diff = x - q[None, :]
        return np.einsum("nd,nd->n", diff, diff)
    if metric == "ip":
        return -torch.sum(x * q.unsqueeze(-2), dim=-1)
    diff = x - q.unsqueeze(-2)
    return torch.sum(diff * diff, dim=-1)


def topk_smallest(d: torch.Tensor, k: int) -> torch.Tensor:
    """[R, N] -> [R, k] int64 column ids of the k smallest entries per
    row, ascending, the lower id first among equal values — the order of
    ``jax.lax.top_k(-d, k)``. ``torch.topk`` of k+1 finds the values;
    they are re-sorted on (value, id), and a row whose k-th and (k+1)-th
    values tie (so an equal value with a lower id may lie outside the
    k+1) is sorted in full."""
    n = d.shape[1]
    kk = min(k + 1, n)
    vals, idx = torch.topk(d, kk, dim=1, largest=False, sorted=True)
    idx, perm = torch.sort(idx, dim=1)
    vals = torch.gather(vals, 1, perm)
    vals, o = torch.sort(vals, dim=1, stable=True)
    idx = torch.gather(idx, 1, o)
    out = idx[:, :k]
    if kk > k:
        tie = torch.nonzero(vals[:, k - 1] == vals[:, k]).squeeze(1)
        if tie.numel():
            full = torch.sort(d[tie], dim=1, stable=True).indices[:, :k]
            out = out.clone()
            out[tie] = full
    return out


def _row_chunk(n_cols: int, device: torch.device, chunk: int) -> int:
    cap = _BLOCK_ELEMS.get(device.type, _BLOCK_ELEMS["cpu"]) // max(n_cols, 1)
    return max(1, min(chunk, cap))


def brute_force_knn(x, q, k: int, metric: str = "l2", chunk: int = 4096,
                    device="cuda") -> np.ndarray:
    """Exact top-k ids for each query row (ground truth). [Nq, k] int32."""
    dev = torch.device(device)
    xt = as_tensor(x, dev)
    qt = as_tensor(q, dev)
    out = np.empty((qt.shape[0], k), np.int32)
    step = _row_chunk(xt.shape[0], dev, chunk)
    for s in range(0, qt.shape[0], step):
        d = ops.pairwise_l2(qt[s:s + step], xt, metric=metric)
        out[s:s + step] = topk_smallest(d, k).to(torch.int32).cpu().numpy()
        del d
    return out


def brute_force_range(x, q, radius: float, metric: str = "l2",
                      chunk: int = 2048, device="cuda") -> List[np.ndarray]:
    """Exact range-search ground truth: the ascending ids within
    ``radius`` of each query."""
    dev = torch.device(device)
    xt = as_tensor(x, dev)
    qt = as_tensor(q, dev)
    out: List[np.ndarray] = []
    step = _row_chunk(xt.shape[0], dev, chunk)
    for s in range(0, qt.shape[0], step):
        d = ops.pairwise_l2(qt[s:s + step], xt, metric=metric)
        hit = torch.nonzero(d <= radius).cpu().numpy()      # row-major
        counts = np.bincount(hit[:, 0], minlength=d.shape[0])
        out.extend(np.split(hit[:, 1].astype(np.int32),
                            np.cumsum(counts)[:-1]))
        del d
    return out


def knn_graph(x, k: int, metric: str = "l2", chunk: int = 2048,
              device="cuda") -> np.ndarray:
    """Exact KNN graph over x (excluding self). [N, k] int32."""
    n = x.shape[0]
    ids = brute_force_knn(x, x, min(k + 1, n), metric=metric, chunk=chunk,
                          device=device)
    not_self = ids != np.arange(n, dtype=np.int32)[:, None]
    order = np.argsort(~not_self, axis=1, kind="stable")
    rows = np.take_along_axis(ids, order, axis=1)
    out = np.ascontiguousarray(rows[:, :k])
    for i in np.flatnonzero(not_self.sum(axis=1) < k):
        # degenerate duplicates; pad with self-exclusions (as repro does)
        row = ids[i][ids[i] != i][:k]
        pad = np.setdiff1d(np.arange(min(n, k + 2)), np.append(row, i))
        out[i] = np.append(row, pad)[:k]
    return out
