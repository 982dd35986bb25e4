"""Product quantization for memory-resident routing (torch port of
``repro.pq.pq.train_pq`` / ``encode_pq``).

The training sample and the initial centroids come from the same numpy
generator calls as the JAX package, so for the same data and seed the
codebooks agree to float tolerance and the codes are equal.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.params import PQParams


def _lloyd(x: torch.Tensor, init: torch.Tensor, iters: int) -> torch.Tensor:
    """x [N, d], init [K, d] -> [K, d]. Empty clusters keep their
    centroid. The cluster sums are a one-hot matmul, as in JAX, so the
    result does not depend on the order of atomic adds."""
    cent = init
    xx = torch.sum(x * x, 1, keepdim=True)
    for _ in range(iters):
        d = xx + torch.sum(cent * cent, 1) - 2.0 * x @ cent.T
        a = torch.argmin(d, dim=1)
        one = torch.nn.functional.one_hot(a, cent.shape[0]).to(x.dtype)
        cnt = one.sum(0)
        tot = one.T @ x
        cent = torch.where(cnt[:, None] > 0,
                           tot / torch.clamp(cnt[:, None], min=1), cent)
    return cent


def train_pq(x: np.ndarray, p: PQParams, device="cuda") -> np.ndarray:
    """Per-subspace Lloyd k-means on a sample of ``x`` [N, D].
    Returns the centroids [M, K, dsub] f32."""
    n, d = x.shape
    m = p.num_subspaces
    if d % m:
        raise ValueError(f"dim {d} not divisible by M={m}")
    dsub = d // m
    k = min(p.num_centroids, n)
    rng = np.random.default_rng(p.seed)
    sample = x[rng.choice(n, size=min(p.train_sample, n), replace=False)]
    cent = np.empty((m, p.num_centroids, dsub), np.float32)
    for j in range(m):
        sub = np.ascontiguousarray(sample[:, j * dsub:(j + 1) * dsub],
                                   np.float32)
        init = sub[rng.choice(sub.shape[0], size=k, replace=False)]
        c = _lloyd(torch.as_tensor(sub, device=device),
                   torch.as_tensor(init, device=device),
                   p.train_iters).cpu().numpy()
        if k < p.num_centroids:   # tiny datasets: tile to K
            reps = -(-p.num_centroids // k)
            c = np.tile(c, (reps, 1))[: p.num_centroids]
        cent[j] = c
    return cent


def encode_pq(x, cent: np.ndarray, device="cuda",
              chunk: int = 65536) -> np.ndarray:
    """x [N, D] (numpy or tensor), cent [M, K, dsub] -> codes [N, M] u8."""
    m, _, dsub = cent.shape
    n = x.shape[0]
    c = torch.as_tensor(cent, device=device)
    cc = torch.sum(c * c, -1)[None]                          # [1, M, K]
    out = np.empty((n, m), np.uint8)
    for s in range(0, n, chunk):
        xs = torch.as_tensor(x[s:s + chunk], device=device).to(
            torch.float32).reshape(-1, m, dsub)
        d = (torch.sum(xs * xs, -1)[:, :, None] + cc
             - 2.0 * torch.einsum("nmd,mkd->nmk", xs, c))
        out[s:s + chunk] = torch.argmin(d, dim=-1).to(
            torch.uint8).cpu().numpy()
    return out
