"""Synthetic vector datasets with BIGANN/DEEP-like cluster structure
(numpy copy of ``repro.data.vectors``: the same seed gives the same
arrays)."""
from __future__ import annotations

import numpy as np


def clustered_vectors(n: int, dim: int, num_clusters: int = 64,
                      seed: int = 0, background: float = 0.05,
                      dtype=np.float32) -> np.ndarray:
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((num_clusters, dim)).astype(np.float32)
    centers *= 4.0
    scales = (0.5 + rng.gamma(2.0, 0.5, size=num_clusters)).astype(
        np.float32)
    weights = rng.dirichlet(np.ones(num_clusters) * 2.0)
    assign = rng.choice(num_clusters, size=n, p=weights)
    x = (centers[assign]
         + rng.standard_normal((n, dim)).astype(np.float32)
         * scales[assign][:, None])
    nb = int(n * background)
    if nb:
        idx = rng.choice(n, size=nb, replace=False)
        x[idx] = rng.standard_normal((nb, dim)).astype(np.float32) * 6.0
    return x.astype(dtype)


def query_set(x: np.ndarray, num: int, in_db: bool = False,
              seed: int = 1, jitter: float = 0.1) -> np.ndarray:
    """Queries near the data manifold. ``in_db=True`` returns exact rows."""
    rng = np.random.default_rng(seed)
    idx = rng.choice(x.shape[0], size=num, replace=False)
    q = x[idx].astype(np.float32).copy()
    if not in_db:
        q += rng.standard_normal(q.shape).astype(np.float32) * (
            jitter * np.abs(q).mean())
    return q
