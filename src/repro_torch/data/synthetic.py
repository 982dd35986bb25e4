"""A synthetic segment at a real size, made from a seed.

This is a stand-in for a built index, as random weights are for a
trained model: it lets the serving path run at the width and size of a
real segment (e.g. 1M x 128, the SIFT1M/BIGANN shape) without the hours
the Vamana build takes at that size. It is not a build algorithm of the
system. Its parts:

  * vectors: ``clustered_vectors``;
  * disk graph: on the device, the exact k nearest neighbours of each
    vertex (chunked matmul + ``torch.topk``) for Λ-4 of its Λ edges,
    plus 4 seeded random out-edges — the first follows one random cycle
    through all vertices, so every vertex is reachable from any other,
    the other three are uniform;
  * entry: the medoid (the vertex nearest the mean);
  * layout: the paper's one-pass Block Neighbor Padding (a copy of
    ``repro.core.layout.layout_bnp`` and ``_from_block_of``);
  * block store: a copy of ``repro.core.blockstore.build_store``;
  * PQ: ``pq.train_pq`` / ``encode_pq`` with the params' M, K, iterations
    and sample;
  * navigation graph: a μ-sample (the same sampling as
    ``repro.core.navgraph.build_navgraph``) with the same construction
    at the navigation degree (Λ'-4 nearest + 4 random).

``synthetic_segment`` returns the array dict ``core.segment.
segment_from_arrays`` takes.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.params import SEGMENT_BENCH_DEVICE, SegmentParams
from repro_torch.data.vectors import clustered_vectors
from repro_torch.pq.pq import encode_pq, train_pq

RANDOM_EDGES = 4


def _medoid(xt: torch.Tensor) -> int:
    mean = xt.mean(dim=0)
    return int(torch.argmin(torch.sum(torch.square(xt - mean), dim=1)))


def knn_graph(xt: torch.Tensor, degree: int,
              rng: np.random.Generator) -> np.ndarray:
    """[n, degree] i32 out-edges: the degree-4 exact nearest neighbours
    (self excluded), one edge along a random cycle, three uniform."""
    n = xt.shape[0]
    k = degree - RANDOM_EDGES
    if n <= k:
        raise ValueError(f"{n} vertices cannot have {k} nearest neighbours")
    sq = torch.sum(xt * xt, dim=1)
    budget = 2 ** 30 if xt.device.type == "cuda" else 2 ** 25
    chunk = max(1, min(n, budget // n))
    near = np.empty((n, k), np.int32)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        d = sq[None, :] - 2.0 * (xt[s:e] @ xt.T)         # + |q|^2, constant
        rows = torch.arange(e - s, device=xt.device)
        d[rows, rows + s] = float("inf")
        near[s:e] = torch.topk(d, k, dim=1, largest=False).indices.to(
            torch.int32).cpu().numpy()
    perm = rng.permutation(n)
    ring = np.empty(n, np.int64)
    ring[perm] = np.roll(perm, -1)
    uniform = rng.integers(0, n, (n, RANDOM_EDGES - 1))
    return np.concatenate([near, ring[:, None], uniform],
                          axis=1).astype(np.int32)


def layout_bnp(adj: np.ndarray, deg: np.ndarray, eps: int):
    """Block Neighbor Padding: scan ids ascending; place each unassigned
    vertex, then pad its block with its unassigned neighbours.
    Returns (blocks [ρ, ε], block_of [N], slot_of [N])."""
    n = adj.shape[0]
    rho = -(-n // eps)
    block_of = [-1] * n
    rows = adj.tolist()
    degs = deg.tolist()
    cur, fill = 0, 0
    for u in range(n):
        if block_of[u] >= 0:
            continue
        if fill >= eps:
            cur, fill = cur + 1, 0
        block_of[u] = cur
        fill += 1
        for v in rows[u][: degs[u]]:
            if fill >= eps:
                break
            if block_of[v] < 0:
                block_of[v] = cur
                fill += 1
        if fill >= eps:
            cur, fill = cur + 1, 0
    return _from_block_of(np.asarray(block_of, np.int32), rho, eps)


def _from_block_of(block_of: np.ndarray, rho: int, eps: int):
    """Invert vertex -> block into block slots, vertices in id order
    within a block (``repro.core.layout._from_block_of``, vectorised)."""
    n = block_of.shape[0]
    order = np.argsort(block_of, kind="stable")
    starts = np.concatenate([[0], np.cumsum(np.bincount(
        block_of, minlength=rho))[:-1]])
    slot_of = np.empty(n, np.int32)
    slot_of[order] = np.arange(n) - starts[block_of[order]]
    blocks = np.full((rho, eps), -1, np.int32)
    blocks[block_of[order], slot_of[order]] = order
    return blocks, block_of.astype(np.int32), slot_of


def build_store(x: np.ndarray, adj: np.ndarray, deg: np.ndarray,
                blocks: np.ndarray):
    """(vid [ρ, ε], vecs [ρ, ε, D], meta [ρ, ε, 1+Λ]) in block order."""
    rho, eps = blocks.shape
    vid = blocks.copy()
    vecs = np.zeros((rho, eps, x.shape[1]), np.float32)
    meta = np.full((rho, eps, 1 + adj.shape[1]), -1, np.int32)
    meta[:, :, 0] = 0
    valid = vid >= 0
    ids = vid[valid].astype(np.int64)
    vecs[valid] = x[ids]
    meta[valid, 0] = deg[ids]
    meta[valid, 1:] = adj[ids]
    return vid, vecs, meta


def synthetic_segment(n: int, dim: int, seed: int = 0, device="cuda",
                      params: SegmentParams = SEGMENT_BENCH_DEVICE,
                      times: Optional[Dict[str, float]] = None
                      ) -> Dict[str, np.ndarray]:
    """The array dict of a synthetic ``n`` x ``dim`` segment (see the
    module docstring); ``times``, when given, receives the seconds of
    each stage."""
    times = {} if times is None else times
    rng = np.random.default_rng(seed + 1)
    lam = params.graph.max_degree

    def stage(name, t0):
        if xt.device.type == "cuda":
            torch.cuda.synchronize(xt.device)
        times[name] = time.perf_counter() - t0

    t0 = time.perf_counter()
    x = clustered_vectors(n, dim, seed=seed)
    xt = torch.as_tensor(x, device=device)
    stage("vectors_s", t0)

    t0 = time.perf_counter()
    adj = knn_graph(xt, lam, rng)
    deg = np.full(n, lam, np.int32)
    entry = _medoid(xt)
    stage("disk_graph_s", t0)

    t0 = time.perf_counter()
    eps = params.layout.verts_per_block(dim, lam)
    blocks, block_of, slot_of = layout_bnp(adj, deg, eps)
    vid, vecs, meta = build_store(x, adj, deg, blocks)
    stage("layout_store_s", t0)

    t0 = time.perf_counter()
    cent = train_pq(x, params.pq, device=device)
    codes = encode_pq(xt, cent, device=device)
    stage("pq_s", t0)

    t0 = time.perf_counter()
    nav_rng = np.random.default_rng(params.nav.seed)
    n_s = max(int(round(params.nav.sample_ratio * n)), min(n, 8))
    nav_ids = np.sort(nav_rng.choice(n, size=n_s, replace=False)).astype(
        np.int32)
    sub = xt[torch.as_tensor(nav_ids, device=xt.device).long()]
    nav_adj = knn_graph(sub, params.nav.max_degree, rng)
    nav_entry = _medoid(sub)
    stage("nav_graph_s", t0)
    del xt, sub

    return {"adj": adj, "deg": deg, "entry": np.int64(entry),
            "blocks": blocks, "block_of": block_of, "slot_of": slot_of,
            "vid": vid, "vecs": vecs, "meta": meta, "pq_codes": codes,
            "pq_cent": cent, "nav_ids": nav_ids, "nav_adj": nav_adj,
            "nav_deg": np.full(n_s, params.nav.max_degree, np.int32),
            "nav_entry": np.int64(nav_entry), "nav_vecs": x[nav_ids],
            "metric": np.str_(params.metric),
            "block_kb": np.float64(params.layout.block_kb)}
