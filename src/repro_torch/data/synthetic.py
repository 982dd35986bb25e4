"""A synthetic segment at a real size, made from a seed.

This is a stand-in for a built index, as random weights are for a
trained model: it lets the serving path run at the width and size of a
real segment (e.g. 1M x 128, the SIFT1M/BIGANN shape) without the hours
the Vamana build takes at that size. It is not a build algorithm of the
system. Its parts:

  * vectors: ``clustered_vectors``;
  * disk graph: the exact k nearest neighbours of each vertex
    (``core.distances.knn_graph``, through ``l2_tile`` on the card) for
    Λ-4 of its Λ edges,
    plus 4 seeded random out-edges — the first follows one random cycle
    through all vertices, so every vertex is reachable from any other,
    the other three are uniform;
  * entry: the medoid (``core.graph.medoid``);
  * layout: the paper's one-pass Block Neighbor Padding
    (``core.layout.layout_bnp``);
  * block store: ``core.blockstore.build_store``;
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

from repro_torch.core import blockstore as B
from repro_torch.core import distances as D
from repro_torch.core import layout as L
from repro_torch.core.graph import Graph, medoid
from repro_torch.core.params import SEGMENT_BENCH_DEVICE, SegmentParams
from repro_torch.data.vectors import clustered_vectors
from repro_torch.pq.pq import encode_pq, train_pq

RANDOM_EDGES = 4


def knn_graph(xt: torch.Tensor, degree: int,
              rng: np.random.Generator) -> np.ndarray:
    """[n, degree] i32 out-edges: the degree-4 exact nearest neighbours
    (self excluded), one edge along a random cycle, three uniform."""
    n = xt.shape[0]
    k = degree - RANDOM_EDGES
    if n <= k:
        raise ValueError(f"{n} vertices cannot have {k} nearest neighbours")
    near = D.knn_graph(xt, k, device=xt.device)
    perm = rng.permutation(n)
    ring = np.empty(n, np.int64)
    ring[perm] = np.roll(perm, -1)
    uniform = rng.integers(0, n, (n, RANDOM_EDGES - 1))
    return np.concatenate([near, ring[:, None], uniform],
                          axis=1).astype(np.int32)


def layout_bnp(adj: np.ndarray, deg: np.ndarray, eps: int):
    """``core.layout.layout_bnp`` on the graph (adj, deg).
    Returns (blocks [ρ, ε], block_of [N], slot_of [N])."""
    lay = L.layout_bnp(Graph(adj=adj, deg=deg, entry=0), eps)
    return lay.blocks, lay.block_of, lay.slot_of


def build_store(x: np.ndarray, adj: np.ndarray, deg: np.ndarray,
                blocks: np.ndarray):
    """``core.blockstore.build_store``: (vid [ρ, ε], vecs [ρ, ε, D],
    meta [ρ, ε, 1+Λ]) in block order."""
    lay = L.BlockLayout(blocks=blocks, block_of=None, slot_of=None)
    st = B.build_store(x, Graph(adj=adj, deg=deg, entry=0), lay, 0.0)
    return st.vid, st.vecs, st.meta


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
    entry = medoid(x)
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
    nav_entry = medoid(x[nav_ids])
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
