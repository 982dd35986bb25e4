"""In-memory navigation graph, §4.2 (port of ``repro.core.navgraph``).

Sample μ·N vertices, build a graph index over the sample, and answer
"give me entry points near q" without any disk I/O. Returned ids are in
the full dataset's id space. ``subset_navgraph`` builds the same kind
of graph over an explicit subset (the hot tier's). For the HNSW variant
the upper layers of the disk HNSW play this role (multi-layered
navigation, Fig. 16(b)): ``from_hnsw_layers``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import distances as D
from repro_torch.core import graph as G
from repro_torch.core.params import GraphParams, NavGraphParams


@dataclasses.dataclass
class NavGraph:
    graph: G.Graph
    sample_ids: np.ndarray      # [n'] global ids of sampled vertices
    vectors: np.ndarray         # [n', D] resident copies (the memory charge)

    def memory_bytes(self) -> int:
        """C_graph of Eq. 10: resident vectors + adjacency + degree."""
        return (self.vectors.nbytes + self.graph.adj.nbytes
                + self.graph.deg.nbytes + self.sample_ids.nbytes)

    def entry_points(self, queries, beam: int, num: int,
                     device="cuda") -> np.ndarray:
        """[Q, num] global entry-point ids (query-aware, no disk I/O):
        the first ``num`` of a beam search on the sample's graph."""
        dev = torch.device(device)
        ids, _, _ = G.greedy_search_batch(
            D.as_tensor(self.vectors, dev),
            torch.as_tensor(self.graph.adj, device=dev), self.graph.deg,
            self.graph.entry, D.as_tensor(queries, dev),
            beam=max(beam, num), metric=self.graph.metric, visited=False)
        picked = ids[:, :num].clamp_min(0).cpu().numpy()
        return self.sample_ids[picked]


def build_navgraph(x: np.ndarray, p: NavGraphParams, metric: str = "l2",
                   algo: str = "vamana", device="cuda") -> NavGraph:
    """The μ-sample (sorted ids from the seeded generator, as in JAX)
    and its graph at degree Λ'."""
    n = x.shape[0]
    rng = np.random.default_rng(p.seed)
    n_s = max(int(round(p.sample_ratio * n)), min(n, 8))
    ids = np.sort(rng.choice(n, size=n_s, replace=False)).astype(np.int32)
    sub = np.ascontiguousarray(x[ids], dtype=np.float32)
    gp = GraphParams(max_degree=p.max_degree,
                     build_beam=max(p.build_beam, p.max_degree),
                     algo=algo, seed=p.seed)
    g = G.build_graph(sub, gp, metric, device=device)
    return NavGraph(graph=g, sample_ids=ids, vectors=sub)


def subset_navgraph(x: Optional[np.ndarray], ids: np.ndarray,
                    max_degree: int, build_beam: int, metric: str = "l2",
                    algo: str = "nsg", seed: int = 1,
                    vectors: Optional[np.ndarray] = None,
                    device="cuda") -> NavGraph:
    """A ``NavGraph`` over an explicit vertex subset: the caller picks
    the resident global ``ids`` (the hot tier passes its hot-set
    members) instead of a μ-sample. ``vectors`` [len(ids), D] are the
    already-gathered rows when there is no flat ``x``."""
    ids = np.asarray(ids, np.int64)
    sub = (np.ascontiguousarray(vectors, dtype=np.float32)
           if vectors is not None
           else np.ascontiguousarray(x[ids], dtype=np.float32))
    gp = GraphParams(max_degree=max_degree,
                     build_beam=max(build_beam, max_degree),
                     algo=algo, seed=seed)
    g = G.build_graph(sub, gp, metric, device=device)
    return NavGraph(graph=g, sample_ids=ids.astype(np.int32), vectors=sub)


def from_hnsw_layers(x: np.ndarray, h: G.HNSWGraph, p: NavGraphParams,
                     device="cuda") -> NavGraph:
    """Starling-HNSW: the upper layers stay in memory as the navigation
    structure, flattened into one sampled graph (the level-1 vertices
    with the level-1 adjacency). Without an upper layer it falls back
    to an NSG over the μ-sample (``build_navgraph``)."""
    if len(h.layers) < 2:
        return build_navgraph(x, p, h.metric, algo="nsg", device=device)
    ids = h.level_ids[1]
    return NavGraph(graph=h.layers[1], sample_ids=ids.astype(np.int32),
                    vectors=np.ascontiguousarray(x[ids], np.float32))
