"""DiskANN-style baseline framework (port of ``repro.core.baseline``;
§2.2, §3.1, App. B).

Differences vs Starling, all reproduced here:
  * layout: ID-contiguous vertices per block (``layout_sequential``);
  * search: vertex-at-a-time — each hop reads the target's block and uses
    *only the target vertex* (ξ = 1/ε, Tab. 2);
  * entry point: fixed medoid (no query-aware navigation graph);
  * memory: optional *hot-vertex cache* (BFS-radius around the medoid, as
    in DiskANN's C_hot) — cached targets cost no I/O;
  * PQ routing: same as Starling (DiskANN introduced it).

Range search for the baseline is repeated-ANNS with doubling k (§6.2
"RS support is provided by calling ANNS iteratively on DiskANN").

Placement, as in the host block search (``core.search``): each query's
LUT (``pq.lut_host``) and the PQ codes (``SegmentView.resident_codes``)
stay on ``device``, so a hop moves only its new ids there and their
routing keys (``pq.adc_distance``, the ``pq_adc`` kernel on the card)
back. The one exact distance a hop computes stays numpy
(``distances.point_to_points`` on the block the store read). The keys
keep numpy's f32 orders, so every result and counter equals the JAX
package's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import distances as D
from repro_torch.core.iostats import IOStats
from repro_torch.core.params import SearchParams
from repro_torch.core.search import SearchResult, SegmentView, _CandidateSet
from repro_torch.pq.pq import adc_distance, lut_host


def build_hot_cache(seg: SegmentView, ratio: float = 0.05) -> Dict[int, None]:
    """BFS from the medoid until ratio·N vertices are cached (C_hot);
    the keys in BFS order."""
    store, layout = seg.store, seg.layout
    n = layout.block_of.shape[0]
    budget = int(ratio * n)
    cache: Dict[int, None] = {}
    frontier = [seg.entry]
    seen = {seg.entry}
    while frontier and len(cache) < budget:
        nxt: List[int] = []
        for u in frontier:
            if len(cache) >= budget:
                break
            cache[u] = None
            b = int(layout.block_of[u])
            _, _, degs, nbrs = store.read_block(b)
            s = int(layout.slot_of[u])
            for v in nbrs[s, : degs[s]]:
                v = int(v)
                if v >= 0 and v not in seen:
                    seen.add(v)
                    nxt.append(v)
        frontier = nxt
    return cache


def vertex_search_query(seg: SegmentView, q: np.ndarray, k: int,
                        p: SearchParams,
                        hot: Optional[Dict[int, None]] = None,
                        device="cuda") -> SearchResult:
    """DiskANN beam search: PQ-keyed candidates, one block read per
    visited vertex, only the target consumed from each block."""
    store, layout = seg.store, seg.layout
    stats = IOStats()
    codes_t, cent_t = seg.resident_codes(device)
    qt = torch.as_tensor(np.asarray(q, np.float32), device=device)
    lut = lut_host(qt[None], cent_t, seg.metric)[0]          # stays there

    def route(ids: List[int]) -> np.ndarray:
        stats.pq_comps += len(ids)
        idx = torch.as_tensor(ids, dtype=torch.int64, device=device)
        return adc_distance(lut, codes_t[idx], device=device)

    C = _CandidateSet(p.candidate_size)
    R: Dict[int, float] = {}
    d0 = route([seg.entry])
    C.push(float(d0[0]), seg.entry)

    while True:
        i = C.top_unvisited()
        if i is None:
            break
        u = C.ids[i]
        C.visited[i] = True
        stats.hops += 1

        bid = int(layout.block_of[u])
        slot = int(layout.slot_of[u])
        vids, vecs, degs, nbrs = store.read_block(bid)
        if hot is None or u not in hot:                   # DR
            stats.block_reads += 1
            stats.vertices_fetched += int((vids >= 0).sum())
            stats.vertices_used += 1
        # DC: only the target vertex is consumed (Problem 1)
        dd = D.point_to_points(q, vecs[slot][None, :], seg.metric)[0]
        stats.dist_comps += 1
        best_before = min(R.values()) if R else np.inf
        R.setdefault(u, float(dd))
        if float(dd) < best_before:
            stats.hops_to_best = stats.hops

        new_ids = [int(v) for v in nbrs[slot, : degs[slot]]
                   if int(v) >= 0 and int(v) not in C.member
                   and int(v) not in R]
        if new_ids:
            for v, nd in zip(new_ids, route(new_ids)):
                C.push(float(nd), v)
        if stats.hops >= p.max_hops:
            break

    items = sorted(R.items(), key=lambda kv: kv[1])[:k]
    return SearchResult(
        ids=np.asarray([i_ for i_, _ in items], np.int64),
        dists=np.asarray([d_ for _, d_ in items], np.float32),
        stats=stats)


def vertex_anns(seg: SegmentView, queries: np.ndarray, k: int,
                p: SearchParams, hot: Optional[Dict[int, None]] = None,
                device="cuda"):
    """Batch baseline ANNS: (ids [Q, k], dists [Q, k], per-query
    ``IOStats``), -1 / inf padded."""
    Q = queries.shape[0]
    ids = np.full((Q, k), -1, np.int64)
    dd = np.full((Q, k), np.inf, np.float32)
    stats: List[IOStats] = []
    for qi in range(Q):
        r = vertex_search_query(seg, queries[qi], k, p, hot, device=device)
        m = r.ids.shape[0]
        ids[qi, :m] = r.ids
        dd[qi, :m] = r.dists
        stats.append(r.stats)
    return ids, dd, stats


def vertex_range_search_query(seg: SegmentView, q: np.ndarray,
                              radius: float, p: SearchParams,
                              hot: Optional[Dict[int, None]] = None,
                              max_rounds: int = 6,
                              device="cuda") -> SearchResult:
    """Baseline RS: repeated ANNS with doubling k — revisits the same
    vertices every round (the inefficiency §5.3 calls out)."""
    stats = IOStats()
    k = max(p.candidate_size // 2, 10)
    last: Optional[SearchResult] = None
    for _ in range(max_rounds):
        pp = dataclasses.replace(p, candidate_size=max(p.candidate_size, k))
        r = vertex_search_query(seg, q, k, pp, hot, device=device)
        stats.merge(r.stats)
        in_range = r.dists <= radius
        last = SearchResult(ids=r.ids[in_range], dists=r.dists[in_range],
                            stats=stats)
        if in_range.sum() < k:      # found the boundary
            break
        k *= 2
    return SearchResult(ids=last.ids, dists=last.dists, stats=stats)


def vertex_range_search(seg: SegmentView, queries: np.ndarray,
                        radius: float, p: SearchParams,
                        hot: Optional[Dict[int, None]] = None,
                        device="cuda"):
    """Per query: (in-range ids, distance ascending), and its
    ``IOStats``."""
    out, stats = [], []
    for qi in range(queries.shape[0]):
        r = vertex_range_search_query(seg, queries[qi], radius, p, hot,
                                      device=device)
        out.append(r.ids)
        stats.append(r.stats)
    return out, stats
