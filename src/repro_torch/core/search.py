"""Starling's host block search (port of ``repro.core.search``, §5).

ANNS — Algorithm 2: a PQ-keyed candidate set C (size Γ), an exact-keyed
result set R, block search with σ-pruned in-block expansion.
RS — §5.3: C doubles and the search resumes (R, C and the kicked set P)
while |R|/|C| >= φ.

Placement. Each entry point takes a trailing ``device`` keyword (the
card unless the caller names the CPU). What runs there:
  * the query's LUT (``pq.lut_host``, the f32 order of the JAX host
    search's numpy ``adc_lut``), computed once per query and kept there;
  * the routing keys, through ``pq.adc_distance`` and the ``pq_adc``
    kernel, against the PQ codes, which are uploaded once per view and
    device (``SegmentView.resident_codes``): a hop moves only the new
    ids to the card and their keys back;
  * the navigation entry points (``NavGraph.entry_points``), one call
    for a whole batch in ``anns``.
The in-block exact distances keep the JAX package's numpy form
(``distances.point_to_points`` on the block the store read): the store
stands in for the disk, so a block read lands in host memory, the work
is ε x D (6 x 128 on the bench segment), and numpy's ``einsum`` keeps
the oracle's bits (a ``torch.sum`` at D = 128 matches them on under
half of the values). This is the host path's design, not a fallback.
The candidate set, the visited bookkeeping and the cache-fronted store
(``io.cached_store``, ``io.prefetch``) are the JAX package's, line for
line.
"""
from __future__ import annotations

import bisect
import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import distances as D
from repro_torch.core.blockstore import BlockStore
from repro_torch.core.iostats import IOStats
from repro_torch.core.layout import BlockLayout
from repro_torch.core.navgraph import NavGraph
from repro_torch.core.params import SearchParams
from repro_torch.io.cached_store import CachedBlockStore
from repro_torch.io.prefetch import PrefetchEngine
from repro_torch.pq.pq import PQCodebook, adc_distance, lut_host

# the JAX host search's fixed navigation beam and entry count
NAV_BEAM, NAV_ENTRIES = 16, 4


@dataclasses.dataclass
class SegmentView:
    """Everything the online search is allowed to touch."""
    store: BlockStore
    layout: BlockLayout
    nav: Optional[NavGraph]
    pq_codes: Optional[np.ndarray]       # [N, M] uint8, memory-resident
    pq_cb: Optional[PQCodebook]
    metric: str = "l2"
    entry: int = 0                        # static entry (medoid) fallback
    _resident: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = \
        dataclasses.field(default_factory=dict, init=False, repr=False,
                          compare=False)

    def resident_codes(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """(codes [N, M] u8, centroids [M, K, dsub] f32) on ``device``,
        uploaded on the first call for that device."""
        key = str(torch.device(device))
        if key not in self._resident:
            self._resident[key] = (
                torch.as_tensor(self.pq_codes, device=device),
                torch.as_tensor(self.pq_cb.centroids, device=device))
        return self._resident[key]


class _CandidateSet:
    """Fixed-capacity ordered set keyed by (approx) distance: the
    paper's C, sorted ascending, bounded to Γ, a visited flag per
    element; evicted ('kicked') ids are reported for the RS kicked set
    P."""

    __slots__ = ("cap", "keys", "ids", "visited", "member")

    def __init__(self, cap: int):
        self.cap = cap
        self.keys: List[float] = []
        self.ids: List[int] = []
        self.visited: List[bool] = []
        self.member: Dict[int, int] = {}

    def _reindex(self, start: int = 0) -> None:
        for i in range(start, len(self.ids)):
            self.member[self.ids[i]] = i

    def push(self, key: float, vid: int) -> Optional[Tuple[float, int]]:
        """Insert; returns the kicked (key, id) if capacity overflowed."""
        if vid in self.member:
            return None
        i = bisect.bisect_right(self.keys, key)
        if i >= self.cap:
            return (key, vid)          # worse than everything retained
        self.keys.insert(i, key)
        self.ids.insert(i, vid)
        self.visited.insert(i, False)
        self._reindex(i)
        kicked = None
        if len(self.ids) > self.cap:
            kk, ki = self.keys.pop(), self.ids.pop()
            self.visited.pop()
            del self.member[ki]
            kicked = (kk, ki)
        return kicked

    def top_unvisited(self) -> Optional[int]:
        for i, v in enumerate(self.visited):
            if not v:
                return i
        return None

    def mark_visited_id(self, vid: int) -> None:
        i = self.member.get(vid)
        if i is not None:
            self.visited[i] = True

    def __contains__(self, vid: int) -> bool:
        return vid in self.member

    def __len__(self) -> int:
        return len(self.ids)

    def grow(self, new_cap: int) -> None:
        self.cap = new_cap


@dataclasses.dataclass
class SearchResult:
    ids: np.ndarray
    dists: np.ndarray
    stats: IOStats


def entry_points(seg: SegmentView, queries: np.ndarray, p: SearchParams,
                 device="cuda") -> np.ndarray:
    """[Q, E] entry vertex ids of a batch: the navigation graph's first
    ``NAV_ENTRIES`` of a beam of ``NAV_BEAM`` (one batched call; each
    row equals the query's own call), else the static entry."""
    queries = np.asarray(queries, np.float32).reshape(-1, queries.shape[-1])
    if p.use_nav_graph and seg.nav is not None:
        return seg.nav.entry_points(queries, beam=NAV_BEAM, num=NAV_ENTRIES,
                                    device=device).astype(np.int64)
    return np.full((queries.shape[0], 1), seg.entry, np.int64)


def block_search_query(seg: SegmentView, q: np.ndarray, k: int,
                       p: SearchParams,
                       cand: Optional[_CandidateSet] = None,
                       result: Optional[Dict[int, float]] = None,
                       kicked: Optional[List[Tuple[float, int]]] = None,
                       expanded: Optional[set] = None,
                       stats: Optional[IOStats] = None,
                       seeds: Optional[np.ndarray] = None,
                       entry: Optional[np.ndarray] = None,
                       device="cuda") -> SearchResult:
    """One ANNS query via block search (Algorithm 2).

    ``cand``/``result``/``kicked``/``expanded`` let the range search
    (§5.3) resume a previous search; ``expanded`` must survive rounds,
    or reseeded kicked vertices re-read blocks already expanded.
    ``seeds`` (explicit entry ids, -1 ignored) replace the navigation
    entry pick; ``entry`` is that pick when the caller computed it for
    the whole batch (``entry_points``)."""
    store, layout = seg.store, seg.layout
    eps = store.verts_per_block
    stats = stats if stats is not None else IOStats()
    use_pq = p.use_pq_routing and seg.pq_codes is not None
    if use_pq:
        codes_t, cent_t = seg.resident_codes(device)
        qt = torch.as_tensor(np.asarray(q, np.float32), device=device)
        lut = lut_host(qt[None], cent_t, seg.metric)[0]      # stays there

    C = cand if cand is not None else _CandidateSet(p.candidate_size)
    R: Dict[int, float] = result if result is not None else {}
    P: List[Tuple[float, int]] = kicked if kicked is not None else []
    expanded = expanded if expanded is not None else set()

    # a cache-fronted store accounts hits, misses and round trips, and
    # demand reads carry speculative fetches of the top unvisited
    # candidates' blocks (coalesced, or in flight on the fetch queue)
    cached = store if isinstance(store, CachedBlockStore) else None
    prefetcher = (PrefetchEngine(cached, layout.block_of)
                  if cached is not None and cached.prefetch_width > 0
                  else None)

    def fetch(bid: int, speculate: bool = True):
        """One demand block read with unified I/O accounting."""
        if cached is None:
            out = store.read_block(bid)
            stats.block_reads += 1
            return out
        if prefetcher is not None and speculate:
            return prefetcher.read(bid, C, stats)
        return cached.read_demand(bid, stats)

    def route_dist(ids: np.ndarray) -> np.ndarray:
        """Candidate-queue key: ADC if PQ routing, else exact via block
        reads (the Fig. 11(c) ablation)."""
        if use_pq:
            stats.pq_comps += len(ids)
            idx = torch.as_tensor(ids, device=device)
            return adc_distance(lut, codes_t[idx], device=device)
        out = np.empty(len(ids), np.float32)
        for j, v in enumerate(ids):
            bid = int(layout.block_of[v])
            vids, vecs, _, _ = fetch(bid, speculate=False)
            stats.vertices_fetched += int((vids >= 0).sum())
            slot = int(layout.slot_of[v])
            out[j] = D.point_to_points(q, vecs[slot][None, :], seg.metric)[0]
            stats.dist_comps += 1
            stats.vertices_used += 1
        return out

    start = None
    if seeds is not None:
        start = np.asarray([int(v) for v in seeds if int(v) >= 0], np.int64)
    if start is None or start.size == 0:
        start = (np.asarray(entry, np.int64) if entry is not None
                 else entry_points(seg, q[None], p, device)[0])
    ed = route_dist(start)
    for v, dd in zip(start, ed):
        kk = C.push(float(dd), int(v))
        if kk is not None:
            P.append(kk)

    n_prune = max(int(math.ceil((eps - 1) * p.pruning_ratio)), 0)

    while True:
        i = C.top_unvisited()
        if i is None:
            break
        u = C.ids[i]
        C.visited[i] = True
        if u in expanded:
            continue
        stats.hops += 1

        bid = int(layout.block_of[u])
        vids, vecs, degs, nbrs = fetch(bid)              # DR
        valid = vids >= 0
        stats.vertices_fetched += int(valid.sum())

        # exact-rank every resident vertex (DC)
        dd = D.point_to_points(q, vecs, seg.metric)
        stats.dist_comps += int(valid.sum())
        best_before = min(R.values()) if R else np.inf
        for s_ in np.where(valid)[0]:
            w = int(vids[s_])
            if w not in R:
                R[w] = float(dd[s_])
        if R and min(R.values()) < best_before:
            stats.hops_to_best = stats.hops      # ℓ: top-1 improved here

        # expand the target vertex u (Algorithm 2 lines 6-7)
        slot = int(layout.slot_of[u])
        to_expand = [slot]
        expanded.add(u)
        used = 1

        if p.use_block_search and eps > 1:
            # block pruning: top-((ε−1)·σ) non-target residents (line 8)
            others = [s_ for s_ in np.where(valid)[0] if s_ != slot]
            others.sort(key=lambda s_: dd[s_])
            for s_ in others[:n_prune]:
                w = int(vids[s_])
                if w in expanded:
                    continue
                to_expand.append(s_)
                expanded.add(w)
                C.mark_visited_id(w)
                used += 1
        stats.vertices_used += used

        new_ids: List[int] = []
        for s_ in to_expand:
            for v in nbrs[s_, : degs[s_]]:
                v = int(v)
                if v >= 0 and v not in C.member and v not in expanded:
                    new_ids.append(v)
        if new_ids:
            new_ids = list(dict.fromkeys(new_ids))
            ndist = route_dist(np.asarray(new_ids, np.int64))
            for v, nd in zip(new_ids, ndist):
                kk = C.push(float(nd), v)
                if kk is not None:
                    P.append(kk)
        if stats.hops >= p.max_hops:
            break

    items = sorted(R.items(), key=lambda kv: kv[1])[:k]
    ids = np.asarray([i for i, _ in items], np.int64)
    dvals = np.asarray([d_ for _, d_ in items], np.float32)
    return SearchResult(ids=ids, dists=dvals, stats=stats)


def anns(seg: SegmentView, queries: np.ndarray, k: int,
         p: SearchParams, seeds: Optional[np.ndarray] = None,
         device="cuda") -> Tuple[np.ndarray, np.ndarray, List[IOStats]]:
    """Batch ANNS. Returns (ids [Q, k], dists [Q, k], per-query stats).
    ``seeds`` [Q, S] (-1-padded) overrides the per-query entry points."""
    Q = queries.shape[0]
    ids = np.full((Q, k), -1, np.int64)
    dd = np.full((Q, k), np.inf, np.float32)
    stats: List[IOStats] = []
    entries = entry_points(seg, queries, p, device) if Q else None
    for qi in range(Q):
        r = block_search_query(
            seg, queries[qi], k, p,
            seeds=None if seeds is None else seeds[qi],
            entry=entries[qi], device=device)
        m = r.ids.shape[0]
        ids[qi, :m] = r.ids
        dd[qi, :m] = r.dists
        stats.append(r.stats)
    return ids, dd, stats


def range_search_query(seg: SegmentView, q: np.ndarray, radius: float,
                       p: SearchParams, device="cuda") -> SearchResult:
    """Range search (§5.3): doubling candidate set with kicked-set
    reseed."""
    stats = IOStats()
    C = _CandidateSet(p.candidate_size)
    R: Dict[int, float] = {}
    P: List[Tuple[float, int]] = []
    E: set = set()    # expanded vertices survive rounds
    entry = entry_points(seg, q[None], p, device)[0]

    block_search_query(seg, q, k=1, p=p, cand=C, result=R, kicked=P,
                       expanded=E, stats=stats, entry=entry, device=device)
    for _ in range(p.rs_max_rounds):
        in_range = sum(1 for d_ in R.values() if d_ <= radius)
        if in_range / max(C.cap, 1) < p.rs_ratio:       # Eq. 7 not met
            break
        C.grow(C.cap * 2)
        # reseed with closer kicked vertices (step 4)
        P.sort(key=lambda kv: kv[0])
        reseed, P = P[: C.cap], P[C.cap:]
        for kk, vv in reseed:
            C.push(kk, vv)
        block_search_query(seg, q, k=1, p=p, cand=C, result=R, kicked=P,
                           expanded=E, stats=stats, entry=entry,
                           device=device)

    hits = [(v, d_) for v, d_ in R.items() if d_ <= radius]
    hits.sort(key=lambda kv: kv[1])
    ids = np.asarray([v for v, _ in hits], np.int64)
    dd = np.asarray([d_ for _, d_ in hits], np.float32)
    return SearchResult(ids=ids, dists=dd, stats=stats)


def range_search(seg: SegmentView, queries: np.ndarray, radius: float,
                 p: SearchParams, device="cuda"):
    out, stats = [], []
    for qi in range(queries.shape[0]):
        r = range_search_query(seg, queries[qi], radius, p, device=device)
        out.append(r.ids)
        stats.append(r.stats)
    return out, stats


# ------------------------------------------------------------------ metrics

def recall_at_k(pred: np.ndarray, truth: np.ndarray) -> float:
    """Eq. 2, averaged over queries. pred/truth [Q, k]."""
    hits = 0
    for p_, t_ in zip(pred, truth):
        hits += len(set(int(i) for i in p_ if i >= 0)
                    & set(int(i) for i in t_))
    return hits / (truth.shape[0] * truth.shape[1])


def average_precision(pred_lists, truth_lists) -> float:
    """Eq. 3 averaged over queries with non-empty ground truth."""
    vals = []
    for p_, t_ in zip(pred_lists, truth_lists):
        if len(t_) == 0:
            continue
        vals.append(len(set(p_.tolist()) & set(t_.tolist())) / len(t_))
    return float(np.mean(vals)) if vals else 1.0
