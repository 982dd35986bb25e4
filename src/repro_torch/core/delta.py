"""The mutable delta segment (port of ``repro.core.delta``).

A ``DeltaSegment`` wraps an immutable disk ``Segment`` with the two
mutable structures the hybrid tier provides:

  * the **hot tier** (``io.hottier``): an in-memory answering graph over
    the hot set whose append region absorbs inserts, and
  * a **tombstone bitmap** over the base id space; deletes mark it and
    are masked out of both tiers at query time.

Queries run hot-first: the hot graph converges at memory cost, the host
block search (``core.search.anns``) is seeded from its exit frontier
and the navigation entries, and the two result sets merge by ``(dist,
id)`` with dedup, as the serving plane merges. The memory work lands in
``IOStats.hot_tier_hits``.

``compact()`` folds everything back to disk: gather the live vectors
(base minus tombstones, plus live appends) and rebuild them through the
full ``core.segment.build_segment`` pipeline, so a compaction of a
delta whose live set is X equals ``build_segment(X, params)``.

``swap_into_host_server`` / ``swap_into_device_server`` install the
compacted segment under a serving target and notify the
``RepackScheduler`` (``note_layout_swap``) so demand windows drop
entries for blocks that no longer exist. Like the JAX package's, the
device swap leaves a hybrid server's ``hot_tier`` and ``tombstones`` as
they are.

Where it runs: the hot tier's graph work and the block search's LUT,
routing keys and navigation entries run on ``device`` (the card unless
the caller names the CPU); the bookkeeping is host numpy.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import device_search as DS
from repro_torch.core.iostats import IOStats
from repro_torch.core.params import HotTierParams, SearchParams
from repro_torch.core.search import anns, entry_points
from repro_torch.core.segment import Segment, build_segment
from repro_torch.io.hottier import HotTier, build_hot_tier, merge_hot_cold


@dataclasses.dataclass
class DeltaSegment:
    """An immutable base ``Segment`` + the hot tier's mutable delta.

    Global ids: ``[0, base_n)`` are the base segment's vertices;
    appended vectors take ids from ``base_n`` upward and exist only in
    the hot tier until a compaction."""
    base: Segment
    hot: HotTier
    tomb: np.ndarray              # [base_n] bool — deleted base ids
    appended: List[Tuple[int, np.ndarray]]  # (gid, vec) in insert order
    next_gid: int
    device: str = "cuda"

    @classmethod
    def wrap(cls, seg: Segment, p: HotTierParams = HotTierParams(),
             metric: Optional[str] = None, device="cuda") -> "DeltaSegment":
        """Wrap ``seg`` with a fresh hot tier built on ``device``."""
        hot = build_hot_tier(seg, p, metric=metric, device=device)
        n = seg.num_vectors
        return cls(base=seg, hot=hot, tomb=np.zeros(n, bool), appended=[],
                   next_gid=n, device=str(device))

    # ----------------------------------------------------------- census

    @property
    def base_n(self) -> int:
        return int(self.tomb.shape[0])

    @property
    def num_deleted(self) -> int:
        return int(self.tomb.sum()) + sum(
            1 for gid, _ in self.appended if self._append_dead(gid))

    @property
    def live_count(self) -> int:
        return self.base_n + len(self.appended) - self.num_deleted

    def _append_dead(self, gid: int) -> bool:
        li = self.hot._local_of.get(int(gid))
        return li is None or bool(self.hot.dead[li])

    # ------------------------------------------------------- mutability

    def insert(self, vecs: np.ndarray) -> np.ndarray:
        """Append vectors; returns their new global ids. They are
        searchable through the hot route at once (the cold tier does not
        know them until ``compact``)."""
        vecs = np.atleast_2d(np.asarray(vecs, np.float32))
        gids = np.arange(self.next_gid, self.next_gid + vecs.shape[0],
                         dtype=np.int64)
        self.hot.insert(vecs, gids)
        self.appended.extend(
            (int(g), np.array(v, np.float32)) for g, v in zip(gids, vecs))
        self.next_gid += vecs.shape[0]
        return gids

    def delete(self, gid: int) -> bool:
        """Tombstone a global id in both tiers. Returns False if the id
        does not exist (never assigned, or already deleted)."""
        gid = int(gid)
        if gid < 0 or gid >= self.next_gid:
            return False
        if gid < self.base_n:
            if self.tomb[gid]:
                return False
            self.tomb[gid] = True
            self.hot.delete(gid)   # may or may not be hot-resident
            return True
        # appended: lives only in the hot tier
        if self._append_dead(gid):
            return False
        return self.hot.delete(gid)

    # ------------------------------------------------------ compaction

    def live_vectors(self) -> Tuple[np.ndarray, np.ndarray]:
        """(x_live [M, D], gids_live [M]) — surviving base vectors in
        global-id order, then live appends in insert order. The base
        vectors come from the block store's arrays (the durable copy;
        the same arrays whether or not the view's store is cached)."""
        vid = np.asarray(self.base.vid).reshape(-1)
        vecs = np.asarray(self.base.vecs)
        dim = vecs.shape[2]
        x = np.zeros((self.base_n, dim), np.float32)
        valid = vid >= 0
        x[vid[valid]] = vecs.reshape(-1, dim)[valid]
        keep = np.flatnonzero(~self.tomb)
        xs = [x[keep]]
        gids = [keep.astype(np.int64)]
        for gid, vec in self.appended:
            if not self._append_dead(gid):
                xs.append(vec[None, :])
                gids.append(np.asarray([gid], np.int64))
        return (np.ascontiguousarray(np.concatenate(xs, axis=0),
                                     np.float32),
                np.concatenate(gids))

    def compact(self) -> Tuple[Segment, np.ndarray]:
        """Fold the delta back to disk: the full segment pipeline (graph,
        block shuffle, navigation graph, PQ) over the live vectors, on
        ``device``. Returns ``(segment, gids)``, ``gids[i]`` the
        pre-compaction global id of the new segment's vertex ``i``; the
        segment equals ``build_segment(x_live, base.params)``."""
        x_live, gids = self.live_vectors()
        return build_segment(x_live, self.base.params,
                             device=self.device), gids

    # ----------------------------------------------------------- search

    def search(self, queries: np.ndarray, k: int, p: SearchParams
               ) -> Tuple[np.ndarray, np.ndarray, List[IOStats]]:
        """Hybrid hot-first ANNS over the host block path.

        The hot route answers from memory; the block search is seeded
        from its exit frontier joined with the navigation entries (one
        batched ``entry_points`` call) and runs a ``cold_gamma_frac``-
        narrowed candidate beam. Results merge by ``(dist, id)`` with
        tombstones masked from both sides; per-query stats carry the
        memory work in ``hot_tier_hits`` on top of the block search's
        I/O columns."""
        queries = np.ascontiguousarray(queries, np.float32)
        route = self.hot.route(queries, k)
        nav_seeds = entry_points(self.base.view, queries, p, self.device)
        seeds = np.concatenate(
            [route.exits.astype(np.int64), nav_seeds.astype(np.int64)],
            axis=1)
        # over-fetch so the cold top-k survives the tombstone mask
        k_cold = k + min(self.num_deleted, k)
        gamma = max(k_cold, int(round(
            p.candidate_size * self.hot.params.cold_gamma_frac)))
        p_cold = dataclasses.replace(p, candidate_size=gamma)
        ids_c, dists_c, stats = anns(self.base.view, queries, k_cold,
                                     p_cold, seeds=seeds,
                                     device=self.device)
        qn = queries.shape[0]
        out_i = np.full((qn, k), -1, np.int64)
        out_d = np.full((qn, k), np.inf, np.float32)
        for qi in range(qn):
            ci = ids_c[qi].astype(np.int64)
            cd = dists_c[qi].astype(np.float32)
            dead = (ci >= 0) & self.tomb[np.clip(ci, 0, self.base_n - 1)]
            ci = np.where(dead, -1, ci)
            cd = np.where(dead, np.inf, cd)
            out_i[qi], out_d[qi] = merge_hot_cold(
                k, route.ids[qi], route.dists[qi], ci, cd)
            stats[qi].hot_tier_hits += int(route.hot_hits[qi])
        return out_i, out_d, stats


# ------------------------------------------------- serving swap helpers

def swap_into_host_server(server, new_seg: Segment,
                          scheduler=None) -> None:
    """Install a compacted segment under a ``HostSegmentServer`` and
    drop scheduler state keyed to the old layout (demand-window entries
    for blocks past the new layout's end, the per-target ranking,
    batch-stat watermarks)."""
    server.view = new_seg.view
    server.params = new_seg.params.search
    server.num_vectors = new_seg.num_vectors
    if scheduler is not None:
        scheduler.note_layout_swap(server)


def swap_into_device_server(server, new_seg: Segment, scheduler=None,
                            **from_segment_kwargs) -> None:
    """Install a compacted segment under a device ``SegmentServer``:
    re-pack the device arrays from the new segment on the server's
    device (the tier-0 budget from ``from_segment_kwargs``, as for the
    original ``from_segment`` call) and invalidate scheduler windows.
    A hybrid server's ``hot_tier`` and ``tombstones`` stay as they
    are."""
    kw = dict(from_segment_kwargs)
    kw.setdefault("device", server.device)
    server.segment = DS.from_segment(new_seg, **kw).to(
        torch.device(server.device))
    server.host = new_seg
    server.num_vectors = new_seg.num_vectors
    if scheduler is not None:
        scheduler.note_layout_swap(server)
