"""Segment serving on the card (port of ``SegmentServer`` and
``merge_topk`` from ``repro.serving.coordinator``): the batched device
search, the hybrid hot tier with tombstones, and the online tier-0
repack.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.device_search import (DeviceSegment, device_anns,
                                            repack_tier0)
from repro_torch.core.params import SERVE_DEVICE_SEARCH, DeviceSearchParams
from repro_torch.io.hottier import merge_hot_cold


def merge_topk(ids: Sequence[np.ndarray], dists: Sequence[np.ndarray],
               offsets: Sequence[int], k: int
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Merge per-segment results into the global top-k, ordered by
    (dist, global id); invalid slots (id < 0) sort past every real id."""
    gids = np.concatenate(
        [np.where(i >= 0, i + off, -1) for i, off in zip(ids, offsets)],
        axis=1).astype(np.int64)
    gd = np.concatenate(dists, axis=1)
    gd = np.where(gids >= 0, gd, np.inf)
    key_id = np.where(gids >= 0, gids, np.iinfo(np.int64).max)
    order = np.lexsort((key_id, gd), axis=1)[:, :k]
    return (np.take_along_axis(gids, order, axis=1),
            np.take_along_axis(gd, order, axis=1))


@dataclasses.dataclass
class SegmentServer:
    """One segment's device arrays + search knobs, served on ``device``
    (the segment is moved there if it lies elsewhere). A per-request
    ``k`` replaces just that field of ``params``.

    ``host`` (optional) is the host ``Segment`` the arrays were packed
    from: ``repack`` needs it, and a hybrid server takes the navigation
    graph's entries from it. ``hot_tier`` (optional, an ``io.hottier.
    HotTier``) makes the server hybrid: queries route hot-first, the
    device search is seeded from the exit frontier plus the navigation
    entries at a narrowed cold Γ, and the answers merge by ``(dist,
    id)`` with ``tombstones`` [num_vectors] bool masked from the cold
    side (the hot tier masks its own); the hot tier's visits land in the
    ``hot_tier_hits`` batch column."""
    segment: DeviceSegment
    offset: int                   # base of this segment's id space
    num_vectors: int
    k_default: int = 10
    params: DeviceSearchParams = SERVE_DEVICE_SEARCH
    metric: str = "l2"
    device: str = "cuda"
    host: Optional[object] = None       # the host Segment (repack source)
    hot_tier: Optional[object] = None   # io.hottier.HotTier
    tombstones: Optional[np.ndarray] = None  # [num_vectors] bool

    def __post_init__(self):
        self.segment = self.segment.to(torch.device(self.device))

    def search(self, queries: np.ndarray, k: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """queries [Q, D] -> (ids [Q, k], dists [Q, k], io [Q])."""
        k = k or self.k_default
        queries = np.ascontiguousarray(queries, np.float32)
        n_dead = (int(self.tombstones.sum())
                  if self.tombstones is not None else 0)
        route = seeds = None
        k_cold = k
        candidates = max(self.params.candidates, k)
        if self.hot_tier is not None:
            route = self.hot_tier.route(queries, k)
            exits = route.exits.astype(np.int32)
            # the exits start the cold beam where memory converged, the
            # navigation entries keep its basin diversity
            if self.host is not None:
                nav_seeds = self.host.nav.entry_points(
                    queries, beam=self.params.nav_beam,
                    num=self.params.entry_points,
                    device=self.device).astype(np.int32)
                exits = np.concatenate([exits, nav_seeds], axis=1)
            seeds = torch.as_tensor(exits, device=self.segment.device)
            # over-fetch so the cold top-k survives the tombstone mask;
            # the hot tier took the early exploration, so Γ narrows
            k_cold = k + min(n_dead, k)
            candidates = max(k_cold, int(round(
                self.params.candidates
                * self.hot_tier.params.cold_gamma_frac)))
        q = torch.as_tensor(queries, device=self.segment.device)
        # a per-request k above the configured beam widens Γ with it
        p = dataclasses.replace(self.params, k=k_cold,
                                candidates=max(candidates, k_cold))
        r = device_anns(self.segment, q, p, metric=self.metric, seeds=seeds)
        self.last_io = r.io.cpu().numpy()
        self.last_tier0_hits = r.tier0_hits.cpu().numpy()
        self.last_hops = r.hops.cpu().numpy()
        self.last_dedup_saved = r.dedup_saved.cpu().numpy()
        self.last_dedup_cross = r.dedup_cross.cpu().numpy()
        self.last_spec_hits = r.spec_hits.cpu().numpy()
        self.last_spec_wasted = r.spec_wasted.cpu().numpy()
        self.last_rounds = int(r.rounds)
        self.last_round_log = (r.round_log.cpu().numpy()
                               if r.round_log is not None else None)
        cold_ids, cold_dists = r.ids.cpu().numpy(), r.dists.cpu().numpy()
        if route is None:
            self.last_hot_tier_hits = np.zeros(q.shape[0], np.int64)
            return cold_ids, cold_dists, self.last_io
        self.last_hot_tier_hits = route.hot_hits.astype(np.int64)
        ci = cold_ids.astype(np.int64)
        cd = cold_dists.astype(np.float32)
        if self.tombstones is not None:
            dead = (ci >= 0) & self.tombstones[np.maximum(ci, 0)]
            ci = np.where(dead, -1, ci)
            cd = np.where(dead, np.inf, cd)
        out_i = np.full((q.shape[0], k), -1, np.int64)
        out_d = np.full((q.shape[0], k), np.inf, np.float32)
        for qi in range(q.shape[0]):
            out_i[qi], out_d[qi] = merge_hot_cold(
                k, route.ids[qi], route.dists[qi], ci[qi], cd[qi])
        return out_i, out_d, self.last_io

    def repack(self, observed, plan=None) -> int:
        """Swap the tier-0 pack for one re-ranked by ``observed``
        per-block demand counts (or the given ``plan``) at the same
        budget; results stay the same (exact copies either way). Returns
        the number of pack slots that changed."""
        if self.host is None:
            raise ValueError("SegmentServer.host is unset: build the "
                             "server with its host Segment to repack")
        self.segment, changed = repack_tier0(self.segment, self.host,
                                             observed, plan=plan)
        return changed

    def repack_source(self):
        return self.host

    def batch_stats(self) -> Dict[str, object]:
        """Device columns of the last served batch; {} before any."""
        if getattr(self, "last_tier0_hits", None) is None:
            return {}
        return {"io": self.last_io, "tier0_hits": self.last_tier0_hits,
                "hops": self.last_hops,
                "dedup_saved": self.last_dedup_saved,
                "dedup_cross": self.last_dedup_cross,
                "spec_hits": self.last_spec_hits,
                "spec_wasted": self.last_spec_wasted,
                "hot_tier_hits": self.last_hot_tier_hits,
                "rounds": self.last_rounds,
                "dma_pipelined": (self.params.pipeline_dma
                                  and self.params.fetch_impl == "fused"),
                "dma_speculative": self.params.speculate}
