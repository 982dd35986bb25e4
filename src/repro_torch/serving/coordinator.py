"""Segment serving on the card (port of ``SegmentServer`` and
``merge_topk`` from ``repro.serving.coordinator``).

The hybrid hot tier, tombstones and the online tier-0 repack are not
ported yet: a server given any of them raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.device_search import DeviceSegment, device_anns
from repro_torch.core.params import SERVE_DEVICE_SEARCH, DeviceSearchParams


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
    ``k`` replaces just that field of ``params``."""
    segment: DeviceSegment
    offset: int                   # base of this segment's id space
    num_vectors: int
    k_default: int = 10
    params: DeviceSearchParams = SERVE_DEVICE_SEARCH
    metric: str = "l2"
    device: str = "cuda"
    hot_tier: Optional[object] = None
    tombstones: Optional[np.ndarray] = None

    def __post_init__(self):
        if self.hot_tier is not None or self.tombstones is not None:
            raise NotImplementedError(
                "the hybrid hot tier and tombstones are not ported yet")
        self.segment = self.segment.to(torch.device(self.device))

    def search(self, queries: np.ndarray, k: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """queries [Q, D] -> (ids [Q, k], dists [Q, k], io [Q])."""
        k = k or self.k_default
        q = torch.as_tensor(np.ascontiguousarray(queries, np.float32),
                            device=self.segment.device)
        # a per-request k above the configured beam widens Γ with it
        p = dataclasses.replace(self.params, k=k,
                                candidates=max(self.params.candidates, k))
        r = device_anns(self.segment, q, p, metric=self.metric)
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
        self.last_hot_tier_hits = np.zeros(q.shape[0], np.int64)
        return r.ids.cpu().numpy(), r.dists.cpu().numpy(), self.last_io

    def repack(self, observed, plan=None) -> int:
        raise NotImplementedError("the online tier-0 repack is not "
                                  "ported yet")

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
