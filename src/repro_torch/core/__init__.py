# Starling core (port of ``repro.core``): the paper's primary contribution.
#   graph      — Vamana / NSG / HNSW construction
#   layout     — block-level layout + BNP/BNF/BNS/GP3/k-means shuffling + OR(G)
#   navgraph   — in-memory navigation graph (query-aware entry points)
#   blockstore — block-resident index file (the only online data path)
#   search     — block search, ANNS (Alg. 2), range search (§5.3)
#   baseline   — DiskANN-style vertex search + hot cache + repeated-ANNS RS
#   segment    — build orchestration + Eq. 8/10 cost accounting
#   iostats    — I/O counters and the Eq. 4 latency model
#   device_search — the batched search on the card and the multi-rank step
from repro_torch.core.params import (GraphParams, LayoutParams,
                                     NavGraphParams, PQParams, SearchParams,
                                     SegmentBudget, SegmentParams)

# the segment's names resolve on first use: ``core.segment`` imports
# ``pq`` and ``io``, which import ``core`` modules themselves, so an
# eager import here would break ``import repro_torch.pq`` (or ``.io``)
# when it runs before ``import repro_torch.core``
_SEGMENT_NAMES = ("Segment", "build_segment", "load_segment",
                  "save_segment")

__all__ = ["GraphParams", "LayoutParams", "NavGraphParams", "PQParams",
           "SearchParams", "SegmentBudget", "SegmentParams", "Segment",
           "build_segment", "load_segment", "save_segment"]


def __getattr__(name):
    if name in _SEGMENT_NAMES:
        from repro_torch.core import segment
        return getattr(segment, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
