"""Speculative batched prefetch for the host block search (port of
``repro.io.prefetch``).

The beam expands candidates in ascending key order, so the blocks of the
top unvisited candidates are likely the next demand reads. On each
demand read ``PrefetchEngine`` collects up to ``width`` distinct
non-resident blocks of unvisited candidates: coalesced into the demand
round trip (sync) or put in flight ahead of the demand wait (async,
``AsyncFetchQueue``). A block is never speculatively fetched twice in a
query: the engine keeps an ``issued`` set and skips blocks resident in
either tier or in flight. One engine is built per query inside
``core.search.block_search_query``; cross-query dedup is the shared
cache's and queue's job.
"""
from __future__ import annotations

from typing import List, Optional, Set

import numpy as np

from repro_torch.io.cached_store import CachedBlockStore


class PrefetchEngine:
    """Per-query speculative fetcher bound to one ``CachedBlockStore``.

    ``cand`` ducks as the search's ``_CandidateSet``: ordered parallel
    lists ``ids``/``visited`` sorted ascending by key.
    """

    def __init__(self, store: CachedBlockStore, block_of: np.ndarray,
                 width: Optional[int] = None):
        self.store = store
        self.block_of = block_of
        self.width = store.prefetch_width if width is None else int(width)
        self.issued: Set[int] = set()

    def targets(self, cand, exclude: Optional[int] = None) -> List[int]:
        """Blocks of the top-``width`` unvisited candidates that are
        neither resident, nor in flight, nor already speculatively
        fetched this query, nor the demand block itself."""
        if self.width <= 0:
            return []
        queue = self.store.queue
        width = self.width
        if queue is not None:
            # never mark more targets issued than the queue can take
            # (one slot reserved for the demand fetch itself)
            width = min(width, max(queue.free_slots - 1, 0))
        out: List[int] = []
        for i in range(len(cand.ids)):
            if len(out) >= width:
                break
            if cand.visited[i]:
                continue
            b = int(self.block_of[cand.ids[i]])
            if (b == exclude or b in self.issued or b in out
                    or b in self.store.cache
                    or (queue is not None
                        and queue.in_flight(b, key=self.store._key(b)))):
                continue
            out.append(b)
        self.issued.update(out)
        return out

    def read(self, b: int, cand, stats) -> tuple:
        """Demand-read ``b``, piggybacking speculative targets from
        ``cand`` — coalesced into the same round trip (sync) or put in
        flight ahead of the demand wait (async)."""
        return self.store.read_demand(b, stats,
                                      prefetch=self.targets(cand, b))
