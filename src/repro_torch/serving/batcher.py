"""Request batcher (port of ``repro.serving.batcher``): collect
single-query requests into device batches.

The device search is a batched beam; the batcher pads the pending queue
to the nearest batch-size bucket, so a server sees a handful of shapes
instead of one per request count. Buckets are rounded up to multiples
of the round kernel's query tile (``tile``, default 8: the floor of
``kernels.ops.round_tile``), so a padded batch fills whole tiles: pad
rows converge at once and, under active-query compaction, cluster into
idle tiles the rank kernel skips. Padding never changes results:
per-query state is row-independent.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class PendingRequest:
    request_id: int
    query: np.ndarray


class RequestBatcher:
    """``max_wait`` is a deadline in scheduler ticks: each ``ready()``
    poll with a non-empty queue counts one tick, so a partial batch is
    flushed after at most ``max_wait`` polls instead of waiting forever
    for the largest bucket to fill."""

    def __init__(self, dim: int, buckets: Sequence[int] = (8, 32, 128),
                 max_wait: int = 64, tile: int = 8):
        if tile < 1:
            raise ValueError("tile must be >= 1")
        self.dim = dim
        self.tile = tile
        # round every bucket up to the kernel tile multiple (dedup sets
        # coincide with kernel invocations only on whole tiles)
        self.buckets = tuple(sorted({-(-int(b) // tile) * tile
                                     for b in buckets}))
        self.max_wait = max_wait
        self.queue: List[PendingRequest] = []
        self._next_id = 0
        self._waited = 0
        self.batches_emitted = 0   # lifetime batches handed out —
        #                            serving-loop telemetry (note: the
        #                            RepackScheduler keeps its own count
        #                            of batches it was actually shown)

    def submit(self, query: np.ndarray) -> int:
        rid = self._next_id
        self._next_id += 1
        self.queue.append(PendingRequest(rid, np.asarray(
            query, np.float32)))
        return rid

    def ready(self) -> bool:
        """True when the largest bucket can be filled, or when pending
        requests have waited ``max_wait`` polls (deadline flush)."""
        if not self.queue:
            self._waited = 0
            return False
        if len(self.queue) >= self.buckets[-1]:
            return True
        self._waited += 1
        return self._waited >= self.max_wait

    def next_batch(self) -> Tuple[np.ndarray, List[int], int]:
        """Returns (padded queries [B, D], request ids, valid count)."""
        n = min(len(self.queue), self.buckets[-1])
        bucket = next(b for b in self.buckets if b >= n)
        take, self.queue = self.queue[:n], self.queue[n:]
        self._waited = 0
        self.batches_emitted += 1
        q = np.zeros((bucket, self.dim), np.float32)
        ids = []
        for i, r in enumerate(take):
            q[i] = r.query
            ids.append(r.request_id)
        return q, ids, n
