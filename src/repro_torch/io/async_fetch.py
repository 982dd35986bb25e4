"""Event-clock async fetch queue (port of ``repro.io.async_fetch``).

``AsyncFetchQueue`` models fetches in flight with an abstract event
clock (ticks, not microseconds — hardware pricing stays in
``core.iostats.CostModel``):

  * ``submit`` puts a block fetch in flight and returns a
    ``FetchTicket``; it completes at the submit tick plus a fixed
    service window plus a deterministic per-block jitter
    (``default_jitter``), so completions interleave out of submission
    order, reproducibly;
  * ``wait(ticket)`` advances the clock to that fetch's completion and
    delivers every fetch completing no later, in completion order;
    deliveries that overtake an earlier-submitted outstanding fetch are
    counted as ``reorders`` (``IOStats.completion_reorders``);
  * the in-flight table doubles as cross-query dedup: a demand read of
    a block already in flight joins its ticket
    (``IOStats.inflight_joins``).

The queue holds no payloads and does no device work: block bytes live
in the ``BlockStore``'s host arrays, so "delivery" means cache admission
and accounting. The jitter hash, the tick constants and the delivery
order are the JAX package's, so the same submissions complete in the
same order in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

# abstract event-clock constants; only their ratios matter
SERVICE_TICKS = 64.0
JITTER_TICKS = 24.0
SUBMIT_TICKS = 1.0


def default_jitter(block: int, salt: int = 0) -> float:
    """Deterministic per-block completion jitter in [0, JITTER_TICKS)."""
    h = (block * 2654435761 + salt * 40503 + 12345) & 0xFFFFFFFF
    h ^= h >> 16
    return (h % 4096) / 4096.0 * JITTER_TICKS


@dataclasses.dataclass
class FetchTicket:
    block: int
    seq: int                  # submission order
    submitted_at: float
    complete_at: float
    kind: str                 # "demand" | "speculative"
    key: object = None        # in-flight identity: (namespace, block)
    owner: object = None      # the submitting CachedBlockStore: delivery
    #                           admits into its cache
    done: bool = False
    reordered: bool = False   # delivered while an earlier-seq fetch
    #                           was still outstanding

    def residual(self, clock: float) -> float:
        """Remaining service fraction at ``clock`` (join pricing)."""
        if self.done:
            return 0.0
        rem = (self.complete_at - clock) / SERVICE_TICKS
        return min(max(rem, 0.0), 1.0)


class AsyncFetchQueue:
    """Bounded in-flight fetch window with completion-order delivery.

    At most ``depth`` fetches are in flight. Callers drop speculative
    submissions when the window is full and make room for demand ones
    by waiting out the earliest completion. One queue may be shared by
    many ``CachedBlockStore``s, so its counters are lifetime totals."""

    def __init__(self, depth: int = 8,
                 jitter_fn: Optional[Callable[[int], float]] = None,
                 jitter_salt: int = 0):
        if depth < 1:
            raise ValueError("queue depth must be >= 1")
        self.depth = int(depth)
        self._jitter = (jitter_fn if jitter_fn is not None
                        else lambda b: default_jitter(b, jitter_salt))
        self.clock = 0.0
        self._seq = 0
        self._inflight: Dict[object, FetchTicket] = {}
        self.submitted = 0
        self.delivered = 0
        self.reorders = 0
        self.inflight_peak = 0
        # optional obs.trace.Tracer: io.fetch_submit / io.fetch_complete
        # instants, None-guarded (the event clock stays in ticks; trace
        # timestamps come from the tracer's own clock)
        self.tracer = None

    def __len__(self) -> int:
        return len(self._inflight)

    @property
    def free_slots(self) -> int:
        return self.depth - len(self._inflight)

    def in_flight(self, b: int, key: object = None) -> bool:
        return (key if key is not None else b) in self._inflight

    def get(self, b: int, key: object = None) -> Optional[FetchTicket]:
        """The in-flight ticket for ``b`` (``key`` namespaces it on a
        queue shared by stores with distinct block-id spaces)."""
        return self._inflight.get(key if key is not None else b)

    def submit(self, b: int, kind: str = "speculative",
               key: object = None, owner: object = None) -> tuple:
        """Put ``b`` in flight; returns ``(ticket, occupancy)``, the
        occupancy counting this fetch. Callers dedup through ``get`` /
        ``in_flight`` first and respect ``free_slots``."""
        key = key if key is not None else b
        if key in self._inflight:
            raise ValueError(f"block {b} already in flight (join it)")
        if len(self._inflight) >= self.depth:
            raise ValueError("fetch queue full — wait out a completion")
        self._seq += 1
        self.clock += SUBMIT_TICKS
        t = FetchTicket(block=b, seq=self._seq, submitted_at=self.clock,
                        complete_at=(self.clock + SERVICE_TICKS
                                     + self._jitter(b)),
                        kind=kind, key=key, owner=owner)
        self._inflight[key] = t
        self.submitted += 1
        occ = len(self._inflight)
        self.inflight_peak = max(self.inflight_peak, occ)
        if self.tracer is not None:
            self.tracer.event("io.fetch_submit", cat="io", track="queue",
                              block=int(b), kind=kind, occupancy=occ)
        return t, occ

    def _pop_completions(self, upto: float) -> List[FetchTicket]:
        ready = sorted((t for t in self._inflight.values()
                        if t.complete_at <= upto),
                       key=lambda t: (t.complete_at, t.seq))
        out: List[FetchTicket] = []
        for t in ready:
            del self._inflight[t.key]
            t.done = True
            self.delivered += 1
            if any(o.seq < t.seq for o in self._inflight.values()):
                t.reordered = True
                self.reorders += 1
            if self.tracer is not None:
                self.tracer.event("io.fetch_complete", cat="io",
                                  track="queue", block=int(t.block),
                                  kind=t.kind, reordered=t.reordered)
            out.append(t)
        return out

    def poll(self) -> List[FetchTicket]:
        """Consume whatever has completed by the current clock."""
        return self._pop_completions(self.clock)

    def wait(self, ticket: FetchTicket) -> List[FetchTicket]:
        """Advance the clock to ``ticket``'s completion; deliver it and
        everything completing no later, in completion order."""
        if ticket.done:
            return []
        self.clock = max(self.clock, ticket.complete_at)
        return self._pop_completions(self.clock)

    def wait_any(self) -> List[FetchTicket]:
        """Wait out the earliest outstanding completion (make room)."""
        if not self._inflight:
            return []
        first = min(self._inflight.values(),
                    key=lambda t: (t.complete_at, t.seq))
        return self.wait(first)

    def drain(self) -> List[FetchTicket]:
        """Deliver every outstanding fetch."""
        out: List[FetchTicket] = []
        while self._inflight:
            out.extend(self.wait_any())
        return out
