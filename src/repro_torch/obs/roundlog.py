"""Per-round device search records: the port's copy of
``repro.obs.roundlog`` (numpy only, the same names).

``DeviceSearchParams.trace_rounds`` makes the batched round loop in
``repro_torch.core.device_search`` carry a bounded ``[max_hops, 8]
int32`` buffer (``DeviceSearchResult.round_log``, ``SegmentServer.
last_round_log``); row ``t`` is written once per round, *before*
compaction permutes the query rows, so every column is a batch-level
sum or flag that is permutation-invariant by construction:

  == ======================= ==========================================
  col name                    per-round meaning
  == ======================= ==========================================
  0  ``live``                 queries still active this round
  1  ``cold``                 cold block touches this round (pre-dedup)
  2  ``tier0``                tier-0 hot-pack hits
  3  ``joins``                cross-query dedup joins (gathers saved)
  4  ``joins_x``              cross-tile subset of ``joins``
  5  ``compacted``            1 if active-query compaction fired
  6  ``spec_hits``            paying gathers whose block the previous
                              round speculatively pre-fetched
                              (DESIGN.md §9; 0 when off)
  7  ``spec_wasted``          speculative gathers this round consumed
                              nothing of (0 when off)
  == ======================= ==========================================

The fold invariants (asserted in tests/test_trace_roundlog.py for the
JAX package, in tests/test_torch_iostats.py and ``chip_smoke.py`` for
the port) tie the log exactly to the coarse ``IOStats`` totals the
serving plane already accounts with: ``sum(live) == hops``,
``sum(cold) == io``, ``sum(tier0) == tier0_hits``, ``sum(joins) ==
dedup_saved``, ``sum(joins_x) == dedup_cross``, ``sum(spec_hits) ==
spec_hits``, ``sum(spec_wasted) == spec_wasted`` (both charged at
consume time, so the round a hit/waste lands in is the round its
authoritative fetch ran), ``len(records) == batch_rounds`` and
``sum(live) / rounds == rounds_active_weight`` (the fold's mean live
queries a round) — the round log is a lossless refinement of
``IOStats.from_device_batch``, not a second bookkeeping system that can
drift from it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np

ROUND_LOG_COLS = ("live", "cold", "tier0", "joins", "joins_x",
                  "compacted", "spec_hits", "spec_wasted")
N_ROUND_COLS = len(ROUND_LOG_COLS)


@dataclasses.dataclass(frozen=True)
class RoundRecord:
    """One lockstep round of a batched device search."""
    round: int
    live: int        # queries active this round
    cold: int        # cold block touches this round (pre-dedup)
    tier0: int       # tier-0 hot-tile hits
    joins: int       # dedup joins (whole-batch scope)
    joins_x: int     # cross-tile subset of ``joins``
    compacted: bool  # active-query compaction fired this round
    spec_hits: int = 0    # paying gathers the previous round's
    #                       speculation pre-fetched (consume-time)
    spec_wasted: int = 0  # speculative gathers nothing consumed


def fold_round_log(round_log, rounds: int) -> List[RoundRecord]:
    """Materialize the device buffer into exact per-round records.

    ``round_log`` is the ``[max_hops, 8]`` array off the device (any
    array-like); ``rounds`` is the loop's final trip count — rows at or
    beyond it are unwritten padding and are dropped."""
    log = np.asarray(round_log)
    if log.ndim != 2 or log.shape[1] != N_ROUND_COLS:
        raise ValueError(
            f"round_log must be [rounds, {N_ROUND_COLS}], got {log.shape}")
    rounds = int(rounds)
    out = []
    for t in range(min(rounds, log.shape[0])):
        (live, cold, tier0, joins, joins_x, compacted, spec_h,
         spec_w) = (int(v) for v in log[t])
        out.append(RoundRecord(round=t, live=live, cold=cold, tier0=tier0,
                               joins=joins, joins_x=joins_x,
                               compacted=bool(compacted),
                               spec_hits=spec_h, spec_wasted=spec_w))
    return out


def round_log_totals(records: Sequence[RoundRecord]) -> Dict[str, float]:
    """Sum a folded log back down to the ``IOStats``-comparable totals.

    Matches ``IOStats.from_device_batch`` exactly: ``hops`` = total
    query-rounds of liveness, ``io``/``tier0_hits``/``dedup_saved``/
    ``dedup_cross`` = column sums, ``rounds`` = record count, ``rounds_active_weight`` =
    mean live fraction numerator (sum of live, to be divided by the
    batch width by the caller that knows it)."""
    return {
        "rounds": len(records),
        "hops": sum(r.live for r in records),
        "io": sum(r.cold for r in records),
        "tier0_hits": sum(r.tier0 for r in records),
        "dedup_saved": sum(r.joins for r in records),
        "dedup_cross": sum(r.joins_x for r in records),
        "compactions": sum(1 for r in records if r.compacted),
        "spec_hits": sum(r.spec_hits for r in records),
        "spec_wasted": sum(r.spec_wasted for r in records),
        "live_weight": sum(r.live for r in records),
    }
