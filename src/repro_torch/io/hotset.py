"""Build-time hot-set selection shared by every cache tier (numpy
copy of ``repro.io.hotset``).

Blocks are scored by traversal frequency around the navigation-graph
entry neighbourhood (the seeds queries enter through, and their
disk-graph neighbours, seeds weighted above neighbours). The host
tier-1 cache pins a prefix of the ranking (``hot_block_pin_set``); the
device tier-0 pack fills its budget from it (``fill_to`` extends the
ranking in id order, so growing budgets select nested sets).
``repack_from_frequencies`` / ``plan_tier0`` re-rank it by observed
per-block demand, and ``pack_drift`` is the repack scheduler's
hysteresis signal.
"""
from __future__ import annotations

from collections import Counter
from typing import AbstractSet, List, Mapping, Sequence

import numpy as np


def hot_block_ranking(block_of: np.ndarray, adj: np.ndarray,
                      deg: np.ndarray, seed_ids: Sequence[int],
                      hops: int = 1) -> List[int]:
    """All touched blocks, most-traversed first: BFS out ``hops``
    levels from ``seed_ids`` counting each visited vertex's block with
    weight ``2^(hops-level)``; one visited set across levels, so each
    vertex counts once, at its first level."""
    if len(seed_ids) == 0:
        return []
    counts: Counter = Counter()
    frontier = [int(v) for v in seed_ids]
    seen = set(frontier)
    weight = 1 << hops
    for _ in range(hops + 1):
        for v in frontier:
            counts[int(block_of[v])] += weight
        if weight == 1:
            break
        nxt: List[int] = []
        for v in frontier:
            for w in adj[v, : deg[v]].tolist():
                if w >= 0 and w not in seen:
                    seen.add(w)
                    nxt.append(w)
        frontier = nxt
        weight >>= 1
    return [b for b, _ in counts.most_common()]


def hot_block_pin_set(block_of: np.ndarray, adj: np.ndarray,
                      deg: np.ndarray, seed_ids: Sequence[int],
                      max_blocks: int, hops: int = 1) -> List[int]:
    """Top ``max_blocks`` of the shared ranking (the tier-1 pin set)."""
    if max_blocks <= 0:
        return []
    return hot_block_ranking(block_of, adj, deg, seed_ids, hops)[
        :max_blocks]


def repack_from_frequencies(ranking: Sequence[int],
                            observed: Mapping[int, int]) -> List[int]:
    """Re-rank a build-time ranking by observed traffic: touched blocks
    first by descending count (ties by build position, then id), then
    the untouched remainder in build order."""
    pos = {int(b): i for i, b in enumerate(ranking)}
    far = len(pos)
    seen = [int(b) for b, c in observed.items() if c > 0]
    seen.sort(key=lambda b: (-int(observed[b]), pos.get(b, far), b))
    hot = set(seen)
    return seen + [b for b in ranking if int(b) not in hot]


def plan_tier0(ranking: Sequence[int], observed: Mapping[int, int],
               num_blocks: int, total_blocks: int,
               min_observed: int = 1) -> List[int]:
    """The tier-0 pack selection: re-rank by ``observed`` (below
    ``min_observed`` and out-of-range ids dropped), then fill to the
    budget."""
    obs = {int(b): c for b, c in observed.items()
           if c >= min_observed and 0 <= int(b) < int(total_blocks)}
    if obs:
        ranking = repack_from_frequencies(ranking, obs)
    return fill_to(ranking, num_blocks, total_blocks)


def pack_drift(current: AbstractSet, planned: Sequence[int]) -> float:
    """Fraction of pack slots a repack would change (the scheduler's
    hysteresis signal): 0.0 when the plan is the live pack, 1.0 for a
    full replacement; growing or shrinking plans register too."""
    planned_set = set(int(b) for b in planned)
    denom = max(len(current), len(planned_set))
    if denom == 0:
        return 0.0
    return max(len(planned_set - current),
               len(set(current) - planned_set)) / denom


def fill_to(ranking: Sequence[int], num_blocks: int,
            total_blocks: int) -> List[int]:
    """Extend ``ranking`` to ``num_blocks`` distinct ids in
    ``[0, total_blocks)`` with the untouched remainder in id order."""
    total_blocks = int(total_blocks)
    num_blocks = min(int(num_blocks), total_blocks)
    if num_blocks <= 0:
        return []
    out: List[int] = []
    chosen = set()
    for b in ranking:
        b = int(b)
        if 0 <= b < total_blocks and b not in chosen:
            out.append(b)
            chosen.add(b)
            if len(out) == num_blocks:
                return out
    for b in range(total_blocks):
        if b not in chosen:
            out.append(b)
            if len(out) == num_blocks:
                break
    return out


def view_seed_ids(view) -> np.ndarray:
    """The entry seeds of a ``core.search.SegmentView``: the
    navigation-graph sample when navigation is on, else the static entry
    (medoid) — the same seeds for every tier, so host pinning, the
    device pack and the hot tier agree on what "hot" means."""
    if getattr(view, "nav", None) is not None:
        return np.asarray(view.nav.sample_ids)
    return np.asarray([view.entry], np.int64)
