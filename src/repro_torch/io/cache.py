"""Memory-budgeted block cache with pluggable eviction (port of
``repro.io.cache``).

The cache holds *block ids*: block payloads live in the host arrays of
``BlockStore``, so residency models which η-KB blocks a segment server
keeps in its memory pool. Capacity is in bytes and is charged into the
segment's Eq. 10 memory budget (``Segment.memory_bytes``).

Eviction: ``lru`` (least recently used) or ``lfu`` (least frequently
used, least recent on ties); ``pinned`` blocks — the top of the shared
``io.hotset`` ranking — are loaded at build time and never evicted.

``TieredBlockCache`` stacks two ``BlockCache``s: tier 1 holds full
blocks, tier 2 compressed PQ-space block summaries at
``block_bytes // compression`` each, so a tight budget keeps more of the
segment reachable without a disk trip.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Iterable, List


class EvictionPolicy:
    """Tracks non-pinned residents and picks eviction victims."""

    def on_insert(self, b: int) -> None:
        raise NotImplementedError

    def on_access(self, b: int) -> None:
        raise NotImplementedError

    def victim(self) -> int:
        raise NotImplementedError

    def remove(self, b: int) -> None:
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError


class LRUPolicy(EvictionPolicy):
    def __init__(self):
        self._order: "OrderedDict[int, None]" = OrderedDict()

    def on_insert(self, b: int) -> None:
        self._order[b] = None
        self._order.move_to_end(b)

    def on_access(self, b: int) -> None:
        if b in self._order:
            self._order.move_to_end(b)

    def victim(self) -> int:
        return next(iter(self._order))

    def remove(self, b: int) -> None:
        self._order.pop(b, None)

    def __len__(self) -> int:
        return len(self._order)


class LFUPolicy(EvictionPolicy):
    """Least-frequently-used; ties broken by least-recent access."""

    def __init__(self):
        self._freq: Dict[int, int] = {}
        self._tick_of: Dict[int, int] = {}
        self._tick = 0

    def _touch(self, b: int) -> None:
        self._tick += 1
        self._tick_of[b] = self._tick

    def on_insert(self, b: int) -> None:
        self._freq[b] = self._freq.get(b, 0) + 1
        self._touch(b)

    def on_access(self, b: int) -> None:
        if b in self._freq:
            self._freq[b] += 1
            self._touch(b)

    def victim(self) -> int:
        return min(self._freq,
                   key=lambda b: (self._freq[b], self._tick_of[b]))

    def remove(self, b: int) -> None:
        self._freq.pop(b, None)
        self._tick_of.pop(b, None)

    def __len__(self) -> int:
        return len(self._freq)


POLICIES = {"lru": LRUPolicy, "lfu": LFUPolicy}


class TieredBlockCache:
    """Two-tier residency: full blocks over compressed PQ-space summaries.

    Tier 1 holds full η-KB blocks (exactly the single-tier
    ``BlockCache``); tier 2 holds compressed PQ-space block summaries at
    ``block_bytes // compression`` each (GoVector-style), so the same
    byte budget covers ~``compression``× more blocks. A tier-2 hit
    re-ranks the block's candidates from the summary without a disk
    trip — priced at ``CostModel.t_tier2_hit`` — and promotes the block
    into tier 1. Tier-1 evictions demote their victim into tier 2;
    tier-2 evictions fall out of the hierarchy.

    Both tiers' capacities are reserved DRAM and charge into the Eq. 10
    segment memory budget via ``memory_bytes()``.
    """

    def __init__(self, tier1_bytes: int, tier2_bytes: int,
                 block_bytes: int, compression: int = 16,
                 policy: str = "lru", pinned: Iterable[int] = ()):
        if compression < 1:
            raise ValueError("compression must be >= 1")
        self.tier1 = BlockCache(tier1_bytes, block_bytes,
                                policy=policy, pinned=pinned)
        self.tier2 = BlockCache(tier2_bytes,
                                max(block_bytes // compression, 1),
                                policy=policy)
        self.compression = int(compression)
        self.tier2_admits = 0       # demotions on tier-1 eviction
        self.tier2_promotions = 0   # tier-2 hits promoted into tier 1

    # -------------------------------------------------------------- state
    @property
    def pinned(self) -> set:
        return self.tier1.pinned

    @property
    def evictions(self) -> int:
        """Blocks that left the hierarchy entirely (tier-2 evictions)."""
        return self.tier2.evictions

    def __contains__(self, b: int) -> bool:
        return b in self.tier1 or b in self.tier2

    def __len__(self) -> int:
        return len(self.tier1) + len(self.tier2)

    def resident_bytes(self) -> int:
        return self.tier1.resident_bytes() + self.tier2.resident_bytes()

    def memory_bytes(self) -> int:
        """Eq. 10 charge: both tiers' reserved budgets."""
        return self.tier1.memory_bytes() + self.tier2.memory_bytes()

    # ------------------------------------------------------------- access
    def lookup_tier(self, b: int) -> int:
        """Demand access: 1 = full-block hit, 2 = summary hit (promoted
        into tier 1), 0 = miss."""
        if self.tier1.lookup(b):
            return 1
        if self.tier2.lookup(b):
            if self.tier1.can_admit(b):
                # the summary is decompressed into a tier-1 slot; any
                # tier-1 victim demotes into the slot tier 2 just freed
                self.tier2.remove(b)
                self._admit_tier1(b)
                self.tier2_promotions += 1
            return 2
        return 0

    def lookup(self, b: int) -> bool:
        """BlockCache-compatible any-tier demand access."""
        return self.lookup_tier(b) > 0

    def admit(self, b: int) -> List[int]:
        """Insert a freshly fetched full block into tier 1; the fetch
        supersedes any stale tier-2 summary. Returns blocks that left
        the hierarchy (tier-2 evictions)."""
        if b in self.tier1:
            return []
        if not self.tier1.can_admit(b):
            # degenerate tier 1 (zero capacity, or fully pinned with no
            # evictable victim): summarize the fetched block straight
            # into tier 2 rather than dropping it
            if b in self.tier2:
                return []
            return self.tier2.admit(b)
        self.tier2.remove(b)
        return self._admit_tier1(b)

    def _admit_tier1(self, b: int) -> List[int]:
        dropped: List[int] = []
        for v in self.tier1.admit(b):
            dropped.extend(self.tier2.admit(v))
            self.tier2_admits += 1
        return dropped


class BlockCache:
    """Byte-budgeted set of resident block ids.

    ``capacity_bytes // block_bytes`` blocks fit; ``pinned`` blocks are
    preloaded (a build-time warm-up, not query-time I/O) and never
    evicted. The dynamic remainder of the capacity is managed by the
    eviction policy.
    """

    def __init__(self, capacity_bytes: int, block_bytes: int,
                 policy: str = "lru",
                 pinned: Iterable[int] = ()):
        if block_bytes <= 0:
            raise ValueError("block_bytes must be positive")
        if policy not in POLICIES:
            raise ValueError(f"unknown eviction policy {policy!r}; "
                             f"choose from {sorted(POLICIES)}")
        self.capacity_bytes = int(capacity_bytes)
        self.block_bytes = int(block_bytes)
        self.capacity_blocks = max(self.capacity_bytes // self.block_bytes,
                                   0)
        self.policy_name = policy
        self._policy: EvictionPolicy = POLICIES[policy]()
        self.pinned = set(list(dict.fromkeys(int(b) for b in pinned))
                          [: self.capacity_blocks])
        self._resident = set(self.pinned)
        self.evictions = 0

    # -------------------------------------------------------------- state
    def __contains__(self, b: int) -> bool:
        return b in self._resident

    def __len__(self) -> int:
        return len(self._resident)

    @property
    def resident(self) -> frozenset:
        return frozenset(self._resident)

    def resident_bytes(self) -> int:
        return len(self._resident) * self.block_bytes

    def memory_bytes(self) -> int:
        """Eq. 10 charge: the full budget is reserved, not just residency."""
        return self.capacity_bytes

    # ------------------------------------------------------------- access
    def lookup(self, b: int) -> bool:
        """Demand access: True on hit (and refreshes the policy)."""
        if b in self._resident:
            self._policy.on_access(b)
            return True
        return False

    def lookup_tier(self, b: int) -> int:
        """Tier-protocol demand access (shared with TieredBlockCache —
        and any future tier-0 device cache): 1 on hit, 0 on miss."""
        return 1 if self.lookup(b) else 0

    def can_admit(self, b: int) -> bool:
        """Whether ``admit(b)`` would leave ``b`` resident: capacity
        exists and is either free or reclaimable (pinned blocks are not
        victims, so a fully pinned cache admits nothing new)."""
        if self.capacity_blocks == 0:
            return False
        return (b in self._resident
                or len(self._resident) < self.capacity_blocks
                or len(self._policy) > 0)

    def admit(self, b: int) -> List[int]:
        """Insert a fetched block, evicting victims if over capacity.

        Returns the evicted block ids (empty when nothing was displaced)
        so a tiered cache can demote them into its next tier."""
        if self.capacity_blocks == 0 or b in self._resident:
            return []
        # pinned blocks are resident from construction and never evicted,
        # so b is always un-pinned here
        evicted: List[int] = []
        while (len(self._resident) >= self.capacity_blocks
               and len(self._policy) > 0):
            v = self._policy.victim()
            self._policy.remove(v)
            self._resident.discard(v)
            self.evictions += 1
            evicted.append(v)
        if len(self._resident) < self.capacity_blocks:
            self._resident.add(b)
            self._policy.on_insert(b)
        return evicted

    def remove(self, b: int) -> bool:
        """Drop a non-pinned resident (tier promotion/supersession)."""
        if b not in self._resident or b in self.pinned:
            return False
        self._resident.discard(b)
        self._policy.remove(b)
        return True
