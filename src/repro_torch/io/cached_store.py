"""Cache-fronted block store (port of ``repro.io.cached_store``).

``CachedBlockStore`` is a drop-in for ``BlockStore``: the same
``read_block``, and every array attribute (``vid``/``vecs``/``meta``,
``disk_bytes()``, ...) delegates to the wrapped store, so the host
search, ``save_segment`` and ``device_search.from_segment`` read the
same arrays with or without it. What it adds is accounting and
batching:

  * every demand read is a cache lookup: tier-1 hits, tier-2 hits
    (``TieredBlockCache``, no disk trip) and misses, which fetch and
    ``admit`` the block;
  * synchronous path (no queue): a miss issues one I/O round trip and
    speculative prefetch targets coalesce into it; a trip carrying only
    speculative blocks (a hit + prefetch) still counts;
  * asynchronous path (``queue`` set): ``read_demand`` submits to and
    waits on the shared ``AsyncFetchQueue``; speculative targets go in
    flight before the demand wait, completions admit and account out
    of submission order, and a demand read of a block in flight joins
    its ticket;
  * ``io_round_trips <= block_reads`` on both paths;
  * per-query counters go to the ``IOStats`` passed to ``read_demand``
    (or ``stats_sink`` for ``read_block`` callers); lifetime totals to
    ``.total``, and the per-block demand count to ``block_freq`` (the
    repack scheduler's feed);
  * observability (``attach_obs``): an ``io.read`` span per demand read
    and the queue's fetch events on a tracer, the lifetime counters
    republished as ``io.*`` gauges by ``publish_metrics``.
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.blockstore import BlockStore
from repro_torch.core.iostats import IOStats
from repro_torch.io.async_fetch import AsyncFetchQueue, FetchTicket
from repro_torch.io.cache import BlockCache, TieredBlockCache
from repro_torch.io.hotset import hot_block_pin_set, view_seed_ids


class CachedBlockStore:
    def __init__(self, base: BlockStore,
                 cache: Union[BlockCache, TieredBlockCache],
                 prefetch_width: int = 0,
                 queue: Optional[AsyncFetchQueue] = None,
                 record_fetches: bool = False):
        self.base = base
        self.cache = cache
        self.prefetch_width = int(prefetch_width)
        self.queue = queue
        self.stats_sink: Optional[IOStats] = None
        self.total = IOStats()          # lifetime counters across queries
        # lifetime demand-read count per block: the observed-frequency
        # feed for dynamic hot-set admission (hotset.
        # repack_from_frequencies / device_search.from_segment(observed=))
        self.block_freq: Counter = Counter()
        # (kind, block) log of disk fetches, kind in {"miss", "prefetch"};
        # test hook for the never-fetch-twice invariant.
        self.fetch_log: Optional[List[Tuple[str, int]]] = \
            [] if record_fetches else None
        # observability (obs): both optional and None-guarded on the hot
        # path; set here (not lazily) because __getattr__ forwards
        # unknown attributes to the base store. ``obs_target`` is the
        # per-target attribution label metrics publish under.
        self.tracer = None              # obs.trace.Tracer
        self.metrics = None             # obs.metrics.MetricsRegistry
        self.obs_target: str = ""

    def attach_obs(self, tracer=None, metrics=None,
                   target: str = "") -> None:
        """Wire the store into the observability plane: ``io.read``
        spans on ``tracer`` (and fetch submit/complete events on the
        attached queue), lifetime counters published to ``metrics``
        under ``target``."""
        self.tracer = tracer
        self.metrics = metrics
        self.obs_target = target
        if self.queue is not None and tracer is not None and \
                getattr(self.queue, "tracer", None) is None:
            self.queue.tracer = tracer

    def publish_metrics(self) -> None:
        """Re-express the lifetime cache counters through the metrics
        registry (gauges under ``io.*``, attributed to ``obs_target``):
        the registry view and ``total`` cannot disagree because this is
        ``total``, republished."""
        if self.metrics is None:
            return
        t = self.total
        for name, val in (
                ("io.block_reads", t.block_reads),
                ("io.cache_hits", t.cache_hits),
                ("io.tier2_hits", t.tier2_hits),
                ("io.cache_misses", t.cache_misses),
                ("io.round_trips", t.io_round_trips),
                ("io.prefetched_blocks", t.prefetched_blocks),
                ("io.queue_fetches", t.queue_fetches),
                ("io.inflight_peak", t.inflight_peak),
                ("io.inflight_joins", t.inflight_joins),
                ("io.completion_reorders", t.completion_reorders),
                ("io.hit_rate", t.cache_hit_rate)):
            self.metrics.gauge(name, self.obs_target).set(val)

    # ------------------------------------------------------- delegation
    def __getattr__(self, name):
        # only consulted for attributes not set on self: num_blocks,
        # verts_per_block, dim, vid, vecs, meta, packed, disk_bytes, ...
        return getattr(self.base, name)

    def memory_bytes(self) -> int:
        """Eq. 10 charge of the cache (full reserved budget, all tiers)."""
        return self.cache.memory_bytes()

    # ------------------------------------------------------------ reads
    def _lookup_tier(self, b: int) -> int:
        """1 = full-block hit, 2 = compressed-summary hit, 0 = miss —
        both cache classes speak the lookup_tier protocol."""
        return self.cache.lookup_tier(b)

    def read_block(self, b: int):
        """Drop-in demand read; accounts into ``stats_sink`` if set."""
        return self.read_demand(b, self.stats_sink)

    def read_demand(self, b: int, stats: Optional[IOStats] = None,
                    prefetch: Sequence[int] = ()):
        """Demand-read block ``b``; speculate ``prefetch`` blocks
        (already filtered to non-resident ids). Dispatches to the async
        submit/wait path when an ``AsyncFetchQueue`` is attached,
        otherwise coalesces the speculation into the demand round trip.
        """
        if self.tracer is not None:
            # residency peeked via ``in`` (side-effect-free: a
            # lookup_tier here would touch LRU recency and tier-2
            # promotion twice, and tracing would change the counters)
            with self.tracer.span("io.read", cat="io",
                                  track=self.obs_target or "io",
                                  block=int(b),
                                  cached=bool(b in self.cache)):
                return self._read_demand(b, stats, prefetch)
        return self._read_demand(b, stats, prefetch)

    def _read_demand(self, b: int, stats: Optional[IOStats],
                     prefetch: Sequence[int] = ()):
        self.block_freq[int(b)] += 1
        if self.queue is not None:
            return self._read_async(b, stats, prefetch)
        tier = self._lookup_tier(b)
        targets = [p for p in prefetch if p != b and p not in self.cache]
        trip = (tier == 0) or bool(targets)
        self._account(stats, tier=tier, trip=trip,
                      prefetched=len(targets))
        if tier == 0:
            self.cache.admit(b)
            self._log("miss", b)
        for p in targets:
            self.cache.admit(p)
            self._log("prefetch", p)
        return self.base.read_block(b)

    # ------------------------------------------------------- async path
    def _key(self, b: int) -> tuple:
        """In-flight identity on a shared queue: namespaced by the
        backing store, so equal block ids of *different* segments never
        conflate, while views over the same base dedup as intended."""
        return (id(self.base), b)

    def _read_async(self, b: int, stats: Optional[IOStats],
                    prefetch: Sequence[int] = ()):
        """Submit/wait demand read against the shared fetch queue.

        Order matters: speculative targets are submitted *before* the
        demand wait so their service windows overlap it (§5.1 — the
        occupancy the cost model prices). A block already in flight —
        from this query's speculation or another query on the shared
        queue — is joined, not re-fetched."""
        q = self.queue
        tier = self._lookup_tier(b)
        if tier:
            self._account(stats, tier=tier, trip=False, prefetched=0)
            self._speculate(prefetch, b, stats)
            self._deliver(q.poll(), stats)
            return self.base.read_block(b)
        ticket = q.get(b, key=self._key(b))
        joined = ticket is not None
        residual = ticket.residual(q.clock) if joined else 0.0
        if not joined:
            while q.free_slots <= 0:
                self._deliver(q.wait_any(), stats)
            ticket, _ = q.submit(b, kind="demand", key=self._key(b),
                                 owner=self)
            self._log("miss", b)
        self._bump(stats, "queue_fetches", 0 if joined else 1)
        self._account(stats, tier=0, trip=not joined, prefetched=0,
                      joined=joined, residual=residual)
        self._speculate(prefetch, b, stats)
        self._deliver(q.wait(ticket), stats)
        # a joined ticket delivers into its submitter's cache; this
        # store received the payload too, so it admits as well
        self.cache.admit(b)
        return self.base.read_block(b)

    def _speculate(self, prefetch: Sequence[int], demand: int,
                   stats: Optional[IOStats]) -> None:
        q = self.queue
        for p in prefetch:
            if q.free_slots <= 0:
                break
            if (p == demand or p in self.cache
                    or q.in_flight(p, key=self._key(p))):
                continue
            _, occ = q.submit(p, kind="speculative", key=self._key(p),
                              owner=self)
            self._log("prefetch", p)
            for s in (stats, self.total):
                if s is None:
                    continue
                s.queue_fetches += 1
                s.queue_occ_weight += 1.0 / occ
                s.inflight_peak = max(s.inflight_peak, occ)

    def _deliver(self, completions: List[FetchTicket],
                 stats: Optional[IOStats]) -> None:
        """Consume queue completions: admit each block into its
        *submitter's* cache (tickets from other stores sharing the
        queue complete here too) and account out-of-order deliveries
        against the stats of whoever drove the clock."""
        for t in completions:
            target = t.owner if t.owner is not None else self
            target.cache.admit(t.block)
            if t.reordered:
                for s in (stats, self.total):
                    if s is not None:
                        s.completion_reorders += 1

    def attach_queue(self, queue: Optional[AsyncFetchQueue]) -> None:
        """Switch to a (shared) fetch queue, first draining any private
        one so its in-flight blocks are still admitted and accounted —
        silently orphaning tickets would re-fetch them later."""
        if self.queue is not None and self.queue is not queue:
            self._deliver(self.queue.drain(), None)
        self.queue = queue
        if queue is not None and self.tracer is not None and \
                getattr(queue, "tracer", None) is None:
            queue.tracer = self.tracer

    # ------------------------------------------------------- accounting
    def _log(self, kind: str, b: int) -> None:
        if self.fetch_log is not None:
            self.fetch_log.append((kind, b))

    def _bump(self, stats: Optional[IOStats], field: str, n: int) -> None:
        for s in (stats, self.total):
            if s is not None:
                setattr(s, field, getattr(s, field) + n)

    def _account(self, stats: Optional[IOStats], tier: int, trip: bool,
                 prefetched: int, joined: bool = False,
                 residual: float = 0.0) -> None:
        for s in (stats, self.total):
            if s is None:
                continue
            s.block_reads += 1
            if tier == 1:
                s.cache_hits += 1
            elif tier == 2:
                s.tier2_hits += 1
            else:
                s.cache_misses += 1
            if trip:
                s.io_round_trips += 1
            if joined:
                s.inflight_joins += 1
                s.join_residual += residual
            s.prefetched_blocks += prefetched
            if self.queue is not None:
                s.inflight_peak = max(s.inflight_peak, len(self.queue))

    # ------------------------------------------------------------ stats
    @property
    def hit_rate(self) -> float:
        return self.total.cache_hit_rate

    def freq_delta(self, since: Optional[Counter] = None) -> Counter:
        """Demand-read counts accumulated since ``since`` (an earlier
        snapshot of ``block_freq``; None = lifetime).

        The per-interval drift signal the serving ``RepackScheduler``
        folds: lifetime counts would let a long-dead workload anchor
        the pack forever, so the scheduler windows each decision on the
        traffic since its last one. ``block_freq`` itself keeps
        accumulating — snapshots are the caller's watermark, the store
        never forgets."""
        if since is None:
            return Counter(self.block_freq)
        out = Counter()
        for b, c in self.block_freq.items():
            d = c - since.get(b, 0)
            if d > 0:
                out[b] = d
        return out


def make_cached_store(store: BlockStore, cache_params,
                      block_of: Optional[np.ndarray] = None,
                      adj: Optional[np.ndarray] = None,
                      deg: Optional[np.ndarray] = None,
                      seed_ids: Optional[Sequence[int]] = None,
                      queue: Optional[AsyncFetchQueue] = None,
                      record_fetches: bool = False) -> CachedBlockStore:
    """Wrap ``store`` per ``CacheParams``: resolve the byte budget,
    split it across tiers (``tier2_frac`` > 0 → ``TieredBlockCache``
    with compressed PQ-space summaries), pin the build-time hot set
    (needs ``block_of``/``adj``/``deg``/``seed_ids``; skipped when
    absent), pick the eviction policy, and attach the async fetch queue
    (``queue_depth`` > 0, or a shared ``queue`` from the serving
    plane)."""
    budget = cache_params.resolve_budget(store.disk_bytes())
    block_bytes = max(int(store.block_kb * 1024), 1)
    tier2_bytes = int(budget * getattr(cache_params, "tier2_frac", 0.0))
    tier1_bytes = budget - tier2_bytes
    pinned: Sequence[int] = ()
    if (cache_params.pin_fraction > 0 and block_of is not None
            and adj is not None and deg is not None
            and seed_ids is not None and len(seed_ids) > 0):
        pin_blocks = int(cache_params.pin_fraction
                         * (tier1_bytes // block_bytes))
        pinned = hot_block_pin_set(block_of, adj, deg, seed_ids,
                                   max_blocks=pin_blocks)
    if tier2_bytes > 0:
        cache = TieredBlockCache(
            tier1_bytes, tier2_bytes, block_bytes,
            compression=cache_params.tier2_compression,
            policy=cache_params.policy, pinned=pinned)
    else:
        cache = BlockCache(budget, block_bytes,
                           policy=cache_params.policy, pinned=pinned)
    if queue is None and cache_params.queue_depth > 0:
        queue = AsyncFetchQueue(depth=cache_params.queue_depth)
    return CachedBlockStore(store, cache,
                            prefetch_width=cache_params.prefetch_width,
                            queue=queue,
                            record_fetches=record_fetches)


def cached_view(view, graph, cache_params,
                queue: Optional[AsyncFetchQueue] = None,
                record_fetches: bool = False):
    """The one way to cache-front a ``SegmentView`` (used by
    ``core.segment``, the serving plane and the tests alike).

    Seeds the build-time hot set from the navigation-graph sample — the
    entry neighborhood every query traverses first — falling back to the
    static entry when navigation is off (``hotset.view_seed_ids``, the
    same seeds the device tier-0 pack selects from). ``view`` is
    duck-typed (kept untyped to avoid a circular import with
    ``core.search``).
    """
    seeds = view_seed_ids(view)
    store = make_cached_store(view.store, cache_params,
                              block_of=view.layout.block_of,
                              adj=graph.adj, deg=graph.deg,
                              seed_ids=seeds,
                              queue=queue,
                              record_fetches=record_fetches)
    return dataclasses.replace(view, store=store)
