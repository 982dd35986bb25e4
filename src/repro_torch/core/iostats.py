"""I/O accounting and the latency cost model (Eq. 4): the port's copy of
``repro.core.iostats``, numpy and plain Python only, with the same names
and field names, so that a fold of the port's device columns is the
JAX package's fold.

  * ``IOStats`` — per-query counters: block reads (mean I/Os), vertices
    fetched vs vertices used (vertex-utilization ξ, Tab. 2), hops (path
    length ℓ), distance computations, cache-tier hits, and the async
    fetch-queue counters (``inflight_peak``, ``tier2_hits``,
    ``completion_reorders``, ``inflight_joins``).
    ``IOStats.from_device_batch`` folds one served batch's columns
    (``SegmentServer.batch_stats``); ``fold_rank_batches`` and
    ``merge_ranks`` fold a mesh step's per-rank columns.
  * ``CostModel`` — T_total = T_io + T_comp + T_other (Eq. 4), with an
    overlap factor for the I/O–compute pipeline (§5.1). Two presets,
    copied from the JAX package: the paper's NVMe segment and the TPU
    HBM-block regime of DESIGN.md §2. Their latencies are *model
    parameters* kept so that the serving plane's consumers (scheduler,
    router, calibration) price what the JAX package prices; they are not
    timings of a GPU, and a latency derived from them is modeled, not
    measured.

Pricing summary (repro.io):

  * demand misses (and legacy uncached reads) pay a full ``t_block_io``
    round trip; tier-0 hits — device reads served by the VMEM hot-tile
    pack (``device_search``) — pay ``t_tier0_hit`` (no DMA); tier-1
    cache hits pay ``t_cache_hit``; tier-2 hits — demand reads served
    by a compressed PQ-space block summary — pay ``t_tier2_hit``
    (decompress + re-rank, no disk trip);
  * synchronous coalesced prefetch pays ``t_batch_block`` per extra
    block, except that a round trip with *no* demand miss (a cache hit
    whose trip exists only to carry speculative blocks) pays one full
    ``t_block_io`` for its first block — a trip cannot be cheaper than
    the queue submission it models;
  * asynchronous speculative fetches are priced by queue occupancy:
    a fetch submitted with ``o`` fetches in flight contributes
    ``t_batch_block / o`` of serial time (``queue_occ_weight`` sums the
    ``1/o`` terms), so deep queues amortize toward zero serial cost
    while shallow queues degrade to the flat synchronous price;
  * a demand read that joins an already-in-flight fetch
    (``inflight_joins``) pays only the modeled residual service time
    (``join_residual`` × ``t_block_io``) instead of a new round trip;
  * a cold block touch that joins another request's gather of the same
    block *in the same device round* (``dedup_saved_fetches`` — the
    batched device search unions per-round block requests across the
    WHOLE batch, DESIGN.md §8; ``dedup_cross_tile`` counts the subset
    joining across kernel query tiles) pays ``t_dedup_hit`` (a VMEM
    broadcast of the one DMA that did happen) instead of its own
    ``t_block_io``;
  * stats flagged ``dma_pipelined`` (the fused kernel's double-buffered
    cold gather) overlap the round-granular streaming-DMA term with the
    occupancy-weighted round compute — ``max(dma, compute)`` per round
    instead of their sum; unflagged stats price exactly as before;
  * stats flagged ``dma_speculative`` (the cross-round speculative
    pipeline, DESIGN.md §9) additionally move the ``spec_hits`` share
    of the streaming DMAs one round earlier — off the critical path —
    so the pipelined chain pays ``max(dma x (1 - hit_frac), compute)``
    per round, while every ``spec_wasted`` block (speculated but never
    consumed) is surcharged serially at the bandwidth rate;
  * stats that carry the batched loop's round count (``batch_rounds`` >
    0, set by ``from_device(rounds=...)``) switch a cost model with
    ``t_round`` > 0 into the *round-granular* regime (DESIGN.md §5):
    the lockstep round chain pays ``batch_rounds x t_round`` of DMA
    latency once for the whole batch, cold DMAs then stream at the
    ``t_batch_block`` bandwidth rate instead of each paying a full
    round trip, and compute is occupancy-weighted — ``batch_rounds x
    rounds_active_weight x t_round_comp``, so a converged query's idle
    rounds cost nothing. Stats without a round count (the host paths)
    price exactly as before.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class IOStats:
    block_reads: int = 0        # demand block accesses (the paper's I/Os)
    io_round_trips: int = 0     # batched fetches issued (≤ block_reads)
    tier0_hits: int = 0         # demand reads served by tier 0 (the
    #                             device VMEM hot-tile pack — no HBM DMA)
    cache_hits: int = 0         # demand reads served by tier 1 (full blocks)
    tier2_hits: int = 0         # demand reads served by tier 2 (compressed
    #                             PQ-space summaries — re-rank, no disk trip)
    cache_misses: int = 0       # demand reads that went to "disk"
    prefetched_blocks: int = 0  # sync speculative fetches coalesced into trips
    queue_fetches: int = 0      # fetches submitted through the async queue
    #                             (demand + speculative)
    queue_occ_weight: float = 0.0  # Σ 1/occupancy over async speculative
    #                                fetches (serial-share weight)
    inflight_peak: int = 0      # max fetches simultaneously in flight
    inflight_joins: int = 0     # demand misses that joined an in-flight
    #                             fetch (cross-query dedup wins)
    join_residual: float = 0.0  # Σ residual service fraction over joins
    completion_reorders: int = 0  # completions delivered out of submit order
    dedup_saved_fetches: int = 0  # cold device touches that joined another
    #                               request's same-round gather of the same
    #                               block (cross-query dedup — no own DMA).
    #                               Scope: the WHOLE device batch, the
    #                               union the fused kernel's pass 1 dedups
    #                               across (DESIGN.md §8) — NOT one kernel
    #                               query tile. Additive under merge, like
    #                               every join counter.
    dedup_cross_tile: int = 0   # the cross-tile SUBSET of
    #                             dedup_saved_fetches: joins whose paying
    #                             requester sits in a different round-
    #                             kernel query tile — what batch scope
    #                             wins over per-tile dedup (whose modeled
    #                             DMAs = cache_misses - (dedup_saved_fetches
    #                             - dedup_cross_tile)). Always <= the
    #                             total; additive under merge (both count
    #                             joins, so a sum of queries' splits is
    #                             the batch's split).
    dma_pipelined: int = 0      # 1 when the fused kernel ran its cold
    #                             gather double-buffered (params.
    #                             pipeline_dma): the CostModel then
    #                             overlaps the streaming cold-DMA term
    #                             with round compute — max(dma, compute)
    #                             per round. A flag, not a count: merged
    #                             by max (a batch is pipelined or not).
    spec_hits: int = 0          # cold DMAs this query paid for that the
    #                             cross-round speculative pipeline
    #                             (params.speculate, DESIGN.md §9) had
    #                             already issued one round early — their
    #                             latency hides behind round i's compute.
    #                             Subset of the paying requests
    #                             (cold & ~joined), so spec_hits <= the
    #                             full-read count. Additive under merge.
    spec_wasted: int = 0        # speculated blocks the next round never
    #                             requested cold — DMAs issued for
    #                             nothing (the mis-speculation price the
    #                             CostModel surcharges). Additive.
    dma_speculative: int = 0    # 1 when the batch ran the speculative
    #                             cross-round pipeline: the CostModel
    #                             then discounts the streaming-DMA term
    #                             by the spec hit fraction and charges
    #                             spec_wasted DMAs serially. A flag,
    #                             merged by max like dma_pipelined.
    rounds_active_weight: float = 0.0  # Σ hops / batch rounds: the share
    #                               of the batched loop's rounds this query
    #                               was live for (divergence occupancy)
    batch_rounds: int = 0       # rounds of the batched device loop this
    #                             query rode in (shared across the batch,
    #                             so merged by max — exact when merging
    #                             one batch's queries; across batches it
    #                             is the longest batch's chain)
    vertices_fetched: int = 0   # ε per block read
    vertices_used: int = 0      # distance-evaluated full-precision vertices
    hops: int = 0               # total expansions (== block reads)
    hops_to_best: int = 0       # ℓ: hop at which the final top-1 was
    #                             found (the paper's path length)
    dist_comps: int = 0         # full-precision distance computations
    pq_comps: int = 0           # ADC distance computations
    hot_tier_hits: int = 0      # vertex visits answered by the in-memory
    #                             hot tier (DESIGN.md §10) — the memory-
    #                             latency half of hybrid routing. Vertex-
    #                             granular (one exact distance + queue op
    #                             each), NOT block reads: the hot tier
    #                             sits *above* the block hierarchy, so
    #                             these never enter block_reads or the
    #                             cache_hit_rate denominator. Additive.

    # merged with max(), not +: peaks, hop marks, the (batch-shared)
    # round count and the pipelined/speculative flags are not additive
    _MAX_FIELDS = ("hops_to_best", "inflight_peak", "batch_rounds",
                   "dma_pipelined", "dma_speculative")

    def merge(self, other: "IOStats") -> None:
        new_trips = self.io_round_trips + other.io_round_trips
        new_reads = self.block_reads + other.block_reads
        if new_trips > new_reads:
            # validate before mutating so a caught error leaves the
            # accumulator untouched
            raise ValueError(
                f"io_round_trips ({new_trips}) would exceed block_reads "
                f"({new_reads}) after merge — a batched fetch path issued "
                "more round trips than demand reads")
        for f in dataclasses.fields(self):
            if f.name in self._MAX_FIELDS:
                setattr(self, f.name, max(getattr(self, f.name),
                                          getattr(other, f.name)))
                continue
            setattr(self, f.name,
                    getattr(self, f.name) + getattr(other, f.name))

    @classmethod
    def from_device(cls, io, tier0_hits=0, hops=0, dedup_saved=0,
                    rounds=0, dedup_cross=0,
                    pipelined=False, spec_hits=0, spec_wasted=0,
                    speculative=False, hot_tier=0) -> "IOStats":
        """Counters of one query's device search (``device_anns``):
        ``io`` cold block touches, ``tier0_hits`` touches served by the
        VMEM hot-tile pack, ``hops`` DMA round trips, ``dedup_saved``
        cold touches that joined another request's same-round gather —
        batch scope (so only ``io - dedup_saved`` DMAs actually
        issued), ``dedup_cross`` its cross-tile subset, ``rounds``
        total loop rounds of the batch this query rode in,
        ``pipelined`` whether the kernel double-buffered its cold
        gather. ``spec_hits``/``spec_wasted``/``speculative`` carry the
        cross-round speculative pipeline's accounting (DESIGN.md §9):
        hits are paying DMAs that were pre-issued one round early
        (clamped to the paying count ``io - dedup_saved``), wasted are
        speculated blocks never consumed. Cold DMAs price as misses
        (one trip each — batched-width amortization is already in the
        hop count), hot touches at ``t_tier0_hit``, deduped touches at
        ``t_dedup_hit``. ``hot_tier`` counts the query's vertex visits
        in the in-memory hot tier before the cold search began (hybrid
        routing, DESIGN.md §10) — priced at ``t_hot_tier_hit``, kept
        out of the block-touch totals."""
        io, t0, h = int(io), int(tier0_hits), int(hops)
        saved = min(int(dedup_saved), io)
        cross = min(int(dedup_cross), saved)
        sh = min(int(spec_hits), io - saved)
        return cls(block_reads=io + t0, io_round_trips=io - saved,
                   cache_misses=io, tier0_hits=t0, hops=h,
                   hot_tier_hits=int(hot_tier),
                   dedup_saved_fetches=saved, dedup_cross_tile=cross,
                   dma_pipelined=int(bool(pipelined)),
                   spec_hits=sh, spec_wasted=int(spec_wasted),
                   dma_speculative=int(bool(speculative)),
                   batch_rounds=int(rounds),
                   rounds_active_weight=(h / int(rounds)
                                         if int(rounds) > 0 else 0.0))

    @classmethod
    def from_device_batch(cls, io, tier0_hits, hops, dedup_saved,
                          rounds, dedup_cross=None,
                          pipelined=False, spec_hits=None,
                          spec_wasted=None,
                          speculative=False,
                          hot_tier=None) -> "IOStats":
        """Fold one batch's per-query device columns (the arrays a
        ``DeviceSearchResult`` / ``make_search_step`` rank emits) into
        one merged ``IOStats``: counters sum, ``batch_rounds`` is the
        shared round count, ``rounds_active_weight`` becomes the mean
        number of live queries per round. ``dedup_cross`` (the
        cross-tile column) and the speculative columns
        (``spec_hits``/``spec_wasted``) default to zeros for pre-split
        callers. This is THE fold both the serving ``RepackScheduler``
        objective and the benchmark QPS model
        (``paper_tables.mesh_qps_estimate``) price — one modeled step
        time, two consumers."""
        if dedup_cross is None:
            dedup_cross = [0] * len(io)
        if spec_hits is None:
            spec_hits = [0] * len(io)
        if spec_wasted is None:
            spec_wasted = [0] * len(io)
        if hot_tier is None:
            hot_tier = [0] * len(io)
        agg = cls()
        for i, t0, h, sv, cx, sh, sw, ht in zip(io, tier0_hits, hops,
                                                dedup_saved, dedup_cross,
                                                spec_hits, spec_wasted,
                                                hot_tier):
            agg.merge(cls.from_device(i, t0, h, sv, rounds, cx,
                                      pipelined, sh, sw, speculative,
                                      ht))
        return agg

    @classmethod
    def fold_rank_batches(cls, columns) -> "dict[int, IOStats]":
        """Rank-keyed fold of a mesh-served step: ``columns[rank] =
        (io, tier0_hits, hops, dedup_saved, rounds[, dedup_cross
        [, pipelined[, spec_hits, spec_wasted[, speculative]]]])`` —
        each rank's per-query device columns, folded per rank with
        ``from_device_batch`` (5-tuples price the cross-tile column as
        zero; short tuples zero the speculative columns too). This is
        THE shared mesh fold: the router's windowed per-rank stats, the
        scheduler objective and ``mesh_qps_estimate`` all price these
        same per-rank IOStats, and ``merge_ranks`` defines the one
        correct total."""
        return {int(r): cls.from_device_batch(*cols)
                for r, cols in columns.items()}

    @staticmethod
    def merge_ranks(per_rank) -> "IOStats":
        """Mesh totals from a rank-keyed fold: counters sum across
        ranks, ``_MAX_FIELDS`` (incl. ``batch_rounds`` — the step is
        gated by the slowest rank's chain) merge by max. NOTE
        ``rounds_active_weight`` is a per-batch occupancy (Σ hops /
        that rank's rounds); summing it across ranks with different
        round counts is only meaningful through this merge — never
        re-fold summed columns."""
        total = IOStats()
        for r in sorted(per_rank):
            total.merge(per_rank[r])
        return total

    @property
    def cache_hit_rate(self) -> float:
        """Fraction of demand reads served by any cache tier."""
        hits = self.tier0_hits + self.cache_hits + self.tier2_hits
        tracked = hits + self.cache_misses
        if tracked == 0:
            return 0.0
        return hits / tracked

    @property
    def vertex_utilization(self) -> float:
        """ξ: fraction of fetched vertices actually used (Tab. 2)."""
        if self.vertices_fetched == 0:
            return 0.0
        return self.vertices_used / self.vertices_fetched


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Latency model; times in microseconds.

    Cache-aware I/O pricing (repro.io): demand reads served by the
    ``BlockCache`` cost ``t_cache_hit`` (memory latency) instead of
    ``t_block_io``; a batched round trip pays one full ``t_block_io``
    plus ``t_batch_block`` per extra coalesced block (queue-depth
    amortization on NVMe / contiguous DMA on TPU). Stats with no cache
    counters price every ``block_reads`` at ``t_block_io``, so uncached
    figures do not depend on the cache terms.
    """
    t_block_io: float           # one block fetch round trip
    t_dist: float               # one full-precision distance (D-dim)
    t_pq: float                 # one ADC distance
    t_hop_other: float = 0.2    # queue maintenance per hop
    t_cache_hit: float = 0.0    # demand read served from memory (tier 1)
    t_batch_block: float = 0.0  # extra block coalesced into a round trip
    #                             (0.0 → priced as a full t_block_io)
    t_tier2_hit: float = 0.0    # demand read served by a compressed
    #                             PQ-space summary (decompress + re-rank)
    t_tier0_hit: float = 0.0    # demand read served by the device VMEM
    #                             hot-tile pack (tier 0 — no HBM DMA)
    t_dedup_hit: float = 0.0    # cold touch that joined another query's
    #                             same-round gather (VMEM broadcast of a
    #                             DMA someone else already paid for)
    t_hot_tier_hit: float = 0.0  # one vertex visit in the in-memory hot
    #                              tier (DESIGN.md §10): an exact
    #                              distance + queue op at memory latency.
    #                              Compute-side — it never enters
    #                              ``_io_time``, so the modeled
    #                              memory-vs-disk split of hybrid
    #                              routing stays clean.
    t_round: float = 0.0        # round-granular regime (DESIGN.md §5):
    #                             lockstep cost per batched-loop round —
    #                             the gather issue + merge barrier every
    #                             live query waits on (0 → hops-granular
    #                             pricing)
    t_round_comp: float = 0.0   # per live query per round compute share
    #                             (rank + merge of its fetched tiles) —
    #                             weighted by rounds_active_weight so
    #                             idle rounds of a converged query are
    #                             free
    name: str = "model"

    def _round_chain(self, s: IOStats) -> float:
        """The lockstep round chain: one DMA-latency + barrier unit per
        batched-loop round (0 outside the round-granular regime)."""
        if self.t_round <= 0.0 or s.batch_rounds <= 0:
            return 0.0
        return s.batch_rounds * self.t_round

    def _round_comp(self, s: IOStats) -> float:
        """Occupancy-weighted round compute: batch_rounds x
        rounds_active_weight = the query's live rounds (summed over a
        merged batch: total live query-rounds), each paying
        ``t_round_comp`` — monotone in ``rounds_active_weight``."""
        if self.t_round <= 0.0 or s.batch_rounds <= 0:
            return 0.0
        return s.batch_rounds * s.rounds_active_weight * self.t_round_comp

    def _io_time(self, s: IOStats) -> float:
        # Demand misses sit on the critical path: each pays a full round
        # trip. Synchronous speculative fetches coalesce into an already
        # paid-for trip at t_batch_block each — unless the trip carried
        # *only* speculative blocks (a cache hit with prefetch targets),
        # in which case its first block pays the full t_block_io the trip
        # itself costs. Async speculative fetches are priced by queue
        # occupancy: t_batch_block/o of serial time each (the 1/o terms
        # are pre-summed in queue_occ_weight), so depth amortizes them.
        # Joins of in-flight fetches pay only the modeled residual.
        # Hits are memory copies; tier-2 hits are decompress + re-rank.
        # Reads with no cache accounting (uncached paths, and the
        # uncached share of merged mixed stats) price as misses.
        t_batch = self.t_batch_block if self.t_batch_block else \
            self.t_block_io
        full_reads = max(s.block_reads - s.tier0_hits - s.cache_hits
                        - s.tier2_hits - s.inflight_joins
                        - s.dedup_saved_fetches, 0)
        # round-granular regime: the lockstep chain (``_round_chain``)
        # already pays the per-round DMA latency once for the whole
        # batch, so cold DMAs stream at the bandwidth rate instead of
        # each paying its own full round trip
        round_granular = self.t_round > 0.0 and s.batch_rounds > 0
        t_miss = t_batch if round_granular else self.t_block_io
        # trips beyond one-per-miss are speculative-only (hit + prefetch);
        # async demand submissions count one trip per non-joined miss, so
        # adding inflight_joins back keeps the sync surplus exact.
        spec_trips = min(max(s.io_round_trips - s.cache_misses
                            + s.inflight_joins, 0), s.prefetched_blocks)
        return (self._round_chain(s)
                + full_reads * t_miss
                + spec_trips * self.t_block_io
                + (s.prefetched_blocks - spec_trips) * t_batch
                + s.queue_occ_weight * t_batch
                + s.join_residual * self.t_block_io
                + s.dedup_saved_fetches * self.t_dedup_hit
                + s.tier0_hits * self.t_tier0_hit
                + s.cache_hits * self.t_cache_hit
                + s.tier2_hits * self.t_tier2_hit)

    def _stream_dma(self, s: IOStats) -> float:
        """The round-granular cold-DMA streaming term — the
        ``t_batch_block``-rate part of ``_io_time`` (0 outside that
        regime): what the double-buffered kernel puts in flight behind
        round compute when ``dma_pipelined`` is set."""
        if self.t_round <= 0.0 or s.batch_rounds <= 0:
            return 0.0
        t_batch = self.t_batch_block if self.t_batch_block else \
            self.t_block_io
        full_reads = max(s.block_reads - s.tier0_hits - s.cache_hits
                        - s.tier2_hits - s.inflight_joins
                        - s.dedup_saved_fetches, 0)
        return full_reads * t_batch

    def _spec_hit_frac(self, s: IOStats) -> float:
        """Fraction of the streaming cold DMAs the cross-round
        speculative pipeline pre-issued one round early (0 outside the
        round-granular speculative regime). spec_hits is clamped to the
        paying-request count at fold time, so the fraction is in
        [0, 1] by construction; the clamp here guards hand-built
        stats."""
        if not s.dma_speculative or self.t_round <= 0.0 \
                or s.batch_rounds <= 0:
            return 0.0
        t_batch = self.t_batch_block if self.t_batch_block else \
            self.t_block_io
        stream = self._stream_dma(s)
        if stream <= 0.0:
            return 0.0
        return min(s.spec_hits * t_batch / stream, 1.0)

    def _spec_waste(self, s: IOStats) -> float:
        """The mis-speculation surcharge: every speculated block the
        next round never consumed still streamed its DMA — charged
        serially at the bandwidth rate, so wasted speculation is
        visible in the modeled total (0 outside the regime)."""
        if not s.dma_speculative or self.t_round <= 0.0 \
                or s.batch_rounds <= 0:
            return 0.0
        t_batch = self.t_batch_block if self.t_batch_block else \
            self.t_block_io
        return s.spec_wasted * t_batch

    def _hot_time(self, s: IOStats) -> float:
        """The memory-latency half of hybrid routing: hot-tier vertex
        visits price as compute (exact distance + queue op each), never
        as I/O — keeping the memory-vs-disk split exact."""
        return s.hot_tier_hits * self.t_hot_tier_hit

    def latency_us(self, s: IOStats, pipeline: bool = False) -> float:
        t_io = self._io_time(s)
        t_comp = (s.dist_comps * self.t_dist + s.pq_comps * self.t_pq
                  + self._round_comp(s) + self._hot_time(s))
        t_other = s.hops * self.t_hop_other
        if pipeline:
            # §5.1: DR and DC run concurrently; serial residue is the max
            # plus the non-overlappable other time.
            return max(t_io, t_comp) + t_other
        round_granular = self.t_round > 0.0 and s.batch_rounds > 0
        if s.dma_pipelined and round_granular:
            # DESIGN.md §8: the double-buffered cold gather overlaps the
            # streaming DMA term with the occupancy-weighted round
            # compute — per round the kernel pays max(dma, compute),
            # never their sum. The lockstep chain (issue + barrier) and
            # every non-round term stay serial. Stats without the flag
            # (pipeline_dma off, per-tile kernels, host paths) price
            # exactly as before.
            #
            # DESIGN.md §9: the speculative cross-round pipeline moves
            # the spec-hit share of the stream one round earlier, where
            # it hides behind round i's compute regardless of the
            # within-round balance — only the UN-speculated residue
            # still races this round's compute, so the chain prices
            # max(stream x (1 - h), compute) + the wasted-DMA
            # surcharge. h = 0 (speculation off) reduces exactly to
            # the pipelined form without speculation.
            stream = self._stream_dma(s)
            rcomp = self._round_comp(s)
            h = self._spec_hit_frac(s)
            return ((t_io - stream) + (t_comp - rcomp)
                    + max(stream * (1.0 - h), rcomp) + t_other
                    + self._spec_waste(s))
        if s.dma_speculative and round_granular:
            # speculative without the double-buffered gather: the
            # pre-issued share of the stream overlaps the previous
            # round's compute (it left the critical path entirely);
            # the rest of the pricing is the serial round-granular
            # form plus the wasted-DMA surcharge.
            stream = self._stream_dma(s)
            h = self._spec_hit_frac(s)
            return (t_io - stream * h) + t_comp + t_other \
                + self._spec_waste(s)
        return t_io + t_comp + t_other

    def breakdown(self, s: IOStats, pipeline: bool = False) -> dict:
        t_io = self._io_time(s)
        t_comp = (s.dist_comps * self.t_dist + s.pq_comps * self.t_pq
                  + self._round_comp(s) + self._hot_time(s))
        t_other = s.hops * self.t_hop_other
        total = self.latency_us(s, pipeline)
        return {"t_io_us": t_io, "t_comp_us": t_comp, "t_other_us": t_other,
                "total_us": total,
                # hybrid hot-tier terms (DESIGN.md §10): memory-latency
                # visits, priced inside t_comp — the memory half of the
                # hybrid memory-vs-disk split (t_io is the disk half)
                "hot_tier_hits": s.hot_tier_hits,
                "t_hot_tier_us": self._hot_time(s),
                # round-granular terms (0 outside that regime): the
                # lockstep chain, the occupancy-weighted compute and
                # the streaming cold-DMA share a dma_pipelined batch
                # overlaps with compute (max(dma, compute) per round)
                "t_round_chain_us": self._round_chain(s),
                "t_round_comp_us": self._round_comp(s),
                "t_dma_stream_us": self._stream_dma(s),
                "dma_pipelined": bool(s.dma_pipelined),
                # speculative cross-round pipeline terms (0/False
                # outside that regime): the pre-issued share of the
                # stream and the serial mis-speculation surcharge
                "dma_speculative": bool(s.dma_speculative),
                "spec_hit_frac": self._spec_hit_frac(s),
                "t_spec_waste_us": self._spec_waste(s),
                "io_frac": t_io / max(t_io + t_comp + t_other, 1e-9),
                # per-tier demand-read service counts (tier 0 = device
                # VMEM hot tiles, 1 = host full blocks, 2 = compressed
                # summaries) so hierarchy sweeps can report where reads
                # were absorbed
                "tier0_hits": s.tier0_hits, "tier1_hits": s.cache_hits,
                "tier2_hits": s.tier2_hits,
                "cache_misses": s.cache_misses}


# The paper's segment: NVMe 4KB random read ~90–100 µs per round-trip,
# ~0.05 µs per 128-d L2 on one core, ADC ~0.01 µs. A cache hit is a DRAM
# copy of one 4 KB block (~0.5 µs); an extra block coalesced into an
# in-flight round trip rides the same queue slot (~18 µs). A tier-2 hit
# decompresses a ~256 B PQ-space summary and re-ranks (~2.5 µs).
NVME_SEGMENT = CostModel(t_block_io=95.0, t_dist=0.055, t_pq=0.012,
                         t_cache_hit=0.5, t_batch_block=18.0,
                         t_tier2_hit=2.5, t_tier0_hit=0.5,
                         t_dedup_hit=0.5, t_hot_tier_hit=0.1,
                         name="nvme")

# TPU regime (DESIGN.md §2): 4 KB HBM→VMEM DMA ≈ 1.2 µs latency-bound,
# VPU block ranking ≈ 0.02 µs/vector amortized, ADC ≈ 0.002 µs via LUT
# tiles. A tier-1 hit is an HBM-resident tile copy; coalesced blocks
# stream at HBM bandwidth (~0.35 µs per extra 4 KB); a tier-2 hit is a
# VMEM LUT re-rank of the resident summary tile. A tier-0 hit reads the
# hot tile already *in VMEM* — no DMA at all, just the probe, ~10 ns.
# A dedup hit rides another query's same-round DMA: the tile lands in
# VMEM once and broadcasts, so it prices like a tier-0 hit.
# Round-granular terms (DESIGN.md §5, active only on stats that carry
# batch_rounds): one lockstep loop round costs the latency-bound DMA
# issue plus the candidate-merge barrier ≈ 1.5 µs, and each *live*
# query adds ≈ 0.15 µs of VPU rank + top-k merge for its tiles — idle
# rounds of a converged query are free (occupancy-weighted via
# rounds_active_weight).
# A hot-tier visit is one exact distance + queue op on an in-memory
# graph: ~DRAM-speed on the NVMe host (~0.1 µs incl. the queue push),
# ~one VPU distance on TPU (~0.02 µs).
TPU_HBM_SEGMENT = CostModel(t_block_io=1.2, t_dist=0.02, t_pq=0.002,
                            t_cache_hit=0.05, t_batch_block=0.35,
                            t_tier2_hit=0.08, t_tier0_hit=0.01,
                            t_dedup_hit=0.01, t_hot_tier_hit=0.02,
                            t_round=1.5,
                            t_round_comp=0.15, name="tpu-hbm")
