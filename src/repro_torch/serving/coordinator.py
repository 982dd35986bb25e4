"""The serving plane on one card (port of ``repro.serving.
coordinator``, Fig. 1(b)).

  * ``SegmentServer`` — the batched device search, the hybrid hot tier
    with tombstones, and the online tier-0 repack;
  * ``HostSegmentServer`` — the host block search (``core.search.anns``)
    over one view whose cache-fronted store is shared by every query it
    serves, so residency and the hit rate come from inter-query
    locality;
  * ``attach_shared_fetch_queue`` — one ``AsyncFetchQueue`` shared by
    the cache-fronted servers, so concurrent queries join each other's
    in-flight fetches;
  * ``QueryCoordinator`` — scatters a batch over ``SegmentTarget``s,
    merges the per-segment top-k by (dist, global id), reports the
    batch's counters (``STATS_SCHEMA``) and drives a
    ``serving.scheduler.RepackScheduler``; the mesh router
    (``serving.router.MeshQueryRouter``) drops in as one target.

With a tracer and a metrics registry (``QueryCoordinator(tracer=,
metrics=)``, wired into every target through ``attach_obs``), a batch
records ``coord.batch`` and ``coord.segment`` spans, a host server its
``host.search`` span, and the stats dict is republished as ``serve.*``
metrics (``obs``). Below ``coord.segment`` a device server records its
segment search (``core.device_search``) with the coordinator's tracer,
which the coordinator passes to ``SegmentServer.search`` on every batch
(so setting ``QueryCoordinator.tracer`` is the one switch):
``search.prologue``, one ``search.round`` a round with its phases' ends
(``round.compact`` ... ``round.merge``), ``search.readback`` around the
copies of the results to the host (arg ``syncs``, the search's
``batch_stats()["syncs"]``), and a ``sync.<site>`` span around every
blocking read (``sync.loop``, ``sync.compact``, ``sync.readback``). A
span measures host time: ``search`` returns numpy, so a span closes
after the result reached the host.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.device_search import (SEARCH_TRACK, DeviceSegment,
                                            HostSyncs, device_anns,
                                            repack_tier0, to_numpy)
from repro_torch.configs.starling_segment import DEVICE_SEARCH_BATCH
from repro_torch.core.params import DeviceSearchParams, SearchParams
from repro_torch.core.search import SegmentView, anns
from repro_torch.io.async_fetch import AsyncFetchQueue
from repro_torch.io.cached_store import CachedBlockStore
from repro_torch.io.hottier import merge_hot_cold
from repro_torch.serving import target as tgt

# serving default: the divergence-aware batched preset (wide fetch +
# cross-query dedup + active-query compaction) at the paper's Γ; the
# tier-0 budget rides on the segment arrays themselves
# (``from_segment``), not on these search knobs
SERVE_DEVICE_SEARCH = dataclasses.replace(DEVICE_SEARCH_BATCH,
                                          candidates=64)


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
    ``k`` replaces just that field of ``params``.

    ``host`` (optional) is the host ``Segment`` the arrays were packed
    from: ``repack`` needs it, and a hybrid server takes the navigation
    graph's entries from it. ``hot_tier`` (optional, an ``io.hottier.
    HotTier``) makes the server hybrid: queries route hot-first, the
    device search is seeded from the exit frontier plus the navigation
    entries at a narrowed cold Γ, and the answers merge by ``(dist,
    id)`` with ``tombstones`` [num_vectors] bool masked from the cold
    side (the hot tier masks its own); the hot tier's visits land in the
    ``hot_tier_hits`` batch column.

    ``search(..., tracer=)`` records the segment search's spans; the
    batch's ``syncs`` count every blocking read of a device value, with a
    tracer or without: per segment search of R rounds, R + 1 loop tests
    (R when it stops at ``max_hops``), 2R compaction tests with
    ``compact_frac`` > 0 (R for a one-query batch) and nine copies of
    the results (ten with ``trace_rounds``); its ``graph_rounds`` count
    the rounds replayed from the round loop's CUDA graphs (none on the
    CPU)."""
    segment: DeviceSegment
    offset: int                   # base of this segment's id space
    num_vectors: int
    k_default: int = 10
    params: DeviceSearchParams = SERVE_DEVICE_SEARCH
    metric: str = "l2"
    device: str = "cuda"
    host: Optional[object] = None       # the host Segment (repack source)
    hot_tier: Optional[object] = None   # io.hottier.HotTier
    tombstones: Optional[np.ndarray] = None  # [num_vectors] bool

    def __post_init__(self):
        self.segment = self.segment.to(torch.device(self.device))

    def search(self, queries: np.ndarray, k: Optional[int] = None,
               tracer=None) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """queries [Q, D] -> (ids [Q, k], dists [Q, k], io [Q]);
        ``tracer`` (an ``obs.Tracer``) records the search's spans."""
        k = k or self.k_default
        queries = np.ascontiguousarray(queries, np.float32)
        n_dead = (int(self.tombstones.sum())
                  if self.tombstones is not None else 0)
        route = seeds = None
        k_cold = k
        candidates = max(self.params.candidates, k)
        if self.hot_tier is not None:
            route = self.hot_tier.route(queries, k)
            exits = route.exits.astype(np.int32)
            # the exits start the cold beam where memory converged, the
            # navigation entries keep its basin diversity
            if self.host is not None:
                nav_seeds = self.host.nav.entry_points(
                    queries, beam=self.params.nav_beam,
                    num=self.params.entry_points,
                    device=self.device).astype(np.int32)
                exits = np.concatenate([exits, nav_seeds], axis=1)
            seeds = torch.as_tensor(exits, device=self.segment.device)
            # over-fetch so the cold top-k survives the tombstone mask;
            # the hot tier took the early exploration, so Γ narrows
            k_cold = k + min(n_dead, k)
            candidates = max(k_cold, int(round(
                self.params.candidates
                * self.hot_tier.params.cold_gamma_frac)))
        q = torch.as_tensor(queries, device=self.segment.device)
        # a per-request k above the configured beam widens Γ with it
        p = dataclasses.replace(self.params, k=k_cold,
                                candidates=max(candidates, k_cold))
        r = device_anns(self.segment, q, p, metric=self.metric, seeds=seeds,
                        tracer=tracer)
        if tracer is None:
            cold_ids, cold_dists = self._read_back(r, HostSyncs())
        else:
            with tracer.span("search.readback", cat="search",
                             track=SEARCH_TRACK) as sp:
                cold_ids, cold_dists = self._read_back(r, HostSyncs(tracer))
                sp["syncs"] = self.last_syncs
        if route is None:
            self.last_hot_tier_hits = np.zeros(q.shape[0], np.int64)
            return cold_ids, cold_dists, self.last_io
        self.last_hot_tier_hits = route.hot_hits.astype(np.int64)
        ci = cold_ids.astype(np.int64)
        cd = cold_dists.astype(np.float32)
        if self.tombstones is not None:
            dead = (ci >= 0) & self.tombstones[np.maximum(ci, 0)]
            ci = np.where(dead, -1, ci)
            cd = np.where(dead, np.inf, cd)
        out_i = np.full((q.shape[0], k), -1, np.int64)
        out_d = np.full((q.shape[0], k), np.inf, np.float32)
        for qi in range(q.shape[0]):
            out_i[qi], out_d[qi] = merge_hot_cold(
                k, route.ids[qi], route.dists[qi], ci[qi], cd[qi])
        return out_i, out_d, self.last_io

    def _read_back(self, r, reads: HostSyncs):
        """Copy the search's results and counters to the host, each copy
        through ``reads``; sets the ``last_*`` columns, returns (ids,
        dists)."""
        def host(t):
            return reads.read("readback", to_numpy, t)
        self.last_io = host(r.io)
        self.last_tier0_hits = host(r.tier0_hits)
        self.last_hops = host(r.hops)
        self.last_dedup_saved = host(r.dedup_saved)
        self.last_dedup_cross = host(r.dedup_cross)
        self.last_spec_hits = host(r.spec_hits)
        self.last_spec_wasted = host(r.spec_wasted)
        self.last_rounds = int(r.rounds)
        self.last_graph_rounds = int(r.graph_rounds)
        self.last_round_log = (host(r.round_log)
                               if r.round_log is not None else None)
        out = host(r.ids), host(r.dists)
        self.last_syncs = r.syncs + reads.count
        return out

    def repack(self, observed, plan=None) -> int:
        """Swap the tier-0 pack for one re-ranked by ``observed``
        per-block demand counts (or the given ``plan``) at the same
        budget; results stay the same (exact copies either way). Returns
        the number of pack slots that changed."""
        if self.host is None:
            raise ValueError("SegmentServer.host is unset: build the "
                             "server with its host Segment to repack")
        self.segment, changed = repack_tier0(self.segment, self.host,
                                             observed, plan=plan)
        return changed

    def repack_source(self):
        return self.host

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
                "graph_rounds": self.last_graph_rounds,
                "syncs": self.last_syncs,
                "dma_pipelined": (self.params.pipeline_dma
                                  and self.params.fetch_impl == "fused"),
                "dma_speculative": self.params.speculate}

    def attach_obs(self, tracer, metrics) -> None:
        if self.hot_tier is not None and \
                (tracer is not None or metrics is not None):
            self.hot_tier.attach_obs(tracer, metrics,
                                     target=f"seg{self.offset}")


@dataclasses.dataclass
class HostSegmentServer:
    """Host-path segment server with one block cache shared by every
    query it serves. ``view.store`` should be a ``CachedBlockStore``
    (a segment built with ``SegmentParams.cache`` enabled); an uncached
    view serves the same results without cache counters. The routing
    keys and navigation entries run on ``device``."""
    view: SegmentView
    params: SearchParams
    offset: int                   # base of this segment's id space
    num_vectors: int
    k_default: int = 10
    device: str = "cuda"
    tracer: Optional[object] = None  # obs.trace.Tracer (optional)

    @classmethod
    def from_segment(cls, seg, offset: int,
                     device="cuda") -> "HostSegmentServer":
        return cls(view=seg.view, params=seg.params.search, offset=offset,
                   num_vectors=seg.num_vectors, device=device)

    def search(self, queries: np.ndarray, k: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """queries [Q, D] -> (ids [Q, k], dists [Q, k], block_reads [Q]);
        the per-query ``IOStats`` are kept in ``last_stats``."""
        if self.tracer is not None:
            with self.tracer.span("host.search", cat="serve",
                                  track=f"seg{self.offset}",
                                  n_queries=int(queries.shape[0]),
                                  k=int(k or self.k_default)) as sp:
                ids, dists, io = self._search(queries, k)
                sp["block_reads"] = int(io.sum())
            return ids, dists, io
        return self._search(queries, k)

    def _search(self, queries: np.ndarray, k: Optional[int]
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        ids, dists, stats = anns(self.view, queries, k or self.k_default,
                                 self.params, device=self.device)
        self.last_stats = stats
        io = np.asarray([s.block_reads for s in stats], np.int64)
        return ids, dists, io

    def cache_stats(self) -> Dict[str, float]:
        """Lifetime cache counters of the shared store (empty if
        uncached). When the store carries a metrics registry
        (``CachedBlockStore.attach_obs``), the same counters are
        republished through it first, so this dict is a view of what
        the registry reports."""
        store = self.view.store
        if not isinstance(store, CachedBlockStore):
            return {}
        store.publish_metrics()
        t = store.total
        return {"cache_hits": t.cache_hits,
                "tier2_hits": t.tier2_hits,
                "cache_misses": t.cache_misses,
                "io_round_trips": t.io_round_trips,
                "prefetched_blocks": t.prefetched_blocks,
                "queue_fetches": t.queue_fetches,
                "inflight_peak": t.inflight_peak,
                "inflight_joins": t.inflight_joins,
                "completion_reorders": t.completion_reorders,
                "hit_rate": t.cache_hit_rate}

    # ------------------------------------- SegmentTarget capability hooks
    def lifetime_stats(self) -> Dict[str, float]:
        return self.cache_stats()

    def demand_feed(self):
        store = self.view.store
        return store if isinstance(store, CachedBlockStore) else None

    def attach_obs(self, tracer, metrics) -> None:
        if tracer is not None and self.tracer is None:
            self.tracer = tracer
        store = self.view.store
        if isinstance(store, CachedBlockStore) and \
                (tracer is not None or metrics is not None):
            store.attach_obs(tracer, metrics, target=f"seg{self.offset}")


def attach_shared_fetch_queue(servers: Sequence["HostSegmentServer"],
                              depth: int = 8,
                              scheduler=None) -> AsyncFetchQueue:
    """Share one ``AsyncFetchQueue`` across every cache-fronted target
    (any whose ``demand_feed()`` yields a ``CachedBlockStore``): a demand
    read arriving while its block is in flight joins the ticket instead
    of issuing a new round trip. Each store drains its private queue
    first. ``scheduler`` (a ``RepackScheduler``) also registers every
    attached store as a demand feed. Returns the queue."""
    q = AsyncFetchQueue(depth=depth)
    attached = 0
    for s in servers:
        store = tgt.demand_feed(s)
        if isinstance(store, CachedBlockStore):
            store.attach_queue(q)
            if scheduler is not None:
                scheduler.attach_feed(store)
            attached += 1
    if attached == 0:
        raise ValueError("no cache-fronted serving targets to attach "
                         "the shared fetch queue to")
    return q


class QueryCoordinator:
    """Scatter -> per-segment search -> hierarchical merge.

    ``prune_fn(queries)`` picks the segment indices a batch goes to (all
    by default). ``scheduler`` (a ``serving.scheduler.RepackScheduler``)
    makes the coordinator the serving plane's control point: targets
    whose ``repack_source()`` yields a host ``Segment`` register as
    repack targets, those whose ``demand_feed()`` yields a cached store
    as demand feeds, and after every served batch the coordinator notes
    the device columns and lets the scheduler evaluate; a repack lands
    after the batch has returned. The coordinator speaks only the
    ``SegmentTarget`` protocol (``serving.target``): host servers, device
    servers and the ``MeshQueryRouter`` are interchangeable entries of
    ``servers``. ``tracer`` / ``metrics`` (``obs``) wire the coordinator,
    its targets and the scheduler into one observability plane."""

    def __init__(self, servers: List[tgt.SegmentTarget],
                 prune_fn: Optional[Callable] = None,
                 scheduler=None, tracer=None, metrics=None):
        self.servers = servers
        self.prune_fn = prune_fn          # (queries) -> segment indices
        self.scheduler = scheduler
        self.tracer = tracer              # obs: coord.batch /
        #                                   coord.segment spans
        self.metrics = metrics            # obs.MetricsRegistry the stats
        #                                   dict is republished through
        #                                   (same keys, same values)
        self._cache_seen: Dict[int, Tuple[int, int]] = {}  # per-server
        #   (hits, misses) lifetime watermark for per-call delta reporting
        for s in servers:
            if scheduler is not None:
                if tgt.repack_source(s) is not None:
                    scheduler.attach_target(s)
                feed = tgt.demand_feed(s)
                if feed is not None:
                    scheduler.attach_feed(feed)
            # wire the target (its store, fetch queue, hot tier, ranks)
            # into the observability plane the coordinator reports to
            if tracer is not None or metrics is not None:
                tgt.attach_obs(s, tracer, metrics)
        if scheduler is not None and tracer is not None and \
                getattr(scheduler, "tracer", None) is None:
            scheduler.tracer = tracer

    # every search() stats dict carries all of these keys, zeros
    # included; "repack" appears on batches where the scheduler
    # evaluated
    STATS_SCHEMA = ("segments_searched", "total_block_reads",
                    "mean_block_reads_per_query", "total_tier0_hits",
                    "total_dedup_saved", "total_dedup_cross",
                    "total_spec_hits", "total_spec_wasted",
                    "total_hot_tier_hits", "deduped_block_reads",
                    "cache_hits", "cache_misses", "cache_hit_rate")

    def search(self, queries: np.ndarray, k: int = 10
               ) -> Tuple[np.ndarray, np.ndarray, Dict]:
        if self.tracer is not None:
            with self.tracer.span("coord.batch", cat="serve",
                                  track="coord",
                                  n_queries=int(queries.shape[0]),
                                  k=int(k)) as sp:
                gi, gd, stats = self._search(queries, k)
                sp["block_reads"] = stats["total_block_reads"]
                sp["segments"] = stats["segments_searched"]
            return gi, gd, stats
        return self._search(queries, k)

    def _search(self, queries: np.ndarray, k: int
                ) -> Tuple[np.ndarray, np.ndarray, Dict]:
        targets = (self.prune_fn(queries) if self.prune_fn
                   else list(range(len(self.servers))))
        ids, dists, offs = [], [], []
        total_io, total_t0, total_saved, total_cross = 0, 0, 0, 0
        total_spec_h, total_spec_w, total_hot = 0, 0, 0
        for si in targets:
            s = self.servers[si]
            if self.tracer is not None:
                with self.tracer.span("coord.segment", cat="serve",
                                      track="coord",
                                      target=f"seg{s.offset}") as sp:
                    if isinstance(s, SegmentServer):  # its search's spans
                        i, d, io = s.search(queries, k, tracer=self.tracer)
                    else:
                        i, d, io = s.search(queries, k)
                    sp["block_reads"] = int(io.sum())
            else:
                i, d, io = s.search(queries, k)
            ids.append(i)
            dists.append(d)
            offs.append(s.offset)
            seg_io = int(io.sum())
            total_io += seg_io
            bs = tgt.batch_stats(s)
            if bs:
                total_t0 += int(np.asarray(bs["tier0_hits"]).sum())
                total_saved += int(np.asarray(bs["dedup_saved"]).sum())
                total_cross += int(np.asarray(bs["dedup_cross"]).sum())
                total_spec_h += int(np.asarray(bs["spec_hits"]).sum())
                total_spec_w += int(np.asarray(bs["spec_wasted"]).sum())
                total_hot += int(np.asarray(bs["hot_tier_hits"]).sum())
            if self.metrics is not None:
                # per-target attribution: which segment the reads hit
                self.metrics.counter("serve.block_reads",
                                     f"seg{s.offset}").inc(seg_io)
        gi, gd = merge_topk(ids, dists, offs, k)
        stats = {"segments_searched": len(targets),
                 "total_block_reads": total_io,
                 "mean_block_reads_per_query":
                     total_io / max(queries.shape[0], 1),
                 # block touches the device tier-0 pack absorbed (not in
                 # total_block_reads)
                 "total_tier0_hits": total_t0,
                 # cold touches that rode another query's same-round
                 # gather; deduped_block_reads is what the device issued
                 "total_dedup_saved": total_saved,
                 "total_dedup_cross": total_cross,
                 "total_spec_hits": total_spec_h,
                 "total_spec_wasted": total_spec_w,
                 # vertex visits the in-memory hot tier absorbed
                 "total_hot_tier_hits": total_hot,
                 "deduped_block_reads": total_io - total_saved}
        # shared-cache counters of the servers that expose them, as
        # deltas, so every key is per call (the cache stays warm)
        hits = misses = 0
        for si in targets:
            cs = tgt.lifetime_stats(self.servers[si])
            before = self._cache_seen.get(si, (0, 0))
            # tier-2 summary hits count as hits: they avoid the disk trip
            now = (cs.get("cache_hits", 0) + cs.get("tier2_hits", 0),
                   cs.get("cache_misses", 0))
            self._cache_seen[si] = now
            hits += now[0] - before[0]
            misses += now[1] - before[1]
        stats["cache_hits"] = hits
        stats["cache_misses"] = misses
        stats["cache_hit_rate"] = (hits / (hits + misses)
                                   if hits or misses else 0.0)
        if self.metrics is not None:
            self._publish_metrics(queries.shape[0], stats)
        # fold this batch's device columns into the scheduler's window
        # and let it evaluate on its own cadence
        if self.scheduler is not None:
            self.scheduler.note_batch([self.servers[si] for si in targets])
            decision = self.scheduler.maybe_repack()
            if decision is not None:
                stats["repack"] = {
                    "repacked": decision.repacked,
                    "changed_slots": decision.changed_slots,
                    "max_drift": decision.max_drift,
                    "tier0_hit_rate": decision.tier0_hit_rate,
                    "modeled_step_us": decision.modeled_step_us}
                if self.metrics is not None:
                    self.metrics.counter("sched.evals").inc()
                    self.metrics.counter("sched.repacks").inc(
                        decision.repacked)
        return gi, gd, stats

    def _publish_metrics(self, n_queries: int, stats: Dict) -> None:
        """Republish the batch stats through the metrics registry: the
        same numbers the stats dict returns, under ``serve.*`` names, so
        a dashboard scraping ``metrics.snapshot()`` and a caller reading
        the dict cannot disagree."""
        m = self.metrics
        m.counter("serve.batches").inc()
        m.counter("serve.queries").inc(n_queries)
        m.counter("serve.total_block_reads").inc(
            stats["total_block_reads"])
        m.counter("serve.total_tier0_hits").inc(
            stats["total_tier0_hits"])
        m.counter("serve.total_dedup_saved").inc(
            stats["total_dedup_saved"])
        m.counter("serve.total_dedup_cross").inc(
            stats["total_dedup_cross"])
        m.counter("serve.total_spec_hits").inc(
            stats["total_spec_hits"])
        m.counter("serve.total_spec_wasted").inc(
            stats["total_spec_wasted"])
        m.counter("serve.total_hot_tier_hits").inc(
            stats["total_hot_tier_hits"])
        m.counter("serve.cache_hits").inc(stats["cache_hits"])
        m.counter("serve.cache_misses").inc(stats["cache_misses"])
        m.gauge("serve.cache_hit_rate").set(stats["cache_hit_rate"])
        m.histogram("serve.batch_block_reads").observe(
            stats["total_block_reads"])
        m.histogram("serve.batch_mean_reads_per_query").observe(
            stats["mean_block_reads_per_query"])
