"""The port's host I/O subsystem (``repro_torch.io``: the block caches,
the async fetch queue, the cache-fronted store, prefetch) against the
JAX package's (``repro.io``).

Every unit case of ``tests/test_io_cache.py`` and ``tests/
test_io_async.py`` is replayed: one scenario function runs the case's
operation sequence on one package, checks the case's own invariants,
and returns what it observed — residency, evictions, tickets and their
completion order, per-query and lifetime ``IOStats``, fetch logs, search
results, prices. Each test runs the scenario on both packages and
requires the two records to be equal. Segment cases run on the shared
``small_segment`` built by the JAX package and carried across through
``save_segment`` -> ``repro_torch.core.segment.load_segment``; the
port's searches run on the CPU (``device="cpu"``, the plain ``pq_adc``).
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

import repro.core  # noqa: F401  (the JAX package's import order)
from repro.core import iostats as JI
from repro.core import params as JP
from repro.core import search as JS
from repro.core import segment as JSEG
from repro import io as JIO
from repro.io import async_fetch as JAF
from repro.serving import coordinator as JC
from tests.conftest import SMALL_SEGMENT

from repro_torch.core import iostats as TI
from repro_torch.core import params as TP
from repro_torch.core import search as TS
from repro_torch.core import segment as TSEG
from repro_torch.io import async_fetch as TAF
from repro_torch.io import cache as TCA
from repro_torch.io import cached_store as TCS
from repro_torch.io import hotset as THS
from repro_torch.io import prefetch as TPF
from repro_torch.serving import coordinator as TC

KB = 1024
CPU = "cpu"

JAX = SimpleNamespace(
    name="jax", BlockCache=JIO.BlockCache,
    TieredBlockCache=JIO.TieredBlockCache,
    AsyncFetchQueue=JIO.AsyncFetchQueue, SERVICE_TICKS=JAF.SERVICE_TICKS,
    default_jitter=JAF.default_jitter,
    IOStats=JI.IOStats, NVME_SEGMENT=JI.NVME_SEGMENT,
    CacheParams=JP.CacheParams, make_cached_store=JIO.make_cached_store,
    cached_view=JIO.cached_view, PrefetchEngine=JIO.PrefetchEngine,
    hot_block_pin_set=JIO.hot_block_pin_set,
    repack_from_frequencies=JIO.repack_from_frequencies,
    CachedBlockStore=JIO.CachedBlockStore,
    anns=lambda v, q, k, p: JS.anns(v, q, k, p),
    host_server=lambda **kw: JC.HostSegmentServer(**kw),
    QueryCoordinator=JC.QueryCoordinator,
    attach_shared_fetch_queue=JC.attach_shared_fetch_queue,
    save_segment=JSEG.save_segment, load_segment=JSEG.load_segment)

TORCH = SimpleNamespace(
    name="torch", BlockCache=TCA.BlockCache,
    TieredBlockCache=TCA.TieredBlockCache,
    AsyncFetchQueue=TAF.AsyncFetchQueue, SERVICE_TICKS=TAF.SERVICE_TICKS,
    default_jitter=TAF.default_jitter,
    IOStats=TI.IOStats, NVME_SEGMENT=TI.NVME_SEGMENT,
    CacheParams=TP.CacheParams, make_cached_store=TCS.make_cached_store,
    cached_view=TCS.cached_view, PrefetchEngine=TPF.PrefetchEngine,
    hot_block_pin_set=THS.hot_block_pin_set,
    repack_from_frequencies=THS.repack_from_frequencies,
    CachedBlockStore=TCS.CachedBlockStore,
    anns=lambda v, q, k, p: TS.anns(v, q, k, p, device=CPU),
    host_server=lambda **kw: TC.HostSegmentServer(device=CPU, **kw),
    QueryCoordinator=TC.QueryCoordinator,
    attach_shared_fetch_queue=TC.attach_shared_fetch_queue,
    save_segment=TSEG.save_segment, load_segment=TSEG.load_segment)


def tparams(p: JP.SegmentParams) -> TP.SegmentParams:
    """The port's SegmentParams with the same search and cache knobs."""
    return TP.SegmentParams(
        search=TP.SearchParams(**dataclasses.asdict(p.search)),
        cache=TP.CacheParams(**dataclasses.asdict(p.cache)),
        metric=p.metric)


def carry(jseg, tmp_path_factory, params=None):
    """The JAX segment through ``save_segment`` -> the port's
    ``load_segment`` (``params``: the port's; default its twin)."""
    path = tmp_path_factory.mktemp("seg") / "seg.npz"
    JSEG.save_segment(jseg, str(path))
    return TSEG.load_segment(str(path), params or tparams(jseg.params))


@pytest.fixture(scope="module")
def segs(small_segment, tmp_path_factory):
    return {"jax": small_segment,
            "torch": carry(small_segment, tmp_path_factory)}


@pytest.fixture(scope="module")
def queries(small_data):
    return small_data[1]


def both(fn, *args, segs=None):
    """Run a scenario on both packages; their records must be equal."""
    recs = []
    for m in (JAX, TORCH):
        extra = (segs[m.name],) if segs is not None else ()
        recs.append(fn(m, *extra, *args))
    assert recs[0] == recs[1]
    return recs[0]


def st(s) -> dict:
    return dataclasses.asdict(s)


def cache_state(c) -> dict:
    if hasattr(c, "tier1"):
        return {"t1": cache_state(c.tier1), "t2": cache_state(c.tier2),
                "admits": c.tier2_admits, "promos": c.tier2_promotions}
    return {"resident": sorted(c.resident), "pinned": sorted(c.pinned),
            "evictions": c.evictions, "cap": c.capacity_blocks}


def ticket(t) -> tuple:
    return (t.block, t.seq, t.submitted_at, t.complete_at, t.kind, t.done,
            t.reordered)


def wrap(m, seg, cp, **kw):
    return m.cached_view(seg.view, seg.graph, m.CacheParams(**cp), **kw)


def run(m, view, seg, q):
    ids, dd, stats = m.anns(view, q, 10, seg.params.search)
    return ids.tolist(), dd.tolist(), [st(s) for s in stats]


CACHED = dict(budget_frac=0.15, policy="lru", pin_fraction=0.25,
              prefetch_width=4)
ASYNC = dict(budget_frac=0.15, policy="lru", pin_fraction=0.25,
             prefetch_width=4, tier2_frac=0.25, queue_depth=8)


# ------------------------------------------------------------ BlockCache

def _lru(m):
    c = m.BlockCache(capacity_bytes=3 * KB, block_bytes=KB, policy="lru")
    out = []
    for b in (1, 2, 3):
        out.append(c.lookup(b))
        out.append(c.admit(b))
    out.append(c.lookup(1))
    out.append(c.admit(4))
    assert 2 not in c and 1 in c and 3 in c and 4 in c
    assert c.evictions == 1
    return out, cache_state(c)


def test_lru_eviction_order():
    both(_lru)


def _lfu(m):
    c = m.BlockCache(capacity_bytes=3 * KB, block_bytes=KB, policy="lfu")
    for b in (1, 2, 3):
        c.admit(b)
    hits = [c.lookup(1) for _ in range(3)] + [c.lookup(3)]
    ev = c.admit(4)
    assert 2 not in c and 1 in c and 3 in c and 4 in c
    return hits, ev, cache_state(c)


def test_lfu_eviction_prefers_cold_blocks():
    both(_lfu)


def _pinned(m):
    c = m.BlockCache(capacity_bytes=2 * KB, block_bytes=KB, policy="lru",
                     pinned=[7])
    assert 7 in c
    trace = []
    for b in range(20):
        trace.append((c.lookup(b), c.admit(b)))
    assert 7 in c and len(c) <= c.capacity_blocks
    return trace, cache_state(c)


def test_pinned_blocks_never_evicted():
    both(_pinned)


def _zero(m):
    c = m.BlockCache(capacity_bytes=0, block_bytes=KB)
    ev = c.admit(1)
    assert not c.lookup(1) and len(c) == 0
    return ev, cache_state(c)


def test_zero_budget_cache_never_hits():
    both(_zero)


def _pin_set(m, seg):
    lay, g = seg.view.layout, seg.graph
    seeds = seg.view.nav.sample_ids[:8]
    pins = m.hot_block_pin_set(lay.block_of, g.adj, g.deg, seeds,
                               max_blocks=1000)
    assert {int(lay.block_of[v]) for v in seeds} <= set(pins)
    return [int(b) for b in pins]


def test_hot_pin_set_covers_seed_blocks(segs):
    both(_pin_set, segs=segs)


# ------------------------------------------------- accounting invariants

def _repack(m):
    ranking = [7, 3, 9, 1, 4]
    assert m.repack_from_frequencies(ranking, {}) == ranking
    got = m.repack_from_frequencies(ranking, {1: 5, 9: 5, 4: 2, 12: 9,
                                              3: 0})
    assert got == [12, 9, 1, 4, 7, 3]
    return got


def test_repack_from_frequencies_orders_by_observed_traffic():
    both(_repack)


def _freqs(m, seg):
    store = m.make_cached_store(seg.view.store,
                                m.CacheParams(budget_frac=0.1))
    store.read_block(3)
    store.read_block(3)
    s = m.IOStats()
    store.read_demand(5, s)
    assert store.block_freq[3] == 2 and store.block_freq[5] == 1
    assert 4 not in store.block_freq
    return dict(store.block_freq), st(s), st(store.total)


def test_cached_store_tracks_block_frequencies(segs):
    both(_freqs, segs=segs)


def _hit_miss(m, seg, q):
    view = wrap(m, seg, CACHED)
    rec = run(m, view, seg, q)
    merged = m.IOStats()
    for s in rec[2]:
        assert s["block_reads"] == s["cache_hits"] + s["cache_misses"]
        assert 1 <= s["io_round_trips"] <= s["block_reads"]
        merged.merge(m.IOStats(**s))
    assert 0.0 < merged.cache_hit_rate < 1.0
    assert view.store.total.block_reads >= merged.block_reads
    return rec, st(view.store.total), cache_state(view.store.cache)


def test_hit_miss_accounting_invariant(segs, queries):
    both(_hit_miss, queries, segs=segs)


def _merge_rejects(m):
    a = m.IOStats(block_reads=2, io_round_trips=2)
    with pytest.raises(ValueError):
        a.merge(m.IOStats(block_reads=0, io_round_trips=1))
    return st(a)


def test_merge_rejects_excess_round_trips():
    both(_merge_rejects)


def _transparent(m, seg, q):
    u = run(m, seg.view, seg, q)
    c = run(m, wrap(m, seg, CACHED), seg, q)
    assert u[:2] == c[:2]
    return u, c


def test_cached_search_identical_to_uncached(segs, queries):
    both(_transparent, queries, segs=segs)


def _never_twice(m, seg, q):
    view = wrap(m, seg, dict(budget_frac=1.0, prefetch_width=4),
                record_fetches=True)
    rec = run(m, view, seg, q)
    log = view.store.fetch_log
    blocks = [b for _, b in log]
    assert len(blocks) == len(set(blocks))
    assert any(kind == "prefetch" for kind, _ in log)
    return rec, log


def test_prefetch_never_fetches_twice(segs, queries):
    both(_never_twice, queries, segs=segs)


def _engine(m, seg):
    store = m.make_cached_store(seg.view.store, m.CacheParams(
        budget_frac=0.5, prefetch_width=2))
    block_of = seg.view.layout.block_of
    eng = m.PrefetchEngine(store, block_of)

    class Cand:
        ids = [5, 9, 17, 23]
        visited = [True, False, False, False]
    t1 = eng.targets(Cand)
    assert len(t1) <= 2 and int(block_of[5]) not in t1
    t2 = eng.targets(Cand)
    assert not set(t1) & set(t2)
    fresh = m.PrefetchEngine(store, block_of)
    assert fresh.issued == set()
    t3 = fresh.targets(Cand)
    assert set(t3) == set(t1)
    return t1, t2, t3


def test_prefetch_engine_targets_top_unvisited(segs):
    both(_engine, segs=segs)


# ----------------------------------------------------------- cost model

def _prices_hits(m):
    cm = m.NVME_SEGMENT
    miss_only = m.IOStats(block_reads=10, cache_misses=10,
                          io_round_trips=10, hops=10)
    half_hits = m.IOStats(block_reads=10, cache_hits=5, cache_misses=5,
                          io_round_trips=5, hops=10)
    legacy = m.IOStats(block_reads=10, hops=10)
    out = [cm.latency_us(s) for s in (miss_only, half_hits, legacy)]
    assert out[1] < out[0] and out[2] == pytest.approx(out[0])
    return out


def test_cost_model_prices_hits_at_memory_latency():
    both(_prices_hits)


def _coalesced(m):
    cm = m.NVME_SEGMENT
    s = m.IOStats(block_reads=10, cache_hits=4, cache_misses=6,
                  io_round_trips=6, prefetched_blocks=8)
    batched = cm._io_time(s)
    assert batched < (s.cache_misses + s.prefetched_blocks) * cm.t_block_io
    return batched


def test_coalesced_prefetch_cheaper_than_extra_trips():
    both(_coalesced)


def _spec_trip(m):
    cm = m.NVME_SEGMENT
    s = m.IOStats(block_reads=1, cache_hits=1, io_round_trips=1,
                  prefetched_blocks=3)
    s2 = m.IOStats(block_reads=1, cache_misses=1, io_round_trips=1,
                   prefetched_blocks=3)
    a, b = cm._io_time(s), cm._io_time(s2)
    assert a == pytest.approx(cm.t_cache_hit + cm.t_block_io
                              + 2 * cm.t_batch_block)
    assert b == pytest.approx(cm.t_block_io + 3 * cm.t_batch_block)
    return a, b


def test_speculative_only_trip_pays_full_first_block():
    both(_spec_trip)


def _dedup_pricing(m):
    cm = m.NVME_SEGMENT
    s = m.IOStats.from_device(10, tier0_hits=2, hops=8, dedup_saved=4,
                              rounds=16)
    assert s.block_reads == 12 and s.io_round_trips == 6
    first = (st(s), cm._io_time(s))
    s.merge(m.IOStats.from_device(3, dedup_saved=1, hops=3, rounds=16))
    assert s.io_round_trips <= s.block_reads
    s3 = m.IOStats.from_device(2, dedup_saved=5)
    assert s3.dedup_saved_fetches == 2 and s3.io_round_trips == 0
    return first, st(s), st(s3)


def test_device_dedup_pricing():
    both(_dedup_pricing)


def _hit_plus_prefetch(m, seg):
    store = m.make_cached_store(seg.view.store, m.CacheParams(
        budget_frac=1.0, prefetch_width=4))
    s1 = m.IOStats()
    store.read_demand(3, s1)
    s = m.IOStats()
    store.read_demand(3, s, prefetch=[5, 7])
    assert s.cache_hits == 1 and s.io_round_trips == 1
    assert s.prefetched_blocks == 2
    t = m.NVME_SEGMENT._io_time(s)
    assert t >= m.NVME_SEGMENT.t_block_io
    return st(s1), st(s), t, cache_state(store.cache)


def test_hit_plus_prefetch_issues_priced_trip(segs):
    both(_hit_plus_prefetch, segs=segs)


# ----------------------------------------------- segment integration

TINY_CACHE = dict(budget_frac=0.2, policy="lfu", pin_fraction=0.5,
                  prefetch_width=2)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The LFU-cached tiny segment of ``test_io_cache``, in both
    packages (the port's loaded with the cache enabled)."""
    from repro.data.vectors import clustered_vectors
    x = clustered_vectors(600, 16, num_clusters=8, seed=2)
    p = dataclasses.replace(SMALL_SEGMENT,
                            cache=JP.CacheParams(**TINY_CACHE))
    jseg = JSEG.build_segment(x, p)
    return {"jax": jseg, "torch": carry(jseg, tmp_path_factory)}, x


def _eq10(m, seg):
    store = seg.view.store
    assert isinstance(store, m.CachedBlockStore)
    uncached = dataclasses.replace(seg, view=dataclasses.replace(
        seg.view, store=store.base))
    assert seg.memory_bytes() == (uncached.memory_bytes()
                                  + store.memory_bytes())
    assert store.memory_bytes() == store.cache.capacity_bytes
    assert seg.check_budget()["memory_ok"]
    return (seg.memory_bytes(), store.memory_bytes(),
            cache_state(store.cache), seg.check_budget())


def test_build_segment_charges_cache_against_eq10(tiny):
    both(_eq10, segs=tiny[0])


def _roundtrip(m, seg, x, path):
    m.save_segment(seg, str(path / f"{m.name}.npz"))
    params = seg.params
    seg2 = m.load_segment(str(path / f"{m.name}.npz"), params)
    assert isinstance(seg2.view.store, m.CachedBlockStore)
    q = (x[:4] + 0.01).astype(np.float32)
    ids1, _, _ = m.anns(seg.view, q, 5, params.search)
    ids2, _, _ = m.anns(seg2.view, q, 5, params.search)
    np.testing.assert_array_equal(ids1, ids2)
    return ids1.tolist(), cache_state(seg2.view.store.cache)


def test_cached_segment_save_load_roundtrip(tiny, tmp_path):
    both(_roundtrip, tiny[1], tmp_path, segs=tiny[0])


def _warms(m, seg, q):
    view = wrap(m, seg, dict(budget_frac=0.3, prefetch_width=4))
    server = m.host_server(view=view, params=seg.params.search, offset=0,
                           num_vectors=seg.num_vectors)
    coord = m.QueryCoordinator([server])
    g1, d1, s1 = coord.search(q[:12], k=10)
    g2, d2, s2 = coord.search(q[:12], k=10)
    assert s2["cache_hit_rate"] > s1["cache_hit_rate"]
    assert s2["cache_hits"] > s1["cache_hits"]
    return g1.tolist(), d1.tolist(), s1, g2.tolist(), s2, \
        server.cache_stats()


def test_shared_cache_warms_across_batches(segs, queries):
    both(_warms, queries, segs=segs)


# ------------------------------------------------------- AsyncFetchQueue

def _completion_order(m):
    jit = {1: 10.0, 2: 0.0, 3: 20.0}
    q = m.AsyncFetchQueue(depth=4, jitter_fn=lambda b: jit[b])
    t1, o1 = q.submit(1, "demand")
    t2, o2 = q.submit(2)
    t3, o3 = q.submit(3)
    assert (o1, o2, o3) == (1, 2, 3) and q.inflight_peak == 3
    done = q.wait(t3)
    assert [t.block for t in done] == [2, 1, 3]
    assert done[0].reordered and q.reorders >= 1
    assert len(q) == 0 and q.delivered == 3
    return [ticket(t) for t in done], q.clock, q.reorders


def test_queue_submit_wait_delivers_in_completion_order():
    both(_completion_order)


def _dedup_inflight(m):
    q = m.AsyncFetchQueue(depth=4, jitter_fn=lambda b: 0.0)
    t, _ = q.submit(7, "demand")
    assert q.in_flight(7) and q.get(7) is t
    with pytest.raises(ValueError):
        q.submit(7)
    r = t.residual(q.clock)
    assert 0.0 < r <= 1.0
    q.wait(t)
    assert t.residual(q.clock) == 0.0
    return r, ticket(t), q.clock


def test_queue_dedups_inflight_and_prices_residual():
    both(_dedup_inflight)


def _depth(m):
    q = m.AsyncFetchQueue(depth=2, jitter_fn=lambda b: 0.0)
    q.submit(1)
    q.submit(2)
    assert q.free_slots == 0
    with pytest.raises(ValueError):
        q.submit(3)
    out = [ticket(t) for t in q.wait_any()]
    assert q.free_slots >= 1
    out.append(ticket(q.submit(3)[0]))
    assert q.inflight_peak == 2
    return out


def test_queue_depth_bounds_inflight():
    both(_depth)


def _drain(m):
    q = m.AsyncFetchQueue(depth=8)
    for b in range(5):
        q.submit(b)
    out = q.drain()
    assert sorted(t.block for t in out) == list(range(5)) and len(q) == 0
    return [ticket(t) for t in out], q.reorders, \
        [m.default_jitter(b, s) for b in range(40) for s in (0, 3, 7)]


def test_queue_drain_empties():
    """Also the jitter hash itself: completion order depends on it."""
    both(_drain)


# ------------------------------------------------------ TieredBlockCache

def _t2_admit(m):
    c = m.TieredBlockCache(tier1_bytes=2 * KB, tier2_bytes=KB,
                           block_bytes=KB, compression=16)
    ev = [c.admit(b) for b in (1, 2, 3)]
    assert 1 in c.tier2 and 1 not in c.tier1
    tiers = [c.lookup_tier(2), c.lookup_tier(3)]
    assert tiers == [1, 1] and c.tier2_admits >= 1
    return ev, tiers, cache_state(c)


def test_tier2_admit_on_tier1_evict():
    both(_t2_admit)


def _t2_promote(m):
    c = m.TieredBlockCache(tier1_bytes=2 * KB, tier2_bytes=KB,
                           block_bytes=KB, compression=16)
    for b in (1, 2, 3):
        c.admit(b)
    assert c.lookup_tier(1) == 2
    assert 1 in c.tier1 and 1 not in c.tier2 and c.tier2_promotions == 1
    assert len(c.tier1) <= c.tier1.capacity_blocks
    return cache_state(c)


def test_tier2_hit_promotes_to_tier1():
    both(_t2_promote)


def _t2_capacity(m):
    c = m.TieredBlockCache(tier1_bytes=KB, tier2_bytes=KB, block_bytes=KB,
                           compression=16)
    assert c.tier2.capacity_blocks == 16 * c.tier1.capacity_blocks
    assert c.memory_bytes() == 2 * KB
    return cache_state(c), c.memory_bytes()


def test_tier2_capacity_is_compressed():
    both(_t2_capacity)


def _t_pinned(m):
    c = m.TieredBlockCache(tier1_bytes=2 * KB, tier2_bytes=KB,
                           block_bytes=KB, pinned=[42])
    trace = [(c.lookup_tier(b), c.admit(b)) for b in range(60)]
    assert 42 in c.tier1
    assert len(c.tier1) <= c.tier1.capacity_blocks
    assert len(c.tier2) <= c.tier2.capacity_blocks
    return trace, cache_state(c)


def test_tiered_pinned_never_evicted():
    both(_t_pinned)


def _never_both(m):
    c = m.TieredBlockCache(tier1_bytes=2 * KB, tier2_bytes=2 * KB,
                           block_bytes=KB, compression=2)
    trace = [(c.lookup_tier(b), c.admit(b))
             for b in (1, 2, 3, 4, 1, 2, 5)]
    assert not {b for b in range(8) if b in c.tier1 and b in c.tier2}
    return trace, cache_state(c)


def test_block_never_resident_in_both_tiers():
    both(_never_both)


# -------------------------------------------------- accounting + pricing

def _occupancy(m):
    cm = m.NVME_SEGMENT
    base = dict(block_reads=10, cache_misses=10, io_round_trips=10,
                queue_fetches=18)
    shallow = m.IOStats(**base, queue_occ_weight=8.0)
    deep = m.IOStats(**base, queue_occ_weight=1.5)
    flat = m.IOStats(block_reads=10, cache_misses=10, io_round_trips=10,
                     prefetched_blocks=8)
    out = [cm._io_time(s) for s in (shallow, deep, flat)]
    assert out[1] < out[0] and out[0] == pytest.approx(out[2])
    return out


def test_occupancy_pricing_amortizes_with_depth():
    both(_occupancy)


def _t2_price(m):
    cm = m.NVME_SEGMENT
    out = [cm._io_time(m.IOStats(block_reads=1, cache_hits=1)),
           cm._io_time(m.IOStats(block_reads=1, tier2_hits=1)),
           cm._io_time(m.IOStats(block_reads=1, cache_misses=1,
                                 io_round_trips=1))]
    assert out[0] < out[1] < out[2]
    return out


def test_tier2_hit_cheaper_than_miss_dearer_than_tier1():
    both(_t2_price)


def _join_price(m):
    cm = m.NVME_SEGMENT
    join = m.IOStats(block_reads=1, cache_misses=1, inflight_joins=1,
                     join_residual=0.5)
    cold = m.IOStats(block_reads=1, cache_misses=1, io_round_trips=1)
    a, b = cm._io_time(join), cm._io_time(cold)
    assert a == pytest.approx(0.5 * cm.t_block_io) and a < b
    return a, b


def test_join_prices_residual_not_full_trip():
    both(_join_price)


def _merge_peak(m):
    a = m.IOStats(block_reads=2, cache_misses=2, io_round_trips=2,
                  inflight_peak=3, completion_reorders=1, tier2_hits=0,
                  queue_occ_weight=0.5)
    b = m.IOStats(block_reads=1, tier2_hits=1, inflight_peak=5,
                  completion_reorders=2, queue_occ_weight=0.25)
    a.merge(b)
    assert a.inflight_peak == 5 and a.completion_reorders == 3
    assert a.cache_hit_rate == pytest.approx(1 / 3)
    return st(a), a.cache_hit_rate


def test_merge_maxes_inflight_peak_and_adds_async_counters():
    both(_merge_peak)


# --------------------------------------------- async search integration

def _async_identical(m, seg, q):
    u = run(m, seg.view, seg, q)
    view = wrap(m, seg, ASYNC)
    a = run(m, view, seg, q)
    assert u[:2] == a[:2]
    return u, a, st(view.store.total), cache_state(view.store.cache), \
        view.store.queue.clock, view.store.queue.reorders


def test_async_tiered_search_identical_to_uncached(segs, queries):
    both(_async_identical, queries, segs=segs)


def _async_invariants(m, seg, q):
    view = wrap(m, seg, ASYNC)
    rec = run(m, view, seg, q)
    merged = m.IOStats()
    for s in rec[2]:
        assert s["block_reads"] == (s["cache_hits"] + s["tier2_hits"]
                                    + s["cache_misses"])
        assert s["io_round_trips"] <= s["block_reads"]
        assert s["inflight_joins"] <= s["cache_misses"]
        assert s["inflight_peak"] <= view.store.queue.depth
        merged.merge(m.IOStats(**s))
    assert merged.tier2_hits > 0 and merged.queue_fetches > 0
    assert 0.0 < merged.cache_hit_rate < 1.0
    return rec, st(merged)


def test_async_accounting_invariants(segs, queries):
    both(_async_invariants, queries, segs=segs)


def _async_never_twice(m, seg, q):
    view = wrap(m, seg, dict(budget_frac=1.0, prefetch_width=4,
                             queue_depth=8), record_fetches=True)
    rec = run(m, view, seg, q)
    drained = [ticket(t) for t in view.store.queue.drain()]
    blocks = [b for _, b in view.store.fetch_log]
    assert len(blocks) == len(set(blocks))
    assert any(k == "prefetch" for k, _ in view.store.fetch_log)
    return rec, view.store.fetch_log, drained


def test_async_never_fetches_twice(segs, queries):
    both(_async_never_twice, queries, segs=segs)


def _join(m, seg):
    store = m.make_cached_store(seg.view.store, m.CacheParams(
        budget_frac=0.5, prefetch_width=0, queue_depth=8))
    store.queue.submit(11, kind="speculative", key=store._key(11),
                       owner=store)
    s = m.IOStats()
    store.read_demand(11, s)
    assert s.inflight_joins == 1 and s.io_round_trips == 0
    assert s.cache_misses == 1 and 0.0 < s.join_residual <= 1.0
    s2 = m.IOStats()
    store.read_demand(11, s2)
    assert s2.cache_hits == 1
    return st(s), st(s2), st(store.total)


def test_cross_query_join_of_inflight_fetch(segs):
    both(_join, segs=segs)


def _namespaces(m, seg):
    base1 = seg.view.store
    base2 = dataclasses.replace(base1)
    cp = m.CacheParams(budget_frac=0.5, prefetch_width=0, queue_depth=8)
    s1 = m.make_cached_store(base1, cp, record_fetches=True)
    s2 = m.make_cached_store(base2, cp, record_fetches=True)
    s2.attach_queue(s1.queue)
    s1.queue.submit(7, kind="speculative", key=s1._key(7), owner=s1)
    a = m.IOStats()
    s2.read_demand(7, a)
    assert a.inflight_joins == 0 and a.io_round_trips == 1
    assert 7 in s1.cache and 7 in s2.cache
    b = m.IOStats()
    s1.read_demand(7, b)
    assert b.cache_hits == 1 and b.io_round_trips == 0
    assert s2.fetch_log == [("miss", 7)]
    return st(a), st(b), s1.fetch_log, s2.fetch_log


def test_shared_queue_keeps_store_namespaces_apart(segs):
    both(_namespaces, segs=segs)


def _joined_admits(m, seg):
    base = seg.view.store
    cp = m.CacheParams(budget_frac=0.5, prefetch_width=0, queue_depth=8)
    s1 = m.make_cached_store(base, cp)
    s2 = m.make_cached_store(base, cp)
    s2.attach_queue(s1.queue)
    s1.queue.submit(5, kind="speculative", key=s1._key(5), owner=s1)
    a = m.IOStats()
    s2.read_demand(5, a)
    assert a.inflight_joins == 1 and a.io_round_trips == 0
    assert 5 in s1.cache and 5 in s2.cache
    b = m.IOStats()
    s2.read_demand(5, b)
    assert b.cache_hits == 1
    return st(a), st(b)


def test_joined_ticket_admits_into_both_caches(segs):
    both(_joined_admits, segs=segs)


def _attach_drains(m, seg):
    cp = m.CacheParams(budget_frac=0.5, prefetch_width=0, queue_depth=8)
    s = m.make_cached_store(seg.view.store, cp, record_fetches=True)
    old = s.queue
    old.submit(3, kind="speculative", key=s._key(3), owner=s)
    assert 3 not in s.cache
    s.attach_queue(m.AsyncFetchQueue(depth=8))
    assert len(old) == 0 and 3 in s.cache
    a = m.IOStats()
    s.read_demand(3, a)
    assert a.cache_hits == 1 and a.io_round_trips == 0
    return st(a), s.fetch_log


def test_attach_queue_drains_private_inflight(segs):
    both(_attach_drains, segs=segs)


def _fully_pinned(m):
    c = m.TieredBlockCache(tier1_bytes=2 * KB, tier2_bytes=4 * KB,
                           block_bytes=KB, compression=4,
                           pinned=[100, 101])
    assert not c.tier1.can_admit(5)
    c.admit(5)
    assert 5 in c.tier2 and c.lookup_tier(5) == 2
    assert 5 in c.tier2 and 5 not in c.tier1
    return cache_state(c)


def test_fully_pinned_tier1_falls_back_to_tier2():
    both(_fully_pinned)


def _shared_servers(m, seg, q):
    views = [wrap(m, seg, dict(budget_frac=0.2, prefetch_width=4,
                               tier2_frac=0.25, queue_depth=8))
             for _ in range(2)]
    servers = [m.host_server(view=v, params=seg.params.search, offset=off,
                             num_vectors=seg.num_vectors)
               for v, off in zip(views, (0, seg.num_vectors))]
    shared = m.attach_shared_fetch_queue(servers, depth=8)
    assert all(s.view.store.queue is shared for s in servers)
    gi, gd, stats = m.QueryCoordinator(servers).search(q[:8], k=10)
    assert shared.submitted > 0
    assert stats["cache_hits"] + stats["cache_misses"] > 0
    tot = m.IOStats()
    for s in servers:
        tot.merge(s.view.store.total)
    assert tot.io_round_trips <= tot.block_reads
    return (gi.tolist(), gd.tolist(), stats, st(tot), shared.submitted,
            shared.delivered, shared.reorders, shared.inflight_peak,
            [s.cache_stats() for s in servers])


def test_shared_queue_across_servers(segs, queries):
    both(_shared_servers, queries, segs=segs)


@pytest.mark.parametrize("salt", [0, 3, 7])
def test_completion_permutations_leave_results_identical(salt, segs,
                                                         queries):
    def scenario(m, seg, q):
        u = run(m, seg.view, seg, q[:6])
        view = wrap(m, seg, dict(budget_frac=0.15, prefetch_width=4,
                                 tier2_frac=0.25, queue_depth=8),
                    queue=m.AsyncFetchQueue(depth=8, jitter_salt=salt))
        a = run(m, view, seg, q[:6])
        assert u[:2] == a[:2]
        return a, view.store.queue.reorders, st(view.store.total)
    both(scenario, queries, segs=segs)
