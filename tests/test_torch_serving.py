"""The port's serving plane (``repro_torch.serving``: ``RequestBatcher``,
the ``SegmentTarget`` adapters, ``HostSegmentServer``,
``attach_shared_fetch_queue``, ``QueryCoordinator``, ``RepackScheduler``;
``io.hotset``'s planning; ``obs.calibrate``) against the JAX package's.

Every scenario runs on both packages on the same numpy inputs, and the
records must be equal: batches, stats dicts, cache counters, packs,
decisions. The device servers run the JAX search in interpret mode and
the port's on the CPU (the plain round stage), with short streams (16
queries, at most 3 batches) to keep the run small.
"""
import dataclasses
import importlib
import json
from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest

import repro.core  # noqa: F401  (the JAX package's import order)
from repro.core import device_search as JDS
from repro.core import iostats as JI
from repro.core import params as JP
from repro.core.blockstore import BlockStore as JBlockStore
from repro.core.segment import build_segment
from repro.data.vectors import clustered_vectors, query_set
from repro.io import hotset as JH
from repro.io.cache import BlockCache as JBlockCache
from repro.io.cached_store import CachedBlockStore as JCachedStore
from repro.io.cached_store import cached_view as j_cached_view
from repro.obs.calibrate import CalibrationPreset as JPreset
from repro.obs.calibrate import load_calibrated as j_load_calibrated
from repro.serving import batcher as JB
from repro.serving import coordinator as JC
from repro.serving import scheduler as JSCH
from repro.serving import target as JT
from tests.conftest import SMALL_SEGMENT
from tests.test_torch_io import carry
from test_torch_device_search import _tparams

from repro_torch.core import device_search as TDS
from repro_torch.core import iostats as TI
from repro_torch.core import params as TP
from repro_torch.configs import starling_segment as TSS
from repro_torch.core.blockstore import BlockStore as TBlockStore
from repro_torch.io import hotset as TH
from repro_torch.io.cache import BlockCache as TBlockCache
from repro_torch.io.cached_store import CachedBlockStore as TCachedStore
from repro_torch.io.cached_store import cached_view as t_cached_view
from repro_torch.serving import batcher as TB
from repro_torch.serving import coordinator as TC
from repro_torch.serving import scheduler as TSCH
from repro_torch.serving import target as TT

# the module: the package's ``calibrate`` is the function, as in JAX's
TCAL = importlib.import_module("repro_torch.obs.calibrate")

CPU = "cpu"
P_SRV = JP.DeviceSearchParams(k=10, candidates=48, max_hops=64,
                              fetch_width=2, compact_frac=0.25)

JAX = SimpleNamespace(
    name="jax", RequestBatcher=JB.RequestBatcher, T=JT, H=JH,
    RepackParams=JP.RepackParams, CacheParams=JP.CacheParams,
    RepackScheduler=JSCH.RepackScheduler, IOStats=JI.IOStats,
    BlockStore=JBlockStore, BlockCache=JBlockCache,
    CachedBlockStore=JCachedStore, cached_view=j_cached_view,
    QueryCoordinator=JC.QueryCoordinator,
    attach_shared_fetch_queue=JC.attach_shared_fetch_queue,
    host_server=lambda **kw: JC.HostSegmentServer(**kw),
    from_segment=lambda seg, **kw: JDS.from_segment(seg, **kw),
    server=lambda **kw: JC.SegmentServer(**kw),
    params=lambda p: p, hot=JDS.hot_pack_blocks,
    slot_of=lambda ds: np.asarray(ds.hot_slot_of))

TORCH = SimpleNamespace(
    name="torch", RequestBatcher=TB.RequestBatcher, T=TT, H=TH,
    RepackParams=TP.RepackParams, CacheParams=TP.CacheParams,
    RepackScheduler=TSCH.RepackScheduler, IOStats=TI.IOStats,
    BlockStore=TBlockStore, BlockCache=TBlockCache,
    CachedBlockStore=TCachedStore, cached_view=t_cached_view,
    QueryCoordinator=TC.QueryCoordinator,
    attach_shared_fetch_queue=TC.attach_shared_fetch_queue,
    host_server=lambda **kw: TC.HostSegmentServer(device=CPU, **kw),
    from_segment=lambda seg, **kw: TDS.from_segment(seg, device=CPU, **kw),
    server=lambda **kw: TC.SegmentServer(device=CPU, **kw),
    params=_tparams, hot=TDS.hot_pack_blocks,
    slot_of=lambda ds: ds.hot_slot_of.numpy())


def both(fn, *args, segs=None, dists=False):
    """Run a scenario on both packages; their records must be equal.
    With ``dists`` the scenario returns ``(record, dists)``: the device
    search's distances agree to float tolerance (its f32 sums are not
    numpy's, ``tests/test_torch_device_search.py``), the rest exactly."""
    recs = []
    for m in (JAX, TORCH):
        extra = (segs[m.name],) if segs is not None else ()
        recs.append(fn(m, *extra, *args))
    if dists:
        np.testing.assert_allclose(recs[1][1], recs[0][1], rtol=1e-6,
                                   atol=2.5e-4)
        recs = [r[0] for r in recs]
    assert recs[0] == recs[1]
    return recs[0]


@pytest.fixture(scope="module")
def segs(small_segment, tmp_path_factory):
    return {"jax": small_segment,
            "torch": carry(small_segment, tmp_path_factory)}


def _device_server(m, seg, tier0_blocks=8):
    return m.server(segment=m.from_segment(seg, tier0_blocks=tier0_blocks),
                    offset=0, num_vectors=seg.num_vectors, host=seg,
                    params=m.params(P_SRV))


def _tiny_store(m):
    base = m.BlockStore(vid=np.arange(8, dtype=np.int32).reshape(4, 2),
                        vecs=np.zeros((4, 2, 8), np.float32),
                        meta=np.full((4, 2, 5), -1, np.int32),
                        block_kb=1.0)
    return m.CachedBlockStore(base, m.BlockCache(4096, 1024))


def _batch(q, ids, n):
    return q.tolist(), ids, n


# ------------------------------------------------------------- batcher

def _batcher_cases(m):
    out = []
    b = m.RequestBatcher(dim=8, buckets=(4, 16), tile=1)
    for i in range(6):
        b.submit(np.full(8, i))
    out.append(_batch(*b.next_batch()))
    out.append(bool(b.queue))
    b = m.RequestBatcher(dim=4, buckets=(3, 5, 8, 30), tile=8)
    out.append(b.buckets)
    with pytest.raises(ValueError):
        m.RequestBatcher(dim=4, buckets=(4,), tile=0)
    b = m.RequestBatcher(dim=4, buckets=(8, 32))
    b.submit(np.ones(4))
    out.append(_batch(*b.next_batch()))
    b = m.RequestBatcher(dim=4, buckets=(4, 8), max_wait=3)
    polls = [b.ready()]
    b.submit(np.zeros(4))
    polls += [b.ready(), b.ready(), b.ready()]
    out.append((polls, _batch(*b.next_batch()), b.ready()))
    b = m.RequestBatcher(dim=4, buckets=(4, 8), max_wait=1000)
    for i in range(19):
        b.submit(np.full(4, i))
    out.append(b.ready())
    while b.queue:
        out.append(_batch(*b.next_batch()))
    out.append(b.batches_emitted)
    return out


def test_batcher_batches_equal_jax():
    """Buckets (rounded to the 8-row tile), padding, request ids, the
    deadline flush and the full-bucket flush."""
    rec = both(_batcher_cases)
    assert rec[2] == (8, 32)
    assert TB.RequestBatcher(dim=4).tile == 8


# -------------------------------------------------------- target adapters

class _Legacy:
    """A 6-key telemetry emitter (no speculation or hot-tier columns)."""
    offset, num_vectors = 0, 4

    def search(self, q, k=None):
        return None

    def batch_stats(self):
        return {"io": np.array([3, 1]), "tier0_hits": np.array([0, 2]),
                "hops": np.array([2, 2]), "dedup_saved": np.array([0, 1]),
                "dedup_cross": np.array([0, 0]), "rounds": 3}


class _Broken(_Legacy):
    def batch_stats(self):
        return {"io": np.array([1]), "tier0_hits": np.array([0])}


class _Bare:
    offset, num_vectors = 0, 1

    def search(self, q, k=None):
        return None


def _adapters(m):
    t = m.T
    filled = t.batch_stats(_Legacy())
    rec = {k: np.asarray(v).tolist() for k, v in filled.items()}
    with pytest.raises(ValueError, match="missing"):
        t.batch_stats(_Broken())
    bare = _Bare()
    assert t.batch_stats(bare) == {} and t.lifetime_stats(bare) == {}
    assert t.repack_source(bare) is None and t.demand_feed(bare) is None
    t.attach_obs(bare, None, None)
    return (rec, t.BATCH_STAT_KEYS, t.is_target(bare),
            t.is_target(object()), isinstance(bare, t.SegmentTarget))


def test_target_adapters_equal_jax():
    """The zero-fill of a legacy emitter's speculation and hot-tier
    columns, the missing-key error, and the defaults of a target that
    has only the required core."""
    rec = both(_adapters)
    assert rec[0]["spec_hits"] == [0, 0] and rec[0]["hot_tier_hits"] == [0, 0]


# ------------------------------------------ coordinator over two segments

@pytest.fixture(scope="module")
def two_segments(tmp_path_factory):
    xs = [clustered_vectors(1200, 32, num_clusters=12, seed=s)
          for s in (0, 1)]
    jsegs = [build_segment(x, SMALL_SEGMENT) for x in xs]
    return xs, {"jax": jsegs,
                "torch": [carry(s, tmp_path_factory) for s in jsegs]}


def _two_servers(m, segs, xs):
    servers, off = [], 0
    for si, seg in enumerate(segs):
        servers.append(m.server(
            segment=m.from_segment(seg, tier0_frac=0.1 * si), offset=off,
            num_vectors=seg.num_vectors,
            params=m.params(dataclasses.replace(
                JC.SERVE_DEVICE_SEARCH, candidates=48))))
        off += xs[si].shape[0]
    return servers


@pytest.mark.parametrize("prune", [False, True], ids=["all", "pruned"])
def test_coordinator_over_two_device_segments(two_segments, prune):
    xs, segs = two_segments
    q = query_set(np.concatenate(xs), 16, seed=3)

    def scenario(m, segs_m):
        coord = m.QueryCoordinator(
            _two_servers(m, segs_m, xs),
            prune_fn=(lambda queries: [1]) if prune else None)
        gi, gd, stats = coord.search(q, k=10)
        assert set(stats) == set(m.QueryCoordinator.STATS_SCHEMA)
        return (gi.tolist(), stats), np.asarray(gd)
    gi, stats = both(scenario, segs=segs, dists=True)
    assert stats["segments_searched"] == (1 if prune else 2)
    assert stats["total_block_reads"] > 0
    assert stats["total_tier0_hits"] > 0      # the second segment's pack
    if prune:
        assert all(i >= xs[0].shape[0] for row in gi for i in row)


# ------------------------------------------ host servers, shared queue

def _shared_host(m, seg, q):
    views = [m.cached_view(seg.view, seg.graph, m.CacheParams(
        budget_frac=0.2, prefetch_width=4, tier2_frac=0.25,
        queue_depth=8)) for _ in range(2)]
    servers = [m.host_server(view=v, params=seg.params.search, offset=off,
                             num_vectors=seg.num_vectors)
               for v, off in zip(views, (0, seg.num_vectors))]
    sched = m.RepackScheduler(m.RepackParams())
    shared = m.attach_shared_fetch_queue(servers, depth=8, scheduler=sched)
    assert len(sched._feeds) == 2
    coord = m.QueryCoordinator(servers)
    out = []
    for b in range(2):
        gi, gd, st = coord.search(q[8 * b:8 * b + 8], k=10)
        out.append((gi.tolist(), gd.tolist(), st,
                    [s.cache_stats() for s in servers],
                    [[dataclasses.asdict(x) for x in s.last_stats]
                     for s in servers]))
    with pytest.raises(ValueError):
        m.attach_shared_fetch_queue([m.host_server(
            view=seg.view, params=seg.params.search, offset=0,
            num_vectors=seg.num_vectors)])
    return out, shared.submitted, shared.delivered, shared.reorders, \
        dict(sched.demand_union())


def test_host_servers_with_shared_queue(segs, small_data):
    """Two cache-fronted host servers on one shared fetch queue: the
    coordinator's stats dicts, each server's ``cache_stats`` and
    per-query ``IOStats``, the queue's counters and the scheduler's
    demand union are JAX's."""
    rec = both(_shared_host, small_data[1], segs=segs)
    assert rec[1] > 0


# -------------------------------------------------- planning (hotset)

def _planning(m, seg):
    h = m.H
    edges = [h.pack_drift(set(), []), h.pack_drift({1, 2}, [1, 2]),
             h.pack_drift({1, 2}, [3, 4]),
             h.pack_drift({1, 2, 3, 4}, [1, 2, 3, 9]),
             h.pack_drift({1, 2}, [1, 2, 3])]
    v = seg.view
    rho = v.store.num_blocks
    ranking = h.hot_block_ranking(v.layout.block_of, seg.graph.adj,
                                  seg.graph.deg, h.view_seed_ids(v))
    rng = np.random.default_rng(5)
    plans = []
    for trial in range(4):
        obs = {int(b): int(c) for b, c in zip(
            rng.integers(-3, rho + 5, 30), rng.integers(0, 4, 30))}
        plans.append(h.plan_tier0(ranking, obs, 8 + trial, rho,
                                  min_observed=1 + trial % 2))
    obs = {b: rho - b for b in range(0, rho, 3)}
    plan = h.plan_tier0(ranking, obs, 8, rho)
    assert set(plan) == m.hot(m.from_segment(seg, tier0_blocks=8,
                                             observed=obs))
    p1 = h.plan_tier0([5, 3, 8, 1, 9, 0], {8: 7, 0: 7, 4: 2}, 4, 12)
    assert h.pack_drift(set(p1), p1) == 0.0
    pins = h.hot_block_pin_set(v.layout.block_of, seg.graph.adj,
                               seg.graph.deg, h.view_seed_ids(v), 12)
    return edges, ranking, plans, plan, p1, pins


def test_pack_drift_and_plan_tier0_equal_jax(segs):
    rec = both(_planning, segs=segs)
    assert rec[0] == [0.0, 0.0, 1.0, 0.25, pytest.approx(1 / 3)]


# ------------------------------------------------------- calibration

def test_load_calibrated_equals_jax(tmp_path):
    """No file: the base model. A stored preset: its constants on top,
    the same model as JAX's. A preset of another backend, or a broken
    file: the base model."""
    for load, base in ((j_load_calibrated, JI.TPU_HBM_SEGMENT),
                       (TCAL.load_calibrated, TI.TPU_HBM_SEGMENT)):
        assert load(base, results_dir=str(tmp_path)) == base
    assert TCAL.load_calibrated(TI.TPU_HBM_SEGMENT) == TI.TPU_HBM_SEGMENT
    report = {"backend": "tpu-hbm", "fitted": {"t_block_io": 2.5,
                                               "t_round": 0.75},
              "unfit": ["t_round_comp"], "n_samples": 12,
              "error_after": {"mean_abs_rel_err": 0.1}}
    JPreset.from_report(report, source="replay").save(
        str(tmp_path / "CALIB_tpu-hbm.json"))
    jm = j_load_calibrated(JI.TPU_HBM_SEGMENT, str(tmp_path))
    tm = TCAL.load_calibrated(TI.TPU_HBM_SEGMENT, str(tmp_path))
    assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
    assert tm.t_block_io == 2.5 and tm.t_round == 0.75
    tp = TCAL.CalibrationPreset.load(str(tmp_path / "CALIB_tpu-hbm.json"))
    tp.save(str(tmp_path / "again.json"))
    assert json.loads((tmp_path / "again.json").read_text()) == json.loads(
        (tmp_path / "CALIB_tpu-hbm.json").read_text())
    with pytest.raises(ValueError):
        tp.apply(TI.NVME_SEGMENT)
    (tmp_path / "CALIB_nvme.json").write_text(
        (tmp_path / "CALIB_tpu-hbm.json").read_text())
    assert TCAL.load_calibrated(TI.NVME_SEGMENT, str(tmp_path)) == \
        TI.NVME_SEGMENT
    (tmp_path / "CALIB_tpu-hbm.json").write_text("{not json")
    assert TCAL.load_calibrated(TI.TPU_HBM_SEGMENT, str(tmp_path)) == \
        TI.TPU_HBM_SEGMENT


# -------------------------------------------------------- the scheduler

def _scheduled_repack(m, seg, x):
    cview = m.cached_view(seg.view, seg.graph,
                          m.CacheParams(budget_frac=0.10))
    hserver = m.host_server(view=cview, params=seg.params.search,
                            offset=0, num_vectors=seg.num_vectors)
    server = _device_server(m, seg)
    sched = m.RepackScheduler(m.RepackParams(interval_batches=2,
                                             hysteresis=0.2))
    sched.attach_feed(cview.store)
    coord = m.QueryCoordinator([server], scheduler=sched)
    cold_vid = np.flatnonzero(~np.isin(
        seg.view.layout.block_of, sorted(m.hot(server.segment))))
    rng = np.random.default_rng(3)
    qs = (x[rng.choice(cold_vid, 16)]
          + rng.normal(0, 0.01, (16, x.shape[1]))).astype(np.float32)
    hserver.search(qs)
    packs, out, dists = [sorted(m.hot(server.segment))], [], []
    for _ in range(3):
        gi, gd, st = coord.search(qs, k=10)
        out.append((gi.tolist(), st))
        dists.append(np.asarray(gd))
        packs.append(sorted(m.hot(server.segment)))
    # bit-identical across the repack, within each package
    assert all(np.array_equal(d.view(np.int32), dists[0].view(np.int32))
               for d in dists)
    d = sched.last_decision
    return (out, packs, dataclasses.asdict(d), sched.stats(),
            dict(cview.store.block_freq), hserver.cache_stats()), \
        np.stack(dists)


def test_scheduled_repack_equals_jax(segs, small_data):
    """``tests/test_scheduler.py``'s drifted stream in both packages:
    the same stats dict per batch (the repack decision included), the
    same packs, the same decision, and ids and distances bit-identical
    across the repack."""
    out, packs, d, stats, _, _ = both(_scheduled_repack, small_data[0],
                                      segs=segs, dists=True)
    (gi0, st0), (gi1, st1), (gi2, st2) = out
    assert "repack" not in st0 and st1["repack"]["repacked"] == 1
    assert packs[1] != packs[2] and packs[2] == packs[3]
    assert gi0 == gi2 and gi0 == gi1
    assert st2["total_tier0_hits"] > st0["total_tier0_hits"]
    assert st2["total_block_reads"] < st0["total_block_reads"]
    assert stats["repacks"] == 1 and d["repacked"] == 1


def _hysteresis(m, seg):
    server = _device_server(m, seg)
    pack = sorted(m.hot(server.segment))
    store = _tiny_store(m)
    sched = m.RepackScheduler(m.RepackParams(interval_batches=1,
                                             hysteresis=0.5))
    sched.attach_feed(store)
    sched.attach_target(server)
    rho = seg.view.store.num_blocks
    outside = next(b for b in range(rho) if b not in pack)
    store.block_freq.update({b: 10 for b in pack})
    store.block_freq[outside] = 100
    before = m.slot_of(server.segment).copy()
    sched.note_batch([server])
    d = sched.maybe_repack()
    assert d is not None and d.repacked == 0 and d.evaluated == 1
    assert 0.0 < d.max_drift < 0.5
    assert sched.repacks == 0 and sched.skipped == 1
    np.testing.assert_array_equal(before, m.slot_of(server.segment))
    assert len(sched._window) > 0
    return dataclasses.asdict(d), dict(sched._window), sched.stats()


def test_hysteresis_below_threshold_is_a_noop(segs):
    """A drift below the hysteresis changes no slot in either package."""
    both(_hysteresis, segs=segs)


def _window_cases(m, seg):
    store = _tiny_store(m)
    store.block_freq.update({0: 3, 2: 1})
    mark = Counter(store.block_freq)
    out = [dict(store.freq_delta(mark))]
    store.block_freq.update({0: 2, 1: 5})
    out += [dict(store.freq_delta(mark)), dict(store.freq_delta())]
    sched = m.RepackScheduler()
    with pytest.raises(TypeError):
        sched.attach_feed(object())
    s1, s2 = _tiny_store(m), _tiny_store(m)
    sched.attach_feed(s1)
    sched.attach_feed(s1)
    sched.attach_feed(s2)
    s1.block_freq.update({0: 2, 1: 1})
    s2.block_freq.update({1: 4, 3: 2})
    out.append(dict(sched.demand_union()))
    orphan = m.server(segment=m.from_segment(seg, tier0_blocks=4),
                      offset=0, num_vectors=seg.num_vectors)
    with pytest.raises(ValueError):
        sched.attach_target(orphan)
    with pytest.raises(ValueError):
        orphan.repack({0: 1})
    for bad in (dict(interval_batches=0), dict(hysteresis=1.5),
                dict(min_observed=0), dict(hit_rate_ceiling=-0.1)):
        with pytest.raises(ValueError):
            m.RepackParams(**bad)
    return out, len(sched._feeds)


def test_scheduler_windows_and_validation_equal_jax(segs):
    """``freq_delta`` windows, the feed type check and union, a target
    without a host, and ``RepackParams``' validation."""
    both(_window_cases, segs=segs)


def _partial(m, seg):
    rho = seg.view.store.num_blocks
    srv_a = _device_server(m, seg)
    drifted = [b for b in range(rho) if b not in m.hot(srv_a.segment)][:8]
    window = Counter({b: 50 for b in drifted})
    srv_b = m.server(segment=m.from_segment(seg, tier0_blocks=8,
                                            observed=window),
                     offset=0, num_vectors=seg.num_vectors, host=seg,
                     params=m.params(P_SRV))
    sched = m.RepackScheduler(m.RepackParams(interval_batches=1,
                                             hysteresis=0.25))
    sched.attach_target(srv_a)
    sched.attach_target(srv_b)
    sched._window.update(window)
    sched.batches = 1
    d = sched.maybe_repack()
    assert d.evaluated == 2 and d.repacked == 1
    assert m.hot(srv_a.segment) == set(drifted)
    assert sched.demand_union() == window
    sched.note_layout_swap(srv_a)
    return dataclasses.asdict(d), sorted(m.hot(srv_a.segment)), \
        dict(sched.demand_union()), sched.stats()


def test_partial_repack_and_layout_swap_equal_jax(segs):
    """One target repacks, its sibling already on the observed pack
    holds, the window survives; ``note_layout_swap`` keeps the window's
    in-range demand."""
    both(_partial, segs=segs)


def _ceiling(m, seg, q):
    server = _device_server(m, seg)
    store = _tiny_store(m)
    sched = m.RepackScheduler(m.RepackParams(
        interval_batches=1, hysteresis=0.1, hit_rate_ceiling=0.0))
    sched.attach_feed(store)
    sched.attach_target(server)
    rho = seg.view.store.num_blocks
    drifted = [b for b in range(rho)
               if b not in m.hot(server.segment)][:8]
    store.block_freq.update({b: 50 for b in drifted})
    server.search(q[:8], 10)
    sched.note_batch([server])
    d = sched.maybe_repack()
    assert d.repacked == 0 and d.max_drift >= 0.1
    return dataclasses.asdict(d), sched.stats()


def test_hit_rate_ceiling_equal_jax(segs, small_data):
    """A pack at the hit-rate ceiling is left alone at full drift; the
    decision's modeled step (TPU constants: a model, not a time) and
    hit rate are JAX's."""
    both(_ceiling, small_data[1], segs=segs)


def test_params_defaults_and_validation_equal_jax():
    """``SearchParams`` / ``CacheParams`` defaults, and the cache knobs
    JAX rejects are rejected (the presets: ``test_torch_device_search.
    test_presets_match_jax``)."""
    assert dataclasses.asdict(TP.SearchParams()) == dataclasses.asdict(
        JP.SearchParams())
    assert dataclasses.asdict(TP.CacheParams()) == dataclasses.asdict(
        JP.CacheParams())
    assert dataclasses.asdict(TP.RepackParams()) == dataclasses.asdict(
        JP.RepackParams())
    for bad in (dict(policy="fifo"), dict(pin_fraction=1.5),
                dict(tier2_frac=1.0), dict(tier2_compression=0),
                dict(queue_depth=-1), dict(budget_frac=-0.1)):
        with pytest.raises(ValueError):
            TP.CacheParams(**bad)
        with pytest.raises(ValueError):
            JP.CacheParams(**bad)
    cp = TSS.SEGMENT_BENCH_ASYNC.cache
    assert cp.enabled and not cp.tier0_enabled
    assert cp.resolve_budget(1000) == JP.CacheParams(
        **dataclasses.asdict(cp)).resolve_budget(1000) == 100
