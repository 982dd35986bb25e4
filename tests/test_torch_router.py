"""The port's mesh router on one card (``repro_torch.serving.router.
MeshQueryRouter`` over ``launch.mesh.make_debug_mesh`` ranks), its
placement planning (``distributed.elastic``), ``core.device_search.
merge_shard_topk`` / ``stack_segments`` and ``RouterParams``, against the
JAX package on the CPU.

The JAX router needs 8 host devices (``tests/test_router.py`` skips in
tier 1), so the port is held to it three ways: the routed batch against
JAX's own ``merge_topk`` over JAX ``SegmentServer``s on the same
segments (the JAX router's claim: bit for bit on integer-valued data,
ids equal and distances within f32 summation order on float data);
``elastic``, ``merge_shard_topk`` and ``_rank_meta`` against JAX's
functions; and one test that runs JAX's router in a subprocess under
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` over a stream
and compares ids, dists, placements, rebalance plans, per-rank folds,
events and metrics with the port's. The segments are the
``tests/test_router.py`` fixture: 4 x 600 x 32 at ``SMALL_SEGMENT``.
"""
import dataclasses
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (the JAX package's import order)
from repro.core import device_search as JDS
from repro.core import iostats as JI
from repro.core import params as JP
from repro.core.segment import build_segment, save_segment
from repro.data.vectors import clustered_vectors, query_set
from repro.distributed import elastic as JE
from repro.serving import coordinator as JC
from repro.serving.router import MeshQueryRouter as JRouter
from tests.conftest import SMALL_SEGMENT
from test_torch_device_search import _tparams

import repro_torch.obs as TO
from repro_torch.core import device_search as TDS
from repro_torch.core.iostats import IOStats
from repro_torch.core.params import RouterParams
from repro_torch.core.segment import load_segment
from repro_torch.distributed import elastic as TE
from repro_torch.launch.mesh import RankLayout, make_debug_mesh
from repro_torch.serving import (MeshQueryRouter, QueryCoordinator,
                                 SegmentServer)
from repro_torch.serving import target as TT
from repro_torch.serving.coordinator import merge_topk

CPU = "cpu"
N_SEG, N_PER_SEG, DIM, W = 4, 600, 32, 8
ROUTER_PARAMS = dict(window_batches=8, rebalance_interval=4, min_window=2,
                     skew_threshold=1.2)
P_MESH = dataclasses.replace(JC.SERVE_DEVICE_SEARCH, candidates=48,
                             fetch_impl="jnp")


def _vectors(s, integer):
    x = clustered_vectors(N_PER_SEG, DIM, num_clusters=8, seed=30 + s)
    # integer-valued vectors (and queries) make every f32 distance exact,
    # so the two packages' sums agree bit for bit
    return np.round(x * 8).astype(np.float32) if integer else x


def _queries(xs, integer, seed=7, num=16):
    q = query_set(np.concatenate(xs), num, seed=seed)
    return np.round(q).astype(np.float32) if integer else q


def _build(tmp_path_factory, integer):
    """Both packages' servers over the same four JAX-built segments."""
    xs, jservers, tservers, off = [], [], [], 0
    for s in range(N_SEG):
        x = _vectors(s, integer)
        seg = build_segment(x, SMALL_SEGMENT)
        path = tmp_path_factory.mktemp("mesh") / f"seg{s}.npz"
        save_segment(seg, str(path))
        tseg = load_segment(str(path))
        jservers.append(JC.SegmentServer(
            segment=JDS.from_segment(seg, tier0_frac=0.1), offset=off,
            num_vectors=N_PER_SEG, params=P_MESH, host=seg))
        tservers.append(SegmentServer(
            segment=TDS.from_segment(tseg, tier0_frac=0.1, device=CPU),
            offset=off, num_vectors=N_PER_SEG, params=_tparams(P_MESH),
            host=tseg, device=CPU))
        xs.append(x)
        off += N_PER_SEG
    return SimpleNamespace(xs=xs, jax=jservers, torch=tservers,
                           q=_queries(xs, integer))


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    return _build(tmp_path_factory, integer=False)


@pytest.fixture(scope="module")
def mesh_int(tmp_path_factory):
    return _build(tmp_path_factory, integer=True)


def _router(servers, **kw):
    return MeshQueryRouter(servers, mesh=make_debug_mesh(1, W),
                           params=RouterParams(**ROUTER_PARAMS), **kw)


@pytest.fixture()
def router(mesh):
    return _router(mesh.torch)


def _single_target(servers, q, k=10):
    ids, dd, offs = [], [], []
    for s in servers:
        i, d, _ = s.search(q, k)
        ids.append(i)
        dd.append(d)
        offs.append(s.offset)
    return ids, dd, offs


# ------------------------------------------------------ elastic planning

def test_plan_placement_equals_jax():
    """Seeded loads, fresh and move-minimizing against a current
    placement (stale entries included), and the errors."""
    rng = np.random.default_rng(0)
    for trial in range(200):
        s = int(rng.integers(1, 7))
        ranks = s + int(rng.integers(0, 9))
        loads = rng.gamma(1.0, 3.0, s) * (rng.random(s) < 0.8)
        if trial % 7 == 0:
            loads = np.zeros(s)
        loads = loads.tolist()
        assert TE.plan_placement(loads, ranks) == JE.plan_placement(
            loads, ranks)
        cur = rng.integers(-1, s + 1, ranks).tolist()
        assert TE.plan_placement(loads, ranks, current=cur) == \
            JE.plan_placement(loads, ranks, current=cur)
    for bad in (([], 4), ([1.0, 2.0, 3.0], 2)):
        for fn in (TE.plan_placement, JE.plan_placement):
            with pytest.raises(ValueError):
                fn(*bad)


def test_plan_rebalance_equals_jax():
    rng = np.random.default_rng(1)
    fired = 0
    for trial in range(300):
        s = int(rng.integers(1, 5))
        ranks = s + int(rng.integers(0, 6))
        current = JE.plan_placement(rng.random(s).tolist(), ranks)
        rank_loads = rng.gamma(2.0, 1.0, ranks)
        rank_loads[rng.integers(0, ranks)] *= rng.uniform(1.0, 6.0)
        seg_loads = np.zeros(s)
        for r, si in enumerate(current):
            seg_loads[si] += rank_loads[r]
        thr = float(rng.choice([1.0, 1.2, 1.5, 3.0]))
        got = TE.plan_rebalance(current, seg_loads.tolist(),
                                rank_loads.tolist(), skew_threshold=thr)
        want = JE.plan_rebalance(current, seg_loads.tolist(),
                                 rank_loads.tolist(), skew_threshold=thr)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.fired == want.fired
        fired += got.fired
    assert 0 < fired < 300


def test_plan_remesh_equals_jax():
    for chips in range(0, 70, 3):
        for model in (1, 2, 4, 8):
            for pods in (1, 2):
                for batch in (32, 48, 100):
                    got = TE.plan_remesh(chips, model, batch, pods=pods)
                    want = JE.plan_remesh(chips, model, batch, pods=pods)
                    assert (got is None) == (want is None)
                    if got is not None:
                        assert dataclasses.asdict(got) == \
                            dataclasses.asdict(want)
                        assert got.chips == want.chips


# ------------------------------------------------- merge_shard_topk, stack

@pytest.mark.parametrize("shape", [(1, 3, 4), (4, 16, 10), (8, 5, 3)])
def test_merge_shard_topk_equals_jax(shape):
    """Ties on distance broken by id, invalid ids (-1, finite or inf
    distances) keyed past every real id, k up to every slot."""
    import jax.numpy as jnp
    rng = np.random.default_rng(sum(shape))
    s, q, kk = shape
    for trial in range(5):
        gids = rng.integers(0, 40, shape).astype(np.int32)
        gids[rng.random(shape) < 0.25] = -1
        gd = rng.integers(0, 6, shape).astype(np.float32)
        gd[(gids < 0) & (rng.random(shape) < 0.5)] = np.inf
        for k in (1, kk, s * kk):
            ti, td = TDS.merge_shard_topk(torch.as_tensor(gids),
                                          torch.as_tensor(gd), k)
            ji, jd = JDS.merge_shard_topk(jnp.asarray(gids),
                                          jnp.asarray(gd), k)
            np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
            np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_stack_segments_shapes_and_errors(mesh, small_segment,
                                          tmp_path_factory):
    """A stack of equal shards has JAX's shapes and dtypes; a shard of
    another shape raises JAX's error text; an empty list raises."""
    a, b = (s.segment for s in mesh.torch[:2])
    ja, jb = (s.segment for s in mesh.jax[:2])
    st, jst = TDS.stack_segments([a, b, a]), JDS.stack_segments([ja, jb, ja])
    for f in dataclasses.fields(TDS.DeviceSegment):
        g, w = getattr(st, f.name), getattr(jst, f.name)
        assert tuple(g.shape) == tuple(w.shape), f.name
        assert str(g.dtype).replace("torch.", "") == str(w.dtype), f.name
        np.testing.assert_array_equal(g[1].numpy(),
                                      getattr(b, f.name).numpy())
    path = tmp_path_factory.mktemp("big") / "seg.npz"
    save_segment(small_segment, str(path))
    other = TDS.from_segment(load_segment(str(path)), tier0_frac=0.1,
                             device=CPU)
    jother = JDS.from_segment(small_segment, tier0_frac=0.1)
    with pytest.raises(ValueError) as got:
        TDS.stack_segments([a, other])
    with pytest.raises(ValueError) as want:
        JDS.stack_segments([ja, jother])
    assert str(got.value) == str(want.value)
    for fn in (TDS.stack_segments, JDS.stack_segments):
        with pytest.raises(ValueError, match="at least one shard"):
            fn([])


# ------------------------------------------------------ acceptance core

def test_route_bit_identical_to_single_target(router, mesh):
    """Routed + merged == merge_topk over the port's per-segment paths,
    bit for bit; against JAX's servers the ids are equal and the
    distances within the f32 summation order."""
    ri, rd, stats = router.route(mesh.q, k=10)
    gi, gd = merge_topk(*_single_target(mesh.torch, mesh.q), 10)
    np.testing.assert_array_equal(ri, gi)
    np.testing.assert_array_equal(rd, gd)
    ji, jd = JC.merge_topk(*_single_target(mesh.jax, mesh.q), 10)
    np.testing.assert_array_equal(ri, ji)
    np.testing.assert_allclose(rd, jd, rtol=1e-6, atol=2.5e-4)
    assert stats["segments"] == N_SEG and stats["ranks"] == W


def _jax_meta(router):
    """JAX's ``_rank_meta`` / ``_rank_weights`` / ``_seg_ranks`` run on
    the port router's placement, offsets and window."""
    stand_in = JRouter.__new__(JRouter)
    stand_in.world = router.world
    stand_in._offsets = router._offsets
    stand_in._window = router._window
    stand_in._placement = list(router._placement)
    return stand_in


def test_route_bit_identical_to_jax_on_integer_data(mesh_int):
    """On integer-valued data the routed batch equals JAX's
    ``merge_topk`` over JAX's servers bit for bit, and each rank's
    ``IOStats`` equals JAX's ``fold_rank_batches`` of the JAX servers'
    columns masked to the rows JAX's ``_rank_meta`` gives the rank."""
    router = _router(mesh_int.torch)
    q = mesh_int.q
    ri, rd, stats = router.route(q, k=10)
    ji, jd = JC.merge_topk(*_single_target(mesh_int.jax, q), 10)
    np.testing.assert_array_equal(ri, ji)
    np.testing.assert_array_equal(rd, jd)
    meta = _jax_meta(router)._rank_meta(q.shape[0])
    cols = {}
    for r, si in enumerate(router.placement):
        bs = mesh_int.jax[si].batch_stats()
        own = ((np.arange(q.shape[0]) >= meta[r, 1])
               & (np.arange(q.shape[0]) < meta[r, 2])).astype(np.int32)
        cols[r] = tuple(np.asarray(bs[c]) * own for c in (
            "io", "tier0_hits", "hops", "dedup_saved")) + (
            int(bs["rounds"]), np.asarray(bs["dedup_cross"]) * own,
            bs["dma_pipelined"], np.asarray(bs["spec_hits"]) * own,
            np.asarray(bs["spec_wasted"]) * own, bs["dma_speculative"])
    want = JI.IOStats.fold_rank_batches(cols)
    assert {r: dataclasses.asdict(s) for r, s in stats["per_rank"].items()
            } == {r: dataclasses.asdict(s) for r, s in want.items()}
    assert dataclasses.asdict(stats["total"]) == dataclasses.asdict(
        JI.IOStats.merge_ranks(want))


def test_per_rank_fold_is_exact(router, mesh):
    _, _, stats = router.route(mesh.q, k=10)
    per_rank = stats["per_rank"]
    assert set(per_rank) == set(range(router.world))
    assert IOStats.merge_ranks(per_rank) == stats["total"]
    for field in ("cache_misses", "tier0_hits", "dedup_saved_fetches"):
        assert sum(getattr(r, field) for r in per_rank.values()) \
            == getattr(stats["total"], field)
    assert stats["rounds_max"] == max(
        r.batch_rounds for r in per_rank.values())
    assert stats["modeled_step_us"] == max(
        stats["per_rank_modeled_us"].values())
    assert stats["total_block_reads"] > 0


def test_replica_slices_equal_jax_and_partition(router, mesh):
    """Every segment's replica group partitions [0, q) into contiguous
    slices; the slices equal JAX's ``_rank_meta`` uniform, after routed
    batches filled the window, and on a skewed placement."""
    def check(r):
        for q in (1, 7, 16, 33, 1024):
            meta = r._rank_meta(q)
            np.testing.assert_array_equal(meta, _jax_meta(r)._rank_meta(q))
            for si, ranks in r._seg_ranks().items():
                lo = 0
                for rk in ranks:
                    assert meta[rk, 1] == lo and meta[rk, 2] >= lo
                    lo = int(meta[rk, 2])
                assert lo == q
    check(router)
    for _ in range(3):
        router.route(mesh.q, k=10)
    check(router)
    router._placement = [0, 0, 0, 0, 1, 2, 2, 3]
    router._restack()
    rng = np.random.default_rng(4)
    router._window.append((rng.random(W) * 5, rng.random(N_SEG), np.ones(W)))
    check(router)


def test_routed_speculation_is_bit_identical(router, mesh):
    spec = [dataclasses.replace(s, params=dataclasses.replace(
        s.params, speculate=True)) for s in mesh.torch]
    spec_router = _router(spec)
    ri, rd, stats = router.route(mesh.q, k=10)
    si, sd, sstats = spec_router.route(mesh.q, k=10)
    np.testing.assert_array_equal(ri, si)
    np.testing.assert_array_equal(rd, sd)
    for field in ("cache_misses", "tier0_hits", "hops",
                  "dedup_saved_fetches", "dedup_cross_tile"):
        assert getattr(stats["total"], field) \
            == getattr(sstats["total"], field), field
    assert stats["rounds_max"] == sstats["rounds_max"]
    assert stats["total_spec_hits"] == 0 == stats["total_spec_wasted"]
    assert stats["total"].dma_speculative == 0
    assert sstats["total"].dma_speculative == 1
    assert sstats["total_spec_hits"] == sum(
        r.spec_hits for r in sstats["per_rank"].values()) > 0
    bs = spec_router.batch_stats()
    assert int(np.sum(bs["spec_hits"])) == sstats["total_spec_hits"]
    assert int(np.sum(bs["spec_wasted"])) == sstats["total_spec_wasted"]
    assert bs["dma_speculative"] is True


def test_router_is_segment_target(router, mesh):
    """The protocol surface; the adapter's ``batch_stats`` carries the
    full schema (the router's own dict, as JAX's, lacks the hot-tier
    column, which the adapter zero-fills)."""
    assert isinstance(router, TT.SegmentTarget) and TT.is_target(router)
    assert router.offset == 0
    assert router.num_vectors == N_SEG * N_PER_SEG
    assert router.batch_stats() == {}
    ids, dists, io = router.search(mesh.q, k=10)
    assert ids.shape == (mesh.q.shape[0], 10) and io.shape == (16,)
    bs = TT.batch_stats(router)
    assert set(TT.BATCH_STAT_KEYS) <= set(bs)
    assert not np.asarray(bs["hot_tier_hits"]).any()
    assert int(np.sum(bs["io"])) == router.last_stats.cache_misses
    np.testing.assert_array_equal(np.asarray(bs["io"], np.int64), io)
    assert router.repack_source() is None and router.demand_feed() is None
    assert router.lifetime_stats()["batches"] == 1.0


def test_router_through_coordinator(router, mesh):
    ri, rd, _ = router.route(mesh.q, k=10)
    coord = QueryCoordinator([router])
    ci, cd, stats = coord.search(mesh.q, k=10)
    np.testing.assert_array_equal(ci, ri)
    np.testing.assert_array_equal(cd, rd)
    assert stats["segments_searched"] == 1
    assert stats["total_block_reads"] == router.last_stats.cache_misses


def test_router_repack_keeps_results(router, mesh):
    """``repack`` swaps every member's pack and restacks: the same ids
    and distances and block reads, cold reads moving into tier 0."""
    ri, rd, st0 = router.route(mesh.q, k=10)
    rho = mesh.torch[0].host.num_blocks
    assert router.repack({b: rho - b for b in range(rho)}) > 0
    ri2, rd2, st1 = router.route(mesh.q, k=10)
    np.testing.assert_array_equal(ri2, ri)
    np.testing.assert_array_equal(rd2, rd)
    assert st1["total_block_reads"] == st0["total_block_reads"]
    assert st1["total_tier0_hits"] > st0["total_tier0_hits"]
    assert st1["total"].cache_misses < st0["total"].cache_misses


# --------------------------------------------------------- rebalance

def test_rebalance_quiet_on_settled_stream(router, mesh):
    before = router.placement
    fired = []
    for _ in range(router.params.rebalance_interval * 2):
        _, _, stats = router.route(mesh.q, k=10)
        if "rebalance" in stats:
            fired.append(stats["rebalance"]["fired"])
    assert fired and not any(fired)
    assert router.placement == before and router.rebalances == 0


def test_rebalance_fires_on_skew_then_settles(router, mesh):
    router.route(mesh.q, k=10)
    hot = 0
    skewed_rank = np.asarray([40.0 if router.placement[r] == hot else 1.0
                              for r in range(W)])
    seg = np.zeros(N_SEG)
    for r in range(W):
        seg[router.placement[r]] += skewed_rank[r]
    router._window.clear()
    for _ in range(router.params.min_window):
        router._window.append((skewed_rank, seg, np.ones(W)))
    plan = router.maybe_rebalance(force=True)
    assert plan is not None and plan.fired and len(plan.moves) > 0
    assert plan.skew >= router.params.skew_threshold
    counts = np.bincount(router.placement, minlength=N_SEG)
    assert counts[hot] > counts[1:].max() and counts.min() >= 1
    assert router.rebalances == 1 and len(router._window) == 0
    settled = np.ones(W)
    seg2 = np.bincount(router.placement, minlength=N_SEG).astype(float)
    for _ in range(router.params.min_window):
        router._window.append((settled, seg2, np.ones(W)))
    plan2 = router.maybe_rebalance(force=True)
    assert plan2 is not None and not plan2.fired


def test_rebalanced_placement_serves_identically(router, mesh):
    ri, rd, _ = router.route(mesh.q, k=10)
    router._placement = [0, 0, 0, 0, 1, 1, 2, 3]
    router._restack()
    assert router._seg_stack[3] is mesh.torch[0].segment   # a reference
    ri2, rd2, _ = router.route(mesh.q, k=10)
    np.testing.assert_array_equal(ri2, ri)
    np.testing.assert_array_equal(rd2, rd)


def test_skewed_placement_fires_back_on_a_real_stream(mesh):
    """A placement planned for segment-0-heavy traffic meets a stream
    that loads every segment alike (each rank searches the whole
    batch): the owned-row slices make the rank loads skewed, the
    evaluation fires back towards one replica pair a segment, and the
    next evaluation plans zero moves."""
    router = _router(mesh.torch)
    router._placement = TE.plan_placement([5.0, 1.0, 1.0, 1.0], W)
    router._restack()
    fired = []
    for b in range(2 * router.params.rebalance_interval):
        _, _, st = router.route(_queries(mesh.xs[:1], False, seed=20 + b),
                                k=10)
        if "rebalance" in st:
            fired.append((st["rebalance"]["fired"], st["rebalance"]["moves"],
                          st["rebalance"]["placement"]))
    assert fired[0][0] and fired[0][1] > 0
    assert fired[1] == (False, 0, fired[0][2])
    assert np.bincount(router.placement, minlength=N_SEG).min() >= 2


# ---------------------------------------------- validation, layouts

def test_router_params_equal_jax_and_validate():
    assert dataclasses.asdict(RouterParams()) == dataclasses.asdict(
        JP.RouterParams())
    for bad in (dict(window_batches=0), dict(rebalance_interval=0),
                dict(min_window=32, window_batches=16),
                dict(skew_threshold=0.5), dict(min_window=0)):
        with pytest.raises(ValueError) as got:
            RouterParams(**bad)
        with pytest.raises(ValueError) as want:
            JP.RouterParams(**bad)
        assert str(got.value) == str(want.value)


class _Stub:
    def __init__(self, params, metric="l2", num_vectors=10, offset=0):
        self.params = params
        self.metric = metric
        self.num_vectors = num_vectors
        self.offset = offset


def test_router_rejects_mismatched_members():
    p = _tparams(JC.SERVE_DEVICE_SEARCH)
    other = dataclasses.replace(p, candidates=p.candidates * 2)
    with pytest.raises(ValueError, match="share DeviceSearchParams"):
        MeshQueryRouter([_Stub(p), _Stub(other)])
    with pytest.raises(ValueError, match="share DeviceSearchParams"):
        MeshQueryRouter([_Stub(p, metric="l2"), _Stub(p, metric="mips")])
    with pytest.raises(ValueError, match="at least one"):
        MeshQueryRouter([])


class _FakeMesh:
    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


@pytest.mark.parametrize("layout", ["fake", "debug"])
def test_router_rejects_undersized_world_and_data_axis(layout):
    p = _tparams(JC.SERVE_DEVICE_SEARCH)

    def mk(data, model):
        return (_FakeMesh({"data": data, "model": model})
                if layout == "fake" else make_debug_mesh(data, model))
    with pytest.raises(ValueError, match="cannot hold"):
        MeshQueryRouter([_Stub(p), _Stub(p)], mesh=mk(1, 1))
    with pytest.raises(ValueError, match="'model' only"):
        MeshQueryRouter([_Stub(p)], mesh=mk(2, 2))


def test_debug_mesh_layout_and_default(mesh):
    lay = make_debug_mesh(1, 8)
    assert isinstance(lay, RankLayout)
    assert dict(lay.shape) == {"data": 1, "model": 8}
    assert lay.axis_names == ("data", "model")
    # what the router reads of a JAX mesh, and nothing else: the ranks
    # run where the members' segments lie
    assert [f.name for f in dataclasses.fields(lay)] == ["shape",
                                                        "axis_names"]
    with pytest.raises(ValueError):
        make_debug_mesh(0, 2)
    r = MeshQueryRouter(mesh.torch[:2])
    assert r.world == 2 and r.placement == (0, 1)
    assert dict(r.mesh.shape) == {"data": 1, "model": 2}


def test_restack_enforces_shape_identity(mesh, small_segment,
                                         tmp_path_factory):
    path = tmp_path_factory.mktemp("odd") / "seg.npz"
    save_segment(small_segment, str(path))
    tseg = load_segment(str(path))
    odd = SegmentServer(segment=TDS.from_segment(tseg, tier0_frac=0.1,
                                                 device=CPU),
                        offset=N_SEG * N_PER_SEG,
                        num_vectors=tseg.num_vectors,
                        params=mesh.torch[0].params, device=CPU)
    with pytest.raises(ValueError, match="shape-identical"):
        _router(mesh.torch[:3] + [odd])


def test_restack_rejects_members_on_two_devices(mesh):
    s3 = mesh.torch[3]
    away = SimpleNamespace(segment=s3.segment.to("meta"), offset=s3.offset,
                           num_vectors=s3.num_vectors, params=s3.params)
    with pytest.raises(ValueError, match="on one"):
        _router(mesh.torch[:3] + [away])


def test_step_searches_once_per_segment(router, mesh, monkeypatch):
    """Replicas share their segment's search: 4 segments on 8 ranks run
    4 searches a batch, and each rank's columns are those of its own
    search of the whole batch, masked to the rows it owns."""
    import repro_torch.serving.router as rmod
    real, calls = rmod.device_anns, []

    def counted(seg, q, p, **kw):
        calls.append(id(seg))
        return real(seg, q, p, **kw)

    monkeypatch.setattr(rmod, "device_anns", counted)
    assert len(set(router.placement)) == N_SEG < router.world
    meta = router._rank_meta(mesh.q.shape[0])
    router.route(mesh.q, k=10)
    assert len(calls) == N_SEG == len(set(calls))

    p = dataclasses.replace(router.search_params, k=10,
                            candidates=max(router.search_params.candidates,
                                           10))
    q = torch.as_tensor(mesh.q)
    for r, seg in enumerate(router._seg_stack):
        res = real(seg, q, p, metric=router.metric)
        own = np.zeros(q.shape[0], bool)
        own[int(meta[r, 1]):int(meta[r, 2])] = True
        for got, col in zip(router._last_cols[:3],
                            (res.io, res.tier0_hits, res.hops)):
            assert np.array_equal(got[:, r], np.where(own, col.numpy(), 0))
        assert router._last_cols[-1][r] == int(res.rounds)


# ----------------------------------- JAX's router on 8 host devices

STREAM = 12            # 4 uniform batches, then 8 near segment 0


def _stream(xs, integer):
    """Batch b of the comparison stream: uniform, then near segment 0;
    on batch 4 a placement planned for segment-0-heavy traffic."""
    for b in range(STREAM):
        src = xs if b < 4 else xs[:1]
        yield b, _queries(src, integer, seed=40 + b)


def _record(router, stream, obs):
    out = []
    for b, q in stream:
        if b == 4:
            router._placement = list(obs.E.plan_placement(
                [5.0, 1.0, 1.0, 1.0], W))
            router._restack()
        ri, rd, st = router.route(q, k=10)
        out.append({
            "ids": np.asarray(ri).tolist(),
            "dists": np.asarray(rd).astype(np.float32).view(
                np.int32).tolist(),
            "placement": list(st["placement"]),
            "rebalance": st.get("rebalance"),
            "per_rank": {str(r): dataclasses.asdict(s)
                         for r, s in st["per_rank"].items()},
            "modeled": {str(r): v for r, v in
                        st["per_rank_modeled_us"].items()}})
    events = [[e.name, e.cat, e.ph, e.ts_us, e.dur_us, e.track,
               {k: [type(v).__name__, v] for k, v in e.args.items()}]
              for e in obs.tracer.events]
    return {"batches": out, "events": events,
            "snapshot": obs.metrics.snapshot(),
            "rebalances": router.rebalances}


def _jax_side():
    """Build the integer fixture with the JAX package and serve the
    stream through JAX's own router on 8 host devices; JSON out."""
    import jax
    import repro.obs as JO
    assert jax.device_count() == 8, jax.device_count()
    xs, servers, off = [], [], 0
    for s in range(N_SEG):
        x = _vectors(s, True)
        seg = build_segment(x, SMALL_SEGMENT)
        servers.append(JC.SegmentServer(
            segment=JDS.from_segment(seg, tier0_frac=0.1), offset=off,
            num_vectors=N_PER_SEG, params=P_MESH, host=seg))
        xs.append(x)
        off += N_PER_SEG
    obs = SimpleNamespace(E=JE, tracer=JO.manual_tracer(),
                          metrics=JO.MetricsRegistry())
    router = JRouter(servers, params=JP.RouterParams(**ROUTER_PARAMS),
                     tracer=obs.tracer, metrics=obs.metrics)
    print(json.dumps(_record(router, _stream(xs, True), obs)))


def test_router_stream_equals_jax_router_on_8_host_devices(mesh_int):
    """JAX's ``MeshQueryRouter`` (``shard_map`` over 8 forced host
    devices, in a subprocess) and the port's on one device serve the
    same stream: equal ids and distance bits, placements, rebalance
    plans (the placement planned for skewed traffic fires back and then
    settles), per-rank folds, modeled step figures, every
    ``router.*`` / ``coord.shard`` event under ``ManualClock`` and the
    registry's snapshot."""
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(root, "src"), root, os.path.join(root, "tests")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    done = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "jax-router"], env=env, capture_output=True,
                          text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-3000:]
    want = json.loads(done.stdout.strip().splitlines()[-1])
    obs = SimpleNamespace(E=TE, tracer=TO.manual_tracer(),
                          metrics=TO.MetricsRegistry())
    router = _router(mesh_int.torch, tracer=obs.tracer, metrics=obs.metrics)
    got = json.loads(json.dumps(_record(router, _stream(mesh_int.xs, True),
                                        obs)))
    for b, (g, w) in enumerate(zip(got["batches"], want["batches"])):
        assert g == w, f"batch {b}"
    assert got["rebalances"] == want["rebalances"] >= 1
    fired = [g["rebalance"]["fired"] for g in got["batches"]
             if g["rebalance"]]
    assert fired[-2:] == [True, False]
    assert got["events"] == want["events"]
    assert got["snapshot"] == want["snapshot"]


if __name__ == "__main__" and sys.argv[1:] == ["jax-router"]:
    _jax_side()
