"""The port's hybrid hot tier (``repro_torch.io.hottier``, ``core.
navgraph.subset_navgraph``) and the hybrid ``SegmentServer`` with
tombstones against the JAX package, on the CPU.

The segment is the size of the JAX ``tests/test_hybrid.py`` setup (600
Gaussian vectors of width 24, the default ``SegmentParams``), built by
the JAX package and carried across by ``save_segment`` ->
``load_segment``. On this float data the hot-tier builds come out equal
to JAX's, edge for edge. Integer outputs (graphs, ids, exits, visit
counts) must be equal; distances agree within rtol 1e-5 / atol 1e-4,
since the beam search sums each distance in another order than numpy's
einsum.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import device_search as DS
from repro.core import navgraph as JN
from repro.core.params import HotTierParams, SegmentParams
from repro.core.segment import build_segment, save_segment
from repro.io import hottier as JH
from repro.serving.coordinator import SegmentServer

from repro_torch.core import device_search as TDS
from repro_torch.core import navgraph as TN
from repro_torch.core import params as TP
from repro_torch.core.segment import load_segment
from repro_torch.io import hottier as TH
from repro_torch.serving.coordinator import SegmentServer as TServer

N, DIM, K = 600, 24, 10
CPU = "cpu"
HOT = HotTierParams(budget_frac=0.10)
HOT_FIELDS = ("vectors", "ids", "adj", "deg", "dead")


def _tparams(p):
    return TP.HotTierParams(**dataclasses.asdict(p))


def _carried(hot):
    """The port's ``HotTier`` from the fields of a JAX one."""
    arrays = {f: getattr(hot, f) for f in HOT_FIELDS + (
        "size", "base_size", "entry", "metric")}
    arrays["params"] = dataclasses.asdict(hot.params)
    return TH.hot_tier_from_arrays(arrays, device=CPU)


def _same_tier(got, want):
    for f in HOT_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    assert (got.size, got.base_size, got.entry) == (
        want.size, want.base_size, want.entry)
    assert got._local_of == want._local_of


def _same_route(got, want):
    for f in ("ids", "exits", "hot_hits"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    np.testing.assert_allclose(got.dists, want.dists, rtol=1e-5, atol=1e-4)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((N, DIM)).astype(np.float32)
    q = rng.standard_normal((12, DIM)).astype(np.float32)
    seg = build_segment(x, SegmentParams())
    path = tmp_path_factory.mktemp("hyb") / "seg.npz"
    save_segment(seg, str(path))
    d2 = ((q[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    truth = np.argsort(d2, axis=1)[:, :K]
    return x, q, seg, load_segment(str(path)), truth


@pytest.fixture(scope="module")
def jhot(setup):
    return JH.build_hot_tier(setup[2], HOT)


def test_hot_tier_params_equal_jax():
    for kw in ({}, {"budget_frac": 0.25, "max_degree": 8, "exit_width": 2,
                    "cold_gamma_frac": 0.5, "hops": 2}):
        assert dataclasses.asdict(TP.HotTierParams(**kw)) == \
            dataclasses.asdict(HotTierParams(**kw))
    for bad in ({"budget_frac": 0.0}, {"cold_gamma_frac": 1.5},
                {"exit_width": 0}, {"append_slack": -1.0},
                {"search_beam": 2, "exit_width": 3}):
        with pytest.raises(ValueError):
            HotTierParams(**bad)
        with pytest.raises(ValueError):
            TP.HotTierParams(**bad)


@pytest.mark.parametrize("given_vectors", [False, True])
def test_subset_navgraph_equals_jax(setup, given_vectors):
    x = setup[0]
    ids = np.sort(np.random.default_rng(3).choice(N, 90, replace=False))
    kw = dict(max_degree=8, build_beam=16, seed=2)
    vecs = x[ids] if given_vectors else None
    src = None if given_vectors else x
    want = JN.subset_navgraph(src, ids, vectors=vecs, **kw)
    got = TN.subset_navgraph(src, ids, vectors=vecs, device=CPU, **kw)
    np.testing.assert_array_equal(got.sample_ids, want.sample_ids)
    np.testing.assert_array_equal(got.vectors, want.vectors)
    np.testing.assert_array_equal(got.graph.adj, want.graph.adj)
    np.testing.assert_array_equal(got.graph.deg, want.graph.deg)
    assert got.graph.entry == want.graph.entry
    assert got.memory_bytes() == want.memory_bytes()


def test_build_hot_tier_equals_jax(setup, jhot):
    got = TH.build_hot_tier(setup[3], _tparams(HOT), device=CPU)
    _same_tier(got, jhot)
    assert got.memory_bytes() == jhot.memory_bytes()
    assert got.live_count == jhot.live_count
    assert got.params == _tparams(jhot.params)


def test_route_on_carried_hot_tier_equals_jax(setup, jhot):
    q = setup[1]
    hot = _carried(jhot)
    _same_tier(hot, jhot)
    for k in (3, K, 20):
        _same_route(hot.route(q, k), jhot.route(q, k))


def test_insert_delete_then_route_equals_jax(setup):
    """Enough inserts to grow the append region, deletes of a base id,
    an appended id and a non-resident id, then a route: the graphs, the
    answers and the reports all equal JAX's."""
    x, q, seg, _, _ = setup
    jhot = JH.build_hot_tier(seg, HOT)
    hot = _carried(jhot)
    cap0 = jhot.vectors.shape[0]
    rng = np.random.default_rng(11)
    extra = rng.standard_normal((cap0 - jhot.size + 5, DIM)).astype(
        np.float32)
    gids = np.arange(N, N + extra.shape[0])
    jhot.insert(extra, gids)
    hot.insert(extra, gids)
    assert hot.vectors.shape[0] > cap0
    _same_tier(hot, jhot)
    victim = int(jhot.ids[3])
    for g in (victim, N + 1, 10 ** 9, victim):
        assert hot.delete(g) == jhot.delete(g)
    _same_tier(hot, jhot)
    assert hot.live_count == jhot.live_count
    queries = np.concatenate([q, extra[:4]])
    _same_route(hot.route(queries, K), jhot.route(queries, K))
    r = hot.route(extra[:1], 3)
    assert int(r.ids[0, 0]) == N and float(r.dists[0, 0]) == 0.0
    assert (r.exits < hot.base_size).all()


def test_merge_hot_cold_equals_jax():
    rng = np.random.default_rng(5)
    for _ in range(20):
        hi = rng.integers(-1, 30, 8)
        ci = rng.integers(-1, 30, 12)
        hd = rng.integers(0, 6, 8).astype(np.float32)
        cd = rng.integers(0, 6, 12).astype(np.float32)
        cd[rng.random(12) < 0.2] = np.inf
        for k in (1, 5, 10):
            for g, w in zip(TH.merge_hot_cold(k, hi, hd, ci, cd),
                            JH.merge_hot_cold(k, hi, hd, ci, cd)):
                np.testing.assert_array_equal(g, w)


def test_hybrid_server_with_tombstones_matches_jax(setup):
    """Tombstones on two base answers and one hot-resident id, in both
    tiers: ids, io and every batch column equal JAX's hybrid server."""
    x, q, seg, tseg, truth = setup
    jhot = JH.build_hot_tier(seg, HOT)
    thot = TH.build_hot_tier(tseg, _tparams(HOT), device=CPU)
    tomb = np.zeros(N, bool)
    victims = [int(truth[0, 0]), int(truth[1, 0]), int(jhot.ids[0])]
    tomb[victims] = True
    for v in victims:
        assert jhot.delete(v) == thot.delete(v)
    js = SegmentServer(segment=DS.from_segment(seg, tier0_frac=0.1),
                       offset=0, num_vectors=N, host=seg, hot_tier=jhot,
                       tombstones=tomb)
    ts = TServer(segment=TDS.from_segment(tseg, tier0_frac=0.1, device=CPU),
                 offset=0, num_vectors=N, host=tseg, hot_tier=thot,
                 tombstones=tomb, device=CPU)
    ji, jd, jio = js.search(q, K)
    ti, td, tio = ts.search(q, K)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(tio, jio)
    assert not np.isin(ti, victims).any()
    jst, tst = js.batch_stats(), ts.batch_stats()
    # the port's keys more: its blocking reads of device values and its
    # rounds replayed from a graph
    assert set(tst) == set(jst) | {"syncs", "graph_rounds"}
    for name, v in jst.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(tst[name], v, err_msg=name)
        else:
            assert tst[name] == v, name
    assert (tst["hot_tier_hits"] > 0).all()


def test_repack_needs_the_host_segment(setup):
    _, q, _, tseg, _ = setup
    ds = TDS.from_segment(tseg, tier0_frac=0.1, device=CPU)
    bare = TServer(segment=ds, offset=0, num_vectors=N, device=CPU)
    with pytest.raises(ValueError):
        bare.repack({0: 5})
    srv = TServer(segment=ds, offset=0, num_vectors=N, device=CPU,
                  host=tseg)
    assert srv.repack_source() is tseg
    ids0, d0, _ = srv.search(q, K)
    rho = tseg.num_blocks
    assert srv.repack({b: rho - b for b in range(rho)}) > 0
    ids1, d1, _ = srv.search(q, K)
    np.testing.assert_array_equal(ids1, ids0)
    np.testing.assert_array_equal(d1, d0)
