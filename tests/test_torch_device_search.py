"""The port's device search (``repro_torch.core.device_search``) against
the JAX package on the session ``small_segment``.

The segment is built by the JAX package and carried across through
``repro.core.segment.save_segment`` -> ``repro_torch.core.segment.
load_segment``, with the 10% tier-0 pack and the conformance knobs
``P_CONF``. Both searches run on the CPU; the JAX round kernel runs in
interpret mode, the port's round stage through its kernels' plain
versions.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import device_search as DS
from repro.core import distances as D
from repro.core.params import DeviceSearchParams
from repro.core.search import recall_at_k
from repro.core.segment import save_segment
from repro.serving import SegmentServer
from test_e2e_conformance import GOLDEN_DEVICE, P_CONF

from repro_torch.core import device_search as TDS
from repro_torch.core import params as TP
from repro_torch.core.segment import load_segment
from repro_torch.serving.coordinator import SegmentServer as TServer
from repro_torch.serving.coordinator import merge_topk as t_merge_topk

COUNTERS = ("io", "tier0_hits", "hops", "dedup_saved", "dedup_cross",
            "spec_hits", "spec_wasted")


def _tparams(p: DeviceSearchParams, **kw) -> TP.DeviceSearchParams:
    """The same knob values in the port's dataclass (``jnp`` -> ``ref``)."""
    vals = dataclasses.asdict(p)
    vals["fetch_impl"] = "ref" if vals["fetch_impl"] == "jnp" else "fused"
    vals.update(kw)
    return TP.DeviceSearchParams(**vals)


@pytest.fixture(scope="module")
def jds(small_segment):
    return DS.from_segment(small_segment, tier0_frac=0.1)


@pytest.fixture(scope="module")
def tseg(small_segment, tmp_path_factory):
    path = tmp_path_factory.mktemp("seg") / "small.npz"
    save_segment(small_segment, str(path))
    return load_segment(str(path))


@pytest.fixture(scope="module")
def tds(tseg):
    return TDS.from_segment(tseg, tier0_frac=0.1, device="cpu")


@pytest.fixture(scope="module")
def queries(small_data):
    return small_data[1]


@pytest.fixture(scope="module")
def jres(jds, queries):
    p = dataclasses.replace(P_CONF, speculate=True, trace_rounds=True)
    return DS.device_anns(jds, jnp.asarray(queries), p)


@pytest.fixture(scope="module")
def tres(tds, queries):
    return TDS.device_anns(tds, torch.as_tensor(queries), _tparams(P_CONF))


def test_carried_segment_equals_jax_device_arrays(jds, tds):
    """Every field equal to JAX's, in shape and dtype too (so that no
    broadcast hides a [1] against a scalar)."""
    for f in dataclasses.fields(DS.DeviceSegment):
        got, want = getattr(tds, f.name).numpy(), np.asarray(
            getattr(jds, f.name))
        assert got.shape == want.shape, f.name
        assert got.dtype == want.dtype, f.name
        np.testing.assert_array_equal(got, want, err_msg=f.name)
    assert TDS.hot_pack_blocks(tds) == DS.hot_pack_blocks(jds)
    assert TDS.tier0_bytes(tds) == DS.tier0_bytes(jds)
    assert TDS._ROUND_LOG_COLS == DS._ROUND_LOG_COLS


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_top_matches_jax(seed):
    rng = np.random.default_rng(seed)
    q, a, b, size = 6, 12, 20, 10
    keys = rng.integers(0, 6, (q, a)).astype(np.float32)   # many ties
    ids = rng.integers(-1, 15, (q, a)).astype(np.int32)
    nk = rng.integers(0, 6, (q, b)).astype(np.float32)
    ni = rng.integers(-1, 15, (q, b)).astype(np.int32)
    keys[ids < 0] = np.inf
    nk[ni < 0] = np.inf
    ex = rng.integers(0, 2, (q, a)).astype(np.int32)
    nex = np.zeros((q, b), np.int32)
    want = DS._merge_top(*map(jnp.asarray, (keys, ids, nk, ni)), size,
                         extra=jnp.asarray(ex), new_extra=jnp.asarray(nex))
    got = TDS._merge_top(*map(torch.as_tensor, (keys, ids, nk, ni)), size,
                         extra=torch.as_tensor(ex),
                         new_extra=torch.as_tensor(nex))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_bit_get_set_matches_jax():
    rng = np.random.default_rng(3)
    q, nw = 5, 4
    words = rng.integers(0, 2 ** 32, (q, nw), dtype=np.uint64).astype(
        np.uint32)
    words[0, 0] = 0x80000000                      # the sign bit alone
    ids = rng.integers(0, nw * 32, (q, 9)).astype(np.int32)
    ids[:, 0] = 31
    want = np.asarray(DS._bit_get(jnp.asarray(words), jnp.asarray(ids)))
    tmask = torch.as_tensor(words.view(np.int32).copy())
    got = TDS._bit_get(tmask, torch.as_tensor(ids)).numpy()
    np.testing.assert_array_equal(got, want)
    jm = jnp.asarray(words)
    for j in range(ids.shape[1]):
        on = rng.random(q) < 0.6
        jm = DS._bit_set(jm, jnp.asarray(ids[:, j]), jnp.asarray(on))
        TDS._bit_set(tmask, torch.as_tensor(ids[:, j]), torch.as_tensor(on))
    np.testing.assert_array_equal(tmask.numpy().view(np.uint32),
                                  np.asarray(jm))


def test_adc_matches_jax(jds, tds, queries):
    """The segment's LUTs and ADC keys equal JAX's bit for bit (both add
    their terms in order: dsub for the LUT, M for the key)."""
    codes = np.asarray(jds.pq_codes)[np.random.default_rng(0).integers(
        0, jds.pq_codes.shape[0], (24, 30))]
    for metric in ("l2", "ip"):
        lj = DS._adc_lut(jnp.asarray(queries), jds.pq_cent, metric)
        lt = TDS._adc_lut(torch.as_tensor(queries), tds.pq_cent, metric)
        np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
        lut = np.array(lj)
        aj = DS._adc(jnp.asarray(lut), jnp.asarray(codes))
        at = TDS._adc(torch.as_tensor(lut), torch.as_tensor(codes))
        np.testing.assert_array_equal(at.numpy(), np.asarray(aj))


@pytest.mark.parametrize("qn,m,k,i,seed", [(16, 8, 256, 30, 0),
                                           (9, 4, 16, 50, 1),
                                           (5, 16, 256, 20, 2)])
def test_adc_keys_bit_equal_jax(qn, m, k, i, seed):
    """``_adc`` on seeded random f32 LUTs and codes: JAX's bits on every
    key (a ``torch.sum`` over M gives them on under half at M = 8)."""
    rng = np.random.default_rng(seed)
    lut = (rng.standard_normal((qn, m, k)) * 10).astype(np.float32)
    codes = rng.integers(0, k, (qn, i, m)).astype(np.uint8)
    want = np.asarray(DS._adc(jnp.asarray(lut), jnp.asarray(codes)))
    got = TDS._adc(torch.as_tensor(lut), torch.as_tensor(codes)).numpy()
    np.testing.assert_array_equal(got, want)


def test_nav_entry_points_match_jax(jds, tds, queries):
    want = np.asarray(DS.nav_entry_points(jds, jnp.asarray(queries)))
    got = TDS.nav_entry_points(tds, torch.as_tensor(queries)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("tile,seed", [(8, 0), (4, 1), (16, 2)])
def test_dedup_joins_match_jax(tile, seed):
    rng = np.random.default_rng(seed)
    b = rng.integers(0, 10, (21, 2)).astype(np.int32)
    cold = rng.random((21, 2)) < 0.7
    want = DS._dedup_joins(jnp.asarray(b), jnp.asarray(cold), tile)
    got = TDS._dedup_joins(torch.as_tensor(b), torch.as_tensor(cold), tile)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_device_anns_matches_jax(jres, tres, small_data):
    x, q = small_data
    oracle = D.brute_force_knn(x, q, 10)
    ij, it = np.asarray(jres.ids), tres.ids.numpy()
    assert abs(recall_at_k(it, oracle) - recall_at_k(ij, oracle)) <= 0.01
    same = (ij == it).all(axis=1)
    assert same.mean() >= 0.95
    np.testing.assert_allclose(tres.dists.numpy()[same],
                               np.asarray(jres.dists)[same], rtol=1e-5,
                               atol=1e-4)
    for name in COUNTERS[:5]:
        np.testing.assert_array_equal(
            getattr(tres, name).numpy()[same],
            np.asarray(getattr(jres, name))[same], err_msg=name)


def test_device_counters_hit_golden(tres):
    got = {"touches": int((tres.io + tres.tier0_hits).sum()),
           "io": int(tres.io.sum()), "tier0_hits": int(tres.tier0_hits.sum()),
           "dedup_saved": int(tres.dedup_saved.sum()),
           "hops": int(tres.hops.sum()), "rounds": int(tres.rounds)}
    assert got == GOLDEN_DEVICE


# An ip-built segment (``SMALL_SEGMENT`` with ``metric="ip"``), searched
# by both packages with ip distances. The ADC keys are bit-exact, but the
# exact distances are not: JAX's ``einsum`` over D has no torch form that
# gives its bits (``torch.sum`` matches ~36% of them at D = 32, an
# in-order sum ~24%). A few decisions flip on these 29 queries; the
# bounds below are the counts measured after the ADC repair.
IP_QUERIES = (29, 1)                      # query_set size and seed
IP_NAV_DIFF = 4                           # nav entries (all in one row)
IP_COUNTER_DIFF = {2: {"io": 1, "dedup_saved": 2},
                   1: {"io": 1, "hops": 1}}


@pytest.fixture(scope="module")
def ip_case(small_data, tmp_path_factory):
    from conftest import SMALL_SEGMENT
    from repro.core.segment import build_segment
    from repro.data.vectors import query_set
    x, _ = small_data
    seg = build_segment(x, dataclasses.replace(SMALL_SEGMENT, metric="ip"))
    path = tmp_path_factory.mktemp("seg_ip") / "small_ip.npz"
    save_segment(seg, str(path))
    q = query_set(x, IP_QUERIES[0], seed=IP_QUERIES[1])
    return (DS.from_segment(seg, tier0_frac=0.1),
            TDS.from_segment(load_segment(str(path)), tier0_frac=0.1,
                             device="cpu"), q)


def test_ip_nav_entry_points_near_jax(ip_case):
    jds_ip, tds_ip, q = ip_case
    want = np.asarray(DS.nav_entry_points(jds_ip, jnp.asarray(q),
                                          metric="ip"))
    got = TDS.nav_entry_points(tds_ip, torch.as_tensor(q),
                               metric="ip").numpy()
    assert got.shape == want.shape
    assert int((got != want).sum()) <= IP_NAV_DIFF


@pytest.mark.parametrize("fetch_width", [2, 1])
def test_ip_segment_matches_jax(ip_case, small_data, fetch_width):
    """ids equal on every query, recall@10 within 0.01, and each counter
    equal per query except on at most the measured number of queries."""
    jds_ip, tds_ip, q = ip_case
    x, _ = small_data
    p = dataclasses.replace(P_CONF, fetch_width=fetch_width)
    want = DS.device_anns(jds_ip, jnp.asarray(q), p, metric="ip")
    got = TDS.device_anns(tds_ip, torch.as_tensor(q), _tparams(p),
                          metric="ip")
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    oracle = D.brute_force_knn(x, q, 10, metric="ip")
    assert abs(recall_at_k(got.ids.numpy(), oracle)
               - recall_at_k(np.asarray(want.ids), oracle)) <= 0.01
    np.testing.assert_allclose(got.dists.numpy(), np.asarray(want.dists),
                               rtol=1e-5, atol=1e-4)
    assert got.rounds == int(want.rounds)
    for name in COUNTERS:
        differ = int((getattr(got, name).numpy()
                      != np.asarray(getattr(want, name))).sum())
        assert differ <= IP_COUNTER_DIFF[fetch_width].get(name, 0), name


def test_speculation_and_round_log_match_jax(jres, tds, queries):
    """Speculation accounting and the per-round log against the JAX run
    with both knobs on."""
    r = TDS.device_anns(tds, torch.as_tensor(queries),
                        _tparams(P_CONF, speculate=True, trace_rounds=True))
    same = (np.asarray(jres.ids) == r.ids.numpy()).all(axis=1)
    assert same.all()
    for name in COUNTERS:
        np.testing.assert_array_equal(getattr(r, name).numpy(),
                                      np.asarray(getattr(jres, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(r.round_log.numpy()[: r.rounds],
                                  np.asarray(jres.round_log)[: r.rounds])


@pytest.mark.parametrize("knob", [
    {"fuse_union": False}, {"speculate": True}, {"trace_rounds": True},
    {"fetch_impl": "ref"}, {"compact_frac": 0.0}, {"round_tile_cap": 8},
    {"pipeline_dma": False}])
def test_knobs_are_bit_identical(tds, tres, queries, knob):
    r = TDS.device_anns(tds, torch.as_tensor(queries),
                        _tparams(P_CONF, **knob))
    assert torch.equal(r.ids, tres.ids)
    assert torch.equal(r.dists, tres.dists)
    for name in COUNTERS[:4]:
        assert torch.equal(getattr(r, name), getattr(tres, name)), name
    if "round_tile_cap" not in knob and "compact_frac" not in knob:
        assert torch.equal(r.dedup_cross, tres.dedup_cross)
    if knob.get("trace_rounds"):
        log = r.round_log[: r.rounds].sum(0)
        assert int(log[0]) == int(r.hops.sum())
        assert int(log[1]) == int(r.io.sum())
        assert int(log[2]) == int(r.tier0_hits.sum())
        assert int(log[3]) == int(r.dedup_saved.sum())


def test_segment_server_matches_jax(jds, tds, small_data):
    x, q = small_data
    js = SegmentServer(segment=jds, offset=0, num_vectors=x.shape[0],
                       params=P_CONF)
    ts = TServer(segment=tds, offset=0, num_vectors=x.shape[0],
                 params=_tparams(P_CONF), device="cpu")
    ji, jd, jio = js.search(q, 10)
    ti, td, tio = ts.search(q, 10)
    same = (ji == ti).all(axis=1)
    assert same.mean() >= 0.95
    np.testing.assert_array_equal(tio[same], jio[same])
    jst, tst = js.batch_stats(), ts.batch_stats()
    # the port's keys more: its blocking reads of device values and its
    # rounds replayed from a graph
    assert set(tst) == set(jst) | {"syncs", "graph_rounds"}
    for name, v in jst.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(tst[name][same], v[same],
                                          err_msg=name)
        else:
            assert tst[name] == v, name
    with pytest.raises(ValueError):             # no host segment
        ts.repack({})


def test_merge_topk_matches_jax():
    from repro.serving.coordinator import merge_topk
    rng = np.random.default_rng(4)
    ids = [rng.integers(-1, 50, (5, 4)), rng.integers(-1, 50, (5, 3))]
    dists = [rng.integers(0, 4, (5, 4)).astype(np.float32),
             rng.integers(0, 4, (5, 3)).astype(np.float32)]
    for g, w in zip(t_merge_topk(ids, dists, [0, 100], 5),
                    merge_topk(ids, dists, [0, 100], 5)):
        np.testing.assert_array_equal(g, w)


def test_cuda_entry_point_without_card_raises(tds):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises((RuntimeError, AssertionError)):
        tds.to("cuda")


def test_presets_match_jax():
    from repro.configs.starling_segment import (DEVICE_SEARCH_BATCH,
                                                SEGMENT_BENCH_DEVICE)
    from repro.serving.coordinator import SERVE_DEVICE_SEARCH
    from repro_torch.configs import starling_segment as TSS
    from repro_torch.serving import coordinator as TC
    for t, j in ((TSS.DEVICE_SEARCH_BATCH, DEVICE_SEARCH_BATCH),
                 (TC.SERVE_DEVICE_SEARCH, SERVE_DEVICE_SEARCH)):
        assert t == _tparams(j)
    seg = TSS.SEGMENT_BENCH_DEVICE
    assert seg.cache.tier0_frac == SEGMENT_BENCH_DEVICE.cache.tier0_frac
    assert seg.graph.max_degree == SEGMENT_BENCH_DEVICE.graph.max_degree
    assert seg.layout.block_kb == SEGMENT_BENCH_DEVICE.layout.block_kb
    assert seg.nav.max_degree == SEGMENT_BENCH_DEVICE.nav.max_degree
    assert seg.nav.sample_ratio == SEGMENT_BENCH_DEVICE.nav.sample_ratio
    for f in ("num_subspaces", "num_centroids", "train_iters",
              "train_sample", "seed"):
        assert getattr(seg.pq, f) == getattr(SEGMENT_BENCH_DEVICE.pq, f)
    # the serving plane's presets: the host search's knobs, the block
    # cache's and the repack scheduler's
    from repro.configs import starling_segment as JSS
    for name in ("SEGMENT_BENCH", "SEGMENT_BENCH_CACHED",
                 "SEGMENT_BENCH_ASYNC", "SEGMENT_BENCH_DEVICE"):
        t, j = getattr(TSS, name), getattr(JSS, name)
        assert dataclasses.asdict(t.search) == dataclasses.asdict(j.search)
        assert dataclasses.asdict(t.cache) == dataclasses.asdict(j.cache)
    assert dataclasses.asdict(TSS.SERVE_REPACK) == dataclasses.asdict(
        JSS.SERVE_REPACK)


# ---------------------------------------------------------- range search

RANGE_COUNTERS = ("io", "tier0_hits", "dedup_saved", "dedup_cross",
                  "spec_hits", "spec_wasted")


def test_device_range_search_matches_jax(jds, tds, small_data):
    """Three range rounds (Γ 48 -> 96 -> 192) with speculation on:
    ids, ``in_range``, every counter and the loop rounds equal JAX's;
    distances within 2.5e-4 or 1e-6 relative (a few ulps: the far
    results reach values past 1,000)."""
    x, q = small_data
    radius = float(np.quantile(D.pairwise(q, x), 0.002))
    p = dataclasses.replace(P_CONF, speculate=True)
    want = DS.device_range_search(jds, jnp.asarray(q), radius=radius,
                                  k_cap=192, p=p)
    got = TDS.device_range_search(tds, torch.as_tensor(q), radius,
                                  k_cap=192, p=_tparams(p))
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(got.in_range.numpy(),
                                  np.asarray(want.in_range))
    assert got.in_range.any()
    for name in RANGE_COUNTERS:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert int(want.spec_hits.sum()) > 0
    assert got.rounds == int(want.rounds)
    wd = np.asarray(want.dists)
    fin = np.isfinite(wd)
    np.testing.assert_array_equal(np.isfinite(got.dists.numpy()), fin)
    np.testing.assert_allclose(got.dists.numpy()[fin], wd[fin], atol=2.5e-4,
                               rtol=1e-6)


def test_range_rounds_follow_the_doubling(tds, small_data):
    """One round is a plain search at Γ; Γ stops doubling past k_cap,
    and the io of later rounds adds up (the visited mask carries)."""
    x, q = small_data
    qt = torch.as_tensor(q)
    p = _tparams(P_CONF)
    one = TDS.device_range_search(tds, qt, 1e9, k_cap=48, p=p, rounds=3)
    plain = TDS.device_anns(tds, qt, dataclasses.replace(p, k=48))
    assert torch.equal(one.io, plain.io) and one.rounds == plain.rounds
    assert torch.equal(one.ids, plain.ids)
    assert bool(one.in_range.all())
    two = TDS.device_range_search(tds, qt, 1e9, k_cap=96, p=p, rounds=3)
    assert bool((two.io >= one.io).all()) and two.rounds > one.rounds


# ------------------------------------------------------------ tier-0 repack

def test_repack_tier0_matches_jax(jds, tds, tseg, small_segment,
                                  queries):
    """The same observed demand re-packs the same blocks into the same
    slots; the port's results are the same before and after."""
    rho = small_segment.view.store.num_blocks
    observed = {b: (b * 7) % 11 for b in range(0, rho, 3)}
    jnew, jchanged = DS.repack_tier0(jds, small_segment, observed)
    tnew, tchanged = TDS.repack_tier0(tds, tseg, observed)
    assert tchanged == jchanged > 0
    np.testing.assert_array_equal(tnew.hot_slot_of.numpy(),
                                  np.asarray(jnew.hot_slot_of))
    for f in ("hot_vecs", "hot_vid", "hot_nbrs"):
        np.testing.assert_array_equal(getattr(tnew, f).numpy(),
                                      np.asarray(getattr(jnew, f)))
    assert TDS.hot_pack_blocks(tnew) == DS.hot_pack_blocks(jnew)
    qt = torch.as_tensor(queries)
    p = _tparams(P_CONF)
    before, after = TDS.device_anns(tds, qt, p), TDS.device_anns(tnew, qt, p)
    assert torch.equal(before.ids, after.ids)
    assert torch.equal(before.dists, after.dists)
    assert torch.equal(before.io + before.tier0_hits,
                       after.io + after.tier0_hits)
    plan = sorted(TDS.hot_pack_blocks(tds))[::-1]
    same, unchanged = TDS.repack_tier0(tds, tseg, {}, plan=plan)
    assert unchanged == 0
