"""The port's host block search (``repro_torch.core.search``: ``anns``,
``range_search``) and the cache-fronted segment against the JAX
package's (``repro.core.search``, ``repro.core.segment``).

JAX's shared ``small_segment`` is carried across with ``save_segment``
-> ``repro_torch.core.segment.load_segment`` and searched by both
packages with each cache configuration: none, ``CacheParams(
budget_frac=0.10)``, ``SEGMENT_BENCH_ASYNC``'s tiered cache with its
8-deep fetch queue, and the ablations ``use_pq_routing=False`` and
``use_block_search=False``, and with a seeds override. On l2 the ids,
the distances and every per-query ``IOStats`` field are equal, and so
are the store's lifetime ``total`` and ``block_freq``. The port runs on
the CPU (``device="cpu"``: the plain ``pq_adc``, the navigation beam in
torch).

What makes the keys equal: ``pq.lut_host`` and ``pq_adc`` add their f32
terms in numpy's order (the JAX host search's ``adc_lut`` einsum and
``adc_distance`` sum), checked bit for bit on seeded float data here.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (the JAX package's import order)
from repro.configs.starling_segment import SEGMENT_BENCH_ASYNC
from repro.core import distances as JD
from repro.core import search as JS
from repro.core.params import CacheParams as JCP
from repro.core.segment import build_segment, save_segment
from repro.io import cached_view as j_cached_view
from repro.pq import pq as JPQ
from tests.conftest import SMALL_SEGMENT
from tests.test_torch_io import carry, tparams

from repro_torch.core import device_search as TDS
from repro_torch.core import params as TP
from repro_torch.core import search as TS
from repro_torch.core.segment import build_segment as t_build_segment
from repro_torch.core.segment import load_segment
from repro_torch.io.cached_store import CachedBlockStore
from repro_torch.io.cached_store import cached_view as t_cached_view
from repro_torch.kernels import ref as TR
from repro_torch.pq import pq as TPQ

CPU = "cpu"
CACHES = {
    "uncached": None,
    "cache_10": dict(budget_frac=0.10),
    "async_tiered": dataclasses.asdict(SEGMENT_BENCH_ASYNC.cache),
}
ABLATIONS = {"pq_routing_off": dict(use_pq_routing=False),
             "block_search_off": dict(use_block_search=False)}


@pytest.fixture(scope="module")
def pair(small_segment, tmp_path_factory):
    return small_segment, carry(small_segment, tmp_path_factory)


@pytest.fixture(scope="module")
def queries(small_data):
    return small_data[1]


def _views(pair, cache):
    jseg, tseg = pair
    if cache is None:
        return jseg.view, tseg.view
    return (j_cached_view(jseg.view, jseg.graph, JCP(**cache)),
            t_cached_view(tseg.view, tseg.graph, TP.CacheParams(**cache)))


def _same_stats(js, ts):
    assert len(js) == len(ts)
    for i, (a, b) in enumerate(zip(js, ts)):
        assert dataclasses.asdict(a) == dataclasses.asdict(b), i


def _same_store(jv, tv):
    if isinstance(tv.store, CachedBlockStore):
        assert (dataclasses.asdict(jv.store.total)
                == dataclasses.asdict(tv.store.total))
        assert dict(jv.store.block_freq) == dict(tv.store.block_freq)
        assert sorted(jv.store.cache.tier1.resident if hasattr(
            jv.store.cache, "tier1") else jv.store.cache.resident) == \
            sorted(tv.store.cache.tier1.resident if hasattr(
                tv.store.cache, "tier1") else tv.store.cache.resident)


@pytest.mark.parametrize("cache", list(CACHES), ids=list(CACHES))
def test_anns_equals_jax(pair, queries, cache):
    jv, tv = _views(pair, CACHES[cache])
    p = pair[0].params.search
    ji, jd, js = JS.anns(jv, queries, 10, p)
    ti, td, ts = TS.anns(tv, queries, 10, pair[1].params.search, device=CPU)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(td, jd)
    _same_stats(js, ts)
    _same_store(jv, tv)


@pytest.mark.parametrize("cache", list(CACHES), ids=list(CACHES))
def test_range_search_equals_jax(pair, queries, small_data, cache):
    x, _ = small_data
    radius = float(np.quantile(JD.pairwise(queries, x), 0.002))
    jv, tv = _views(pair, CACHES[cache])
    jr, js = JS.range_search(jv, queries, radius, pair[0].params.search)
    tr, ts = TS.range_search(tv, queries, radius, pair[1].params.search,
                             device=CPU)
    assert [r.tolist() for r in tr] == [r.tolist() for r in jr]
    assert sum(len(r) for r in tr) > 0
    _same_stats(js, ts)
    _same_store(jv, tv)
    gt = JD.brute_force_range(x, queries, radius)
    assert TS.average_precision(tr, gt) == JS.average_precision(jr, gt)


@pytest.mark.parametrize("ablation", list(ABLATIONS), ids=list(ABLATIONS))
def test_ablations_equal_jax(pair, queries, ablation):
    kw = ABLATIONS[ablation]
    jp = dataclasses.replace(pair[0].params.search, **kw)
    tp = dataclasses.replace(pair[1].params.search, **kw)
    jv, tv = _views(pair, CACHES["cache_10"])
    ji, jd, js = JS.anns(jv, queries, 10, jp)
    ti, td, ts = TS.anns(tv, queries, 10, tp, device=CPU)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(td, jd)
    _same_stats(js, ts)
    _same_store(jv, tv)


def test_seeds_override_equals_jax(pair, queries, small_data):
    """Explicit entry ids (-1 ignored; an all -1 row falls back to the
    navigation entries), as the hybrid router hands them over."""
    x, _ = small_data
    seeds = JD.brute_force_knn(x, queries + 0.5, 3).astype(np.int64)
    seeds[::3, 1:] = -1
    seeds[1] = -1
    jv, tv = _views(pair, CACHES["async_tiered"])
    ji, jd, js = JS.anns(jv, queries, 10, pair[0].params.search,
                         seeds=seeds)
    ti, td, ts = TS.anns(tv, queries, 10, pair[1].params.search,
                         seeds=seeds, device=CPU)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(td, jd)
    _same_stats(js, ts)
    _same_store(jv, tv)


def test_block_search_query_resumes_like_jax(pair, queries):
    """The range search's resume path: one query searched twice into the
    same candidate set, result set, kicked set and expanded set."""
    jseg, tseg = pair
    out = []
    for mod, view, p, kw in ((JS, jseg.view, jseg.params.search, {}),
                             (TS, tseg.view, tseg.params.search,
                              {"device": CPU})):
        c, r, k, e = mod._CandidateSet(8), {}, [], set()
        first = mod.block_search_query(view, queries[3], 5, p, cand=c,
                                       result=r, kicked=k, expanded=e, **kw)
        c.grow(16)
        second = mod.block_search_query(view, queries[3], 5, p, cand=c,
                                        result=r, kicked=k, expanded=e,
                                        **kw)
        out.append((first.ids.tolist(), second.ids.tolist(),
                    second.dists.tolist(),
                    dataclasses.asdict(second.stats), c.ids, c.keys,
                    sorted(e), k))
    assert out[0] == out[1]


def test_entry_points_batched_equal_per_query(pair, queries):
    """``anns`` computes the navigation entries for the whole batch in
    one call: each row equals the query's own call, and JAX's."""
    jseg, tseg = pair
    p = tseg.params.search
    batched = TS.entry_points(tseg.view, queries, p, CPU)
    assert batched.shape == (queries.shape[0], TS.NAV_ENTRIES)
    for qi in range(queries.shape[0]):
        one = TS.entry_points(tseg.view, queries[qi][None], p, CPU)[0]
        np.testing.assert_array_equal(batched[qi], one)
        np.testing.assert_array_equal(
            batched[qi], JS._entry_points(jseg.view, queries[qi],
                                          jseg.params.search))
    off = dataclasses.replace(p, use_nav_graph=False)
    np.testing.assert_array_equal(
        TS.entry_points(tseg.view, queries[:3], off, CPU),
        np.full((3, 1), tseg.entry))


# ------------------------------------------------------ the f32 orders

@pytest.mark.parametrize("dsub", [2, 4, 12, 16, 32, 40])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_lut_host_bit_equal_numpy(dsub, metric):
    """``lut_host`` (and the numpy API ``adc_lut`` / ``adc_lut_batch``
    over it) equals the JAX package's numpy LUTs bit for bit on seeded
    float data; the device search's in-order ``lut_batch`` does not."""
    rng = np.random.default_rng(dsub)
    m = 8
    cent = rng.standard_normal((m, 64, dsub)).astype(np.float32)
    q = rng.standard_normal((5, m * dsub)).astype(np.float32)
    jcb = JPQ.PQCodebook(cent, m * dsub, metric)
    tcb = TPQ.PQCodebook(cent, m * dsub, metric)
    want = JPQ.adc_lut_batch(q, jcb)
    got = TPQ.lut_host(torch.as_tensor(q), torch.as_tensor(cent),
                       metric).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(TPQ.adc_lut_batch(q, tcb, device=CPU),
                                  want)
    np.testing.assert_array_equal(TPQ.adc_lut(q[1], tcb, device=CPU),
                                  JPQ.adc_lut(q[1], jcb))
    if dsub >= 16:
        inorder = TPQ.lut_batch(torch.as_tensor(q), torch.as_tensor(cent),
                                metric).numpy()
        assert not np.array_equal(inorder, want)


@pytest.mark.parametrize("m", [2, 4, 8, 16, 32])
def test_pq_adc_order_bit_equal_numpy(m):
    """The plain ``pq_adc`` (the CUDA kernel's order, held equal to it
    on the card) adds the M lookups as numpy's ``sum`` does in the JAX
    host search's ``adc_distance``."""
    rng = np.random.default_rng(m)
    lut = rng.standard_normal((m, 256)).astype(np.float32) * 10
    codes = rng.integers(0, 256, (997, m)).astype(np.uint8)
    want = JPQ.adc_distance(lut, codes)
    got = TR.pq_adc_ref(torch.as_tensor(lut)[None],
                        torch.as_tensor(codes))[0].numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(
        TPQ.adc_distance(lut, codes, device=CPU), want)


def test_pairwise_sum_order():
    """numpy's pairwise order at every length up to 40 terms."""
    rng = np.random.default_rng(9)
    for n in range(1, 41):
        a = rng.standard_normal((300, n)).astype(np.float32) * 7
        got = TR.pairwise_sum([torch.as_tensor(a[:, j]) for j in range(n)])
        np.testing.assert_array_equal(got.numpy(), a.sum(axis=1), str(n))


def test_adc_distance_keeps_tensors_in_place():
    """A caller that keeps the LUT and codes on the device passes the
    tensors: the keys come back as numpy, equal to the numpy call."""
    rng = np.random.default_rng(2)
    lut = rng.standard_normal((8, 256)).astype(np.float32)
    codes = rng.integers(0, 256, (50, 8)).astype(np.uint8)
    lt, ct = torch.as_tensor(lut), torch.as_tensor(codes)
    got = TPQ.adc_distance(lt, ct[torch.arange(10, 30)], device=CPU)
    assert isinstance(got, np.ndarray) and got.shape == (20,)
    np.testing.assert_array_equal(got, TPQ.adc_distance(
        lut, codes[10:30], device=CPU))


# ----------------------------------------------------------- the segment

def test_segment_view_built_once(pair):
    """The view (and with it a cached store's state) is one object for
    the segment's life, over the segment's own arrays."""
    _, tseg = pair
    v = tseg.view
    assert tseg.view is v and v.store.vid is tseg.vid
    assert v.store.vecs is tseg.vecs and v.store.meta is tseg.meta
    assert v.pq_codes is tseg.pq_codes and v.entry == tseg.entry
    np.testing.assert_array_equal(v.nav.sample_ids, tseg.nav_ids)
    codes, cent = v.resident_codes(CPU)
    assert v.resident_codes(CPU)[0] is codes
    np.testing.assert_array_equal(codes.numpy(), tseg.pq_codes)


def test_cached_segment_memory_and_device_arrays(small_segment, tmp_path):
    """A segment loaded with a cache budget fronts its store with the
    cache, charges C_cache as JAX does, and ``from_segment`` reads the
    same arrays as from the uncached load."""
    params = dataclasses.replace(SMALL_SEGMENT, cache=JCP(
        budget_frac=0.10, tier0_frac=0.1))
    path = str(tmp_path / "seg.npz")
    save_segment(small_segment, path)
    from repro.core.segment import load_segment as j_load
    jseg = j_load(path, params)
    tseg = load_segment(path, tparams(params))
    plain = load_segment(path, tparams(SMALL_SEGMENT))
    assert isinstance(tseg.view.store, CachedBlockStore)
    assert not isinstance(plain.view.store, CachedBlockStore)
    assert tseg.memory_bytes() == jseg.memory_bytes()
    assert tseg.view.store.memory_bytes() == jseg.view.store.memory_bytes()
    assert tseg.check_budget() == jseg.check_budget()
    assert (tseg.memory_bytes() - plain.memory_bytes()
            == tseg.view.store.memory_bytes() + tseg.tier0_bytes())
    a = TDS.from_segment(tseg, tier0_frac=0.1, device=CPU)
    b = TDS.from_segment(plain, tier0_frac=0.1, device=CPU)
    for f in dataclasses.fields(a):
        assert torch.equal(getattr(a, f.name), getattr(b, f.name)), f.name
    assert sorted(tseg.view.store.cache.pinned) == sorted(
        jseg.view.store.cache.pinned)


def test_build_segment_with_cache(small_data):
    """``build_segment`` with a cache budget builds a cache-fronted view
    (it raised before the cache was ported); the search through it
    equals the uncached view's."""
    x, q = small_data
    xs = np.ascontiguousarray(x[:400, :16])
    p = TP.SegmentParams(
        graph=TP.GraphParams(max_degree=8, build_beam=16, algo="nsg"),
        layout=TP.LayoutParams(block_kb=0.5, shuffle="bnp"),
        pq=TP.PQParams(num_subspaces=4, train_iters=2, train_sample=400),
        nav=TP.NavGraphParams(sample_ratio=0.1, max_degree=6,
                              build_beam=12),
        cache=TP.CacheParams(budget_frac=0.2, policy="lfu",
                             prefetch_width=2))
    seg = t_build_segment(xs, p, device=CPU)
    assert isinstance(seg.view.store, CachedBlockStore)
    assert seg.view.store.cache.policy_name == "lfu"
    qs = np.ascontiguousarray(q[:6, :16])
    ci, cd, cs = TS.anns(seg.view, qs, 5, p.search, device=CPU)
    plain = dataclasses.replace(seg.view, store=seg.view.store.base)
    ui, ud, _ = TS.anns(plain, qs, 5, p.search, device=CPU)
    np.testing.assert_array_equal(ci, ui)
    np.testing.assert_array_equal(cd, ud)
    assert sum(s.cache_hits + s.cache_misses for s in cs) == sum(
        s.block_reads for s in cs)


def test_recall_and_ap_equal_jax():
    rng = np.random.default_rng(1)
    pred = rng.integers(-1, 30, (7, 10))
    truth = rng.integers(0, 30, (7, 10))
    assert TS.recall_at_k(pred, truth) == JS.recall_at_k(pred, truth)
    lists = [rng.integers(0, 30, rng.integers(0, 6)) for _ in range(7)]
    assert TS.average_precision(lists, lists[::-1]) == \
        JS.average_precision(lists, lists[::-1])
    assert TS.average_precision([], []) == 1.0


# ---------------------------------------------------------------- ip

IP_DIVERGED_QUERIES = 0     # l2-style equality held on every query


@pytest.fixture(scope="module")
def ip_pair(small_data, tmp_path_factory):
    x, _ = small_data
    jseg = build_segment(x, dataclasses.replace(SMALL_SEGMENT,
                                                metric="ip"))
    return jseg, carry(jseg, tmp_path_factory)


def test_ip_segment_anns_near_jax(ip_pair, queries):
    """ip through the cached view: the LUTs, keys and in-block distances
    follow JAX's orders, and the navigation entries come from the
    port's torch beam, whose ip distances differ from numpy's in the
    last bits. The queries whose ids or counters differ are counted and
    bounded (``IP_DIVERGED_QUERIES``); recall against the brute force
    is equal."""
    jv, tv = _views(ip_pair, CACHES["cache_10"])
    ji, jd, js = JS.anns(jv, queries, 10, ip_pair[0].params.search)
    ti, td, ts = TS.anns(tv, queries, 10, ip_pair[1].params.search,
                         device=CPU)
    diverged = [i for i in range(queries.shape[0])
                if not (np.array_equal(ti[i], ji[i])
                        and dataclasses.asdict(ts[i])
                        == dataclasses.asdict(js[i]))]
    assert len(diverged) <= IP_DIVERGED_QUERIES, diverged
    same = [i for i in range(queries.shape[0]) if i not in diverged]
    np.testing.assert_allclose(td[same], jd[same], rtol=1e-6, atol=1e-6)
    x_all = ip_pair[0].view.store.vecs[ip_pair[0].view.layout.block_of,
                                       ip_pair[0].view.layout.slot_of]
    truth = JD.brute_force_knn(x_all, queries, 10, metric="ip")
    assert TS.recall_at_k(ti, truth) == JS.recall_at_k(ji, truth)
