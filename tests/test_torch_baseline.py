"""The port's DiskANN-style baseline (``repro_torch.core.baseline``)
against the JAX package's (``repro.core.baseline``), on the CPU.

JAX's shared ``small_segment`` is carried across with ``save_segment``
-> ``repro_torch.core.segment.load_segment``. ``build_hot_cache`` must
give the same keys in the same order; ``vertex_anns`` and
``vertex_range_search`` the same ids, distances and every per-query
``IOStats`` field, with and without the hot cache and through a cached
view. The port runs at ``device="cpu"`` (the plain ``pq_adc``); its LUT
and ADC keys add their terms in numpy's orders, so the keys are JAX's
bits. Then the claims the JAX package's ``tests/test_search.py`` makes
about the baseline are replayed on the port.
"""
import dataclasses

import numpy as np
import pytest

import repro.core  # noqa: F401  (the JAX package's import order)
from repro.core import baseline as JB
from repro.core import distances as JD
from repro.core.params import CacheParams as JCP
from repro.core.segment import build_segment
from repro.io import cached_view as j_cached_view
from tests.conftest import SMALL_SEGMENT
from tests.test_torch_io import carry

from repro_torch.core import baseline as TB
from repro_torch.core import params as TP
from repro_torch.core import search as TS
from repro_torch.io.cached_store import cached_view as t_cached_view

CPU = "cpu"
HOT = {"cold": None, "hot_5": 0.05, "hot_20": 0.2}


@pytest.fixture(scope="module")
def pair(small_segment, tmp_path_factory):
    return small_segment, carry(small_segment, tmp_path_factory)


@pytest.fixture(scope="module")
def queries(small_data):
    return small_data[1]


@pytest.fixture(scope="module")
def truth(small_data):
    x, q = small_data
    return JD.brute_force_knn(x, q, 10)


def _base_params(seg):
    """The baseline's knobs in ``tests/test_search.py``: no block search,
    no navigation graph (the baseline starts at the medoid either way)."""
    return dataclasses.replace(seg.params.search, use_block_search=False,
                               use_nav_graph=False)


def _tsp(p):
    return TP.SearchParams(**dataclasses.asdict(p))


def _caches(pair, ratio):
    if ratio is None:
        return None, None
    jseg, tseg = pair
    return (JB.build_hot_cache(jseg.view, ratio=ratio),
            TB.build_hot_cache(tseg.view, ratio=ratio))


def _same_stats(js, ts):
    assert len(js) == len(ts)
    for i, (a, b) in enumerate(zip(js, ts)):
        assert dataclasses.asdict(a) == dataclasses.asdict(b), i


@pytest.mark.parametrize("ratio", [0.01, 0.05, 0.2])
def test_build_hot_cache_equals_jax(pair, ratio):
    jc, tc = _caches(pair, ratio)
    assert list(tc) == list(jc)
    assert len(tc) == int(ratio * pair[1].num_vectors)
    assert next(iter(tc)) == pair[1].entry


@pytest.mark.parametrize("hot", list(HOT), ids=list(HOT))
def test_vertex_anns_equals_jax(pair, queries, hot):
    jseg, tseg = pair
    jc, tc = _caches(pair, HOT[hot])
    p = _base_params(jseg)
    ji, jd, js = JB.vertex_anns(jseg.view, queries, 10, p, hot=jc)
    ti, td, ts = TB.vertex_anns(tseg.view, queries, 10, _tsp(p), hot=tc,
                                device=CPU)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(td, jd)
    _same_stats(js, ts)


@pytest.mark.parametrize("hot", ["cold", "hot_20"])
def test_vertex_range_search_equals_jax(pair, small_data, hot):
    x, q = small_data
    radius = float(np.quantile(JD.pairwise(q, x), 0.004))
    jseg, tseg = pair
    jc, tc = _caches(pair, HOT[hot])
    p = _base_params(jseg)
    jr, js = JB.vertex_range_search(jseg.view, q, radius, p, hot=jc)
    tr, ts = TB.vertex_range_search(tseg.view, q, radius, _tsp(p), hot=tc,
                                    device=CPU)
    assert len(tr) == len(jr)
    for a, b in zip(tr, jr):
        np.testing.assert_array_equal(a, b)
    _same_stats(js, ts)
    assert any(s.hops > 0 for s in ts)


def test_vertex_search_through_cached_view_equals_jax(pair, queries):
    """The baseline on a cache-fronted view: the same results, and the
    same cache state and lifetime counters as JAX's."""
    jseg, tseg = pair
    cache = dict(budget_frac=0.10)
    jv = j_cached_view(jseg.view, jseg.graph, JCP(**cache))
    tv = t_cached_view(tseg.view, tseg.graph, TP.CacheParams(**cache))
    p = _base_params(jseg)
    ji, jd, js = JB.vertex_anns(jv, queries[:8], 10, p)
    ti, td, ts = TB.vertex_anns(tv, queries[:8], 10, _tsp(p), device=CPU)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(td, jd)
    _same_stats(js, ts)
    assert (dataclasses.asdict(tv.store.total)
            == dataclasses.asdict(jv.store.total))
    assert dict(tv.store.block_freq) == dict(jv.store.block_freq)


# ---------------------------------------------------------------- ip

IP_DIVERGED_QUERIES = 0     # measured: every query equal


@pytest.fixture(scope="module")
def ip_pair(tmp_path_factory):
    from repro.data.vectors import clustered_vectors, query_set
    x = clustered_vectors(1200, 32, num_clusters=12, seed=5)
    jseg = build_segment(x, dataclasses.replace(SMALL_SEGMENT, metric="ip"))
    return jseg, carry(jseg, tmp_path_factory), query_set(x, 24, seed=1)


def test_ip_vertex_anns_near_jax(ip_pair):
    """An ip-built segment: the queries whose ids or counters differ
    from JAX's are counted and bounded (``IP_DIVERGED_QUERIES``); the
    other queries' distances are equal."""
    jseg, tseg, q = ip_pair
    p = _base_params(jseg)
    ji, jd, js = JB.vertex_anns(jseg.view, q, 10, p)
    ti, td, ts = TB.vertex_anns(tseg.view, q, 10, _tsp(p), device=CPU)
    diverged = [i for i in range(q.shape[0])
                if not (np.array_equal(ti[i], ji[i])
                        and dataclasses.asdict(ts[i])
                        == dataclasses.asdict(js[i]))]
    assert len(diverged) <= IP_DIVERGED_QUERIES, diverged
    same = [i for i in range(q.shape[0]) if i not in diverged]
    np.testing.assert_array_equal(td[same], jd[same])


# ------------------------------- the JAX package's claims, on the port

def test_block_search_beats_vertex_baseline_io(pair, queries, truth):
    """Tab. 2 (``tests/test_search.py``): Starling's vertex utilization
    is far above the baseline's 1/ε at comparable recall."""
    seg = pair[1]
    ids_s, _, st_s = TS.anns(seg.view, queries, 10, seg.params.search,
                             device=CPU)
    p_base = _tsp(_base_params(seg))
    ids_b, _, st_b = TB.vertex_anns(seg.view, queries, 10, p_base,
                                    device=CPU)
    xi_s = np.mean([s.vertex_utilization for s in st_s])
    xi_b = np.mean([s.vertex_utilization for s in st_b])
    eps = seg.view.store.verts_per_block
    assert xi_b == pytest.approx(1.0 / eps, abs=0.02)
    assert xi_s > 2.0 * xi_b
    assert (TS.recall_at_k(ids_s, truth)
            >= TS.recall_at_k(ids_b, truth) - 0.05)


def test_rs_cheaper_than_repeated_anns(pair, small_data):
    """§5.3: the native range search reads fewer blocks than the
    baseline's repeated ANNS."""
    x, q = small_data
    radius = float(np.quantile(JD.pairwise(q, x), 0.004))
    seg = pair[1]
    _, st_rs = TS.range_search(seg.view, q, radius, seg.params.search,
                               device=CPU)
    _, st_rep = TB.vertex_range_search(seg.view, q, radius,
                                       _tsp(_base_params(seg)), device=CPU)
    assert (np.mean([s.block_reads for s in st_rs])
            < np.mean([s.block_reads for s in st_rep]))


def test_hot_cache_reduces_baseline_io(pair, queries):
    """The hot cache changes no result and raises no query's reads."""
    seg = pair[1]
    p = _tsp(_base_params(seg))
    hot = TB.build_hot_cache(seg.view, ratio=0.2)
    ic, dc, st_cold = TB.vertex_anns(seg.view, queries, 10, p, device=CPU)
    ih, dh, st_hot = TB.vertex_anns(seg.view, queries, 10, p, hot=hot,
                                    device=CPU)
    np.testing.assert_array_equal(ih, ic)
    np.testing.assert_array_equal(dh, dc)
    assert all(h.block_reads <= c.block_reads
               for h, c in zip(st_hot, st_cold))
    assert (np.mean([s.block_reads for s in st_hot])
            < np.mean([s.block_reads for s in st_cold]))
