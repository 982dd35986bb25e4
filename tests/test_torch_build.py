"""The port's segment build (``repro_torch.core``: graph, layout,
navgraph, blockstore, segment; ``repro_torch.pq``) against the JAX
package's, on the CPU.

  * Integer-valued vectors (coordinates in [-8, 8]): every f32 distance
    is exact in both packages, so every build step must equal JAX's bit
    for bit, tie order included.
  * Given JAX's own graph, the layouts are integer work and must equal
    JAX's exactly.
  * Float data (the shared ``small_data`` fixture, ``SMALL_SEGMENT``): f32 sums
    run in another order, so the builds must agree on >= 99% of the
    adjacency rows, OR(G) within 0.01 and recall@10 within 0.01.
  * A port-built segment loads in the JAX package and serves the same
    ids there.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import blockstore as JB
from repro.core import device_search as JDS
from repro.core import distances as JD
from repro.core import graph as JG
from repro.core import layout as JL
from repro.core import navgraph as JN
from repro.core import segment as JS
from repro.core.params import DeviceSearchParams as JDP
from repro.core.params import GraphParams as JGP
from repro.core.params import NavGraphParams as JNP
from repro.core.search import recall_at_k
from repro.pq import pq as JPQ

from repro_torch.core import blockstore as TB
from repro_torch.core import device_search as TDS
from repro_torch.core import graph as TG
from repro_torch.core import layout as TL
from repro_torch.core import navgraph as TN
from repro_torch.core import params as TP
from repro_torch.configs import starling_segment as TSS
from repro_torch.core import segment as TS
from repro_torch.pq import pq as TPQ

CPU = "cpu"
GP = dict(max_degree=12, build_beam=24, insert_batch=64)


def _ints(n, d, seed):
    return np.random.default_rng(seed).integers(-8, 9, (n, d)).astype(
        np.float32)


def _tgraph(g):
    return TG.Graph(adj=g.adj, deg=g.deg, entry=g.entry, metric=g.metric)


def _same_graph(got, want):
    np.testing.assert_array_equal(got.adj, want.adj)
    np.testing.assert_array_equal(got.deg, want.deg)
    assert got.entry == want.entry


def _t_segment_params(jp):
    """The JAX ``SegmentParams`` values in the port's dataclasses."""
    return TP.SegmentParams(
        graph=TP.GraphParams(**dataclasses.asdict(jp.graph)),
        layout=TP.LayoutParams(**dataclasses.asdict(jp.layout)),
        pq=TP.PQParams(**dataclasses.asdict(jp.pq)),
        nav=TP.NavGraphParams(**dataclasses.asdict(jp.nav)),
        budget=TP.SegmentBudget(**dataclasses.asdict(jp.budget)),
        metric=jp.metric)


@pytest.fixture(scope="module")
def xi():
    return _ints(800, 16, seed=0)


@pytest.fixture(scope="module")
def jax_nsg(xi):
    return JG.build_nsg(xi, JGP(algo="nsg", **GP))


@pytest.fixture(scope="module")
def jax_vamana(xi):
    return JG.build_vamana(xi, JGP(**GP))


# ------------------------------------------------------ integer data

@pytest.mark.parametrize("alpha", [1.0, 1.2])
@pytest.mark.parametrize("seed", range(4))
def test_robust_prune_equals_jax(xi, alpha, seed):
    rng = np.random.default_rng(seed)
    u = int(rng.integers(xi.shape[0]))
    cand = rng.integers(0, xi.shape[0], 70)
    cand[:3] = u                                    # u itself and repeats
    cand[10:14] = cand[20]
    dist = ((xi[cand] - xi[u]) ** 2).sum(1).astype(np.float32)
    want = JG.robust_prune(u, cand.astype(np.int32), dist, xi, 12, alpha)
    got = TG.robust_prune(u, cand, dist, xi, 12, alpha, device=CPU)
    np.testing.assert_array_equal(got, want)


def test_robust_prune_batch_rows_equal_single_prunes(xi):
    rng = np.random.default_rng(7)
    u = rng.integers(0, xi.shape[0], 9)
    cand = rng.integers(-1, xi.shape[0], (9, 40))
    dist = ((xi[np.maximum(cand, 0)] - xi[u][:, None]) ** 2).sum(-1).astype(
        np.float32)
    sel, cnt = TG.robust_prune_batch(
        torch.as_tensor(u), torch.as_tensor(cand), torch.as_tensor(dist),
        torch.as_tensor(xi), 12, 1.2)
    for i in range(9):
        ok = cand[i] >= 0
        want = JG.robust_prune(int(u[i]), cand[i][ok].astype(np.int32),
                               dist[i][ok], xi, 12, 1.2)
        np.testing.assert_array_equal(sel[i, : int(cnt[i])].numpy(), want)
        assert (sel[i, int(cnt[i]):] == -1).all()


def test_greedy_search_equals_jax(xi, jax_nsg):
    q = _ints(40, 16, seed=3)
    ij, dj, vj = JG.greedy_search_batch(xi, jax_nsg.adj, jax_nsg.deg,
                                        jax_nsg.entry, q, beam=16)
    it, dt, vt = TG.greedy_search_batch(
        torch.as_tensor(xi), torch.as_tensor(jax_nsg.adj), jax_nsg.deg,
        jax_nsg.entry, torch.as_tensor(q), beam=16)
    np.testing.assert_array_equal(it.numpy(), ij)
    np.testing.assert_array_equal(dt.numpy(), dj)
    ids, dd = vt.ids.numpy(), vt.dists.numpy()
    for b, (c, want) in enumerate(zip(vt.count.tolist(), vj)):
        assert list(zip(ids[b, :c].tolist(), dd[b, :c].tolist())) == \
            list(want.items())                           # visited order


def test_build_nsg_equals_jax(xi, jax_nsg):
    stats = {}
    got = TG.build_nsg(xi, TP.GraphParams(algo="nsg", **GP), device=CPU,
                       stats=stats)
    _same_graph(got, jax_nsg)
    assert stats["attached"] >= 0 and stats["knn_s"] >= 0


def test_build_vamana_equals_jax(xi, jax_vamana):
    _same_graph(TG.build_vamana(xi, TP.GraphParams(**GP), device=CPU),
                jax_vamana)


def test_ensure_reachable_on_cut_graph(xi, jax_nsg):
    """Cut every in-edge of 60 vertices and let both packages reconnect.
    JAX ranks hosts with numpy's unstable argsort, the port stably (ties
    by id), so on exact ties the two may pick different hosts: the port
    is held to reachability and the degree bound, and to JAX's result
    where no tie decided."""
    rng = np.random.default_rng(5)
    cut = rng.choice(xi.shape[0], 60, replace=False)
    adj = jax_nsg.adj.copy()
    adj[np.isin(adj, cut)] = -1
    deg = np.zeros_like(jax_nsg.deg)
    for u in range(adj.shape[0]):                   # compact the rows
        row = adj[u][adj[u] >= 0]
        adj[u] = -1
        adj[u, : row.size] = row
        deg[u] = row.size
    gj = JG.Graph(adj=adj.copy(), deg=deg.copy(), entry=jax_nsg.entry)
    gt = TG.Graph(adj=adj.copy(), deg=deg.copy(), entry=jax_nsg.entry)
    JG._ensure_reachable(xi, gj)
    n_att = TG._ensure_reachable(xi, gt, device=CPU)
    assert n_att >= 1
    assert TG._reachable(gt).all()
    assert (gt.deg <= gt.max_degree).all()
    live = np.arange(gt.max_degree)[None, :] < gt.deg[:, None]
    assert not (gt.adj == np.arange(gt.num_vertices)[:, None])[live].any()
    same_rows = (gt.adj == gj.adj).all(1).mean()
    assert same_rows >= 0.95, f"only {same_rows:.3f} of rows equal JAX's"


def test_ensure_reachable_equals_jax_on_float_data():
    """No ties on float data: the connectivity fix equals JAX's."""
    from repro.data.vectors import clustered_vectors
    x = clustered_vectors(1500, 16, seed=2)
    want = JG.build_nsg(x, JGP(max_degree=16, build_beam=32, algo="nsg"))
    stats = {}
    got = TG.build_nsg(x, TP.GraphParams(max_degree=16, build_beam=32,
                                         algo="nsg"), device=CPU, stats=stats)
    assert stats["attached"] > 0
    _same_graph(got, want)


@pytest.mark.parametrize("eps", [3, 5])
def test_layouts_equal_jax(jax_vamana, eps):
    tg = _tgraph(jax_vamana)
    for scheme in ("none", "bnp"):
        np.testing.assert_array_equal(
            TL.make_layout(tg, eps, scheme).blocks,
            JL.make_layout(jax_vamana, eps, scheme).blocks)
    for gain_order in (False, True):
        want, wh = JL.layout_bnf(jax_vamana, eps, iters=4, tau=-1.0,
                                 gain_order=gain_order)
        got, gh = TL.layout_bnf(tg, eps, iters=4, tau=-1.0,
                                gain_order=gain_order)
        for f in ("blocks", "block_of", "slot_of"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        assert gh == wh
    lay = TL.make_layout(tg, eps, "gp3", bnf_iters=3, tau=0.001)
    np.testing.assert_array_equal(
        lay.blocks, JL.make_layout(jax_vamana, eps, "gp3", bnf_iters=3,
                                   tau=0.001).blocks)
    lay.validate()
    assert TL.overlap_ratio(tg, lay) == JL.overlap_ratio(
        jax_vamana, JL.BlockLayout(lay.blocks, lay.block_of, lay.slot_of))
    assert lay.mapping_bytes() == 2 * 4 * tg.num_vertices


def test_layout_on_jax_small_segment_graph(small_segment):
    """The layout is integer work: on JAX's own float-data graph the
    port's BNF equals JAX's exactly."""
    g = small_segment.graph
    eps = small_segment.view.layout.verts_per_block
    p = small_segment.params.layout
    got = TL.make_layout(_tgraph(g), eps, p.shuffle, bnf_iters=p.bnf_iters,
                         tau=p.gain_tau)
    np.testing.assert_array_equal(got.blocks,
                                  small_segment.view.layout.blocks)
    np.testing.assert_array_equal(got.slot_of,
                                  small_segment.view.layout.slot_of)


def _same_layout(got, want):
    for f in ("blocks", "block_of", "slot_of"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)


def _random_graph(n, deg, seed):
    """``tests/test_layout.py``'s random graph (no self-loops)."""
    rng = np.random.default_rng(seed)
    adj = np.full((n, deg), -1, np.int32)
    degs = rng.integers(1, deg + 1, size=n).astype(np.int32)
    for u in range(n):
        nbrs = rng.choice(n - 1, size=degs[u], replace=False)
        nbrs[nbrs >= u] += 1
        adj[u, : degs[u]] = nbrs
    return adj, degs


@pytest.mark.parametrize("seed", range(3))
def test_layout_bns_lemma42_equals_jax(seed):
    """Lemma 4.2 as ``tests/test_layout.py`` runs it: OR(G) never falls
    across BNS's rounds, and the port's swaps are JAX's."""
    adj, degs = _random_graph(60, 5, seed + 3)
    want, wh = JL.layout_bns(JG.Graph(adj=adj, deg=degs, entry=0), eps=4,
                             iters=3, tau=-1.0)
    got, gh = TL.layout_bns(TG.Graph(adj=adj, deg=degs, entry=0), eps=4,
                            iters=3, tau=-1.0)
    _same_layout(got, want)
    assert gh == wh
    assert all(b >= a - 1e-9 for a, b in zip(gh, gh[1:]))


def test_layout_bns_equals_jax(jax_vamana):
    want, wh = JL.layout_bns(jax_vamana, 4, iters=1, tau=-1.0)
    got, gh = TL.layout_bns(_tgraph(jax_vamana), 4, iters=1, tau=-1.0)
    _same_layout(got, want)
    assert gh == wh and gh[1] >= gh[0]
    got.validate()


def test_make_layout_bns_equals_jax(jax_vamana):
    """``make_layout("bns")`` seeds BNS with BNF's layout; its history is
    BNF's, then BNS's rounds."""
    kw = dict(bnf_iters=2, bns_iters=1, tau=0.001)
    hist = []
    got = TL.make_layout(_tgraph(jax_vamana), 5, "bns", history=hist,
                         device=CPU, **kw)
    _same_layout(got, JL.make_layout(jax_vamana, 5, "bns", **kw))
    _, bnf_hist = JL.layout_bnf(jax_vamana, 5, iters=2, tau=0.001)
    assert hist[: len(bnf_hist)] == bnf_hist
    assert len(hist) == len(bnf_hist) + 1
    assert hist[-1] == JL.overlap_ratio(jax_vamana, JL.BlockLayout(
        got.blocks, got.block_of, got.slot_of)) >= max(bnf_hist)


@pytest.mark.parametrize("eps", [3, 5])
def test_layout_kmeans_equals_jax_on_integer_data(xi, jax_vamana, eps,
                                                  monkeypatch):
    want = JL.layout_kmeans(xi, jax_vamana, eps)
    tg = _tgraph(jax_vamana)
    _same_layout(TL.layout_kmeans(xi, tg, eps, device=CPU), want)
    # row chunks of the assignment change no bit (37 rows a chunk)
    k = max(-(-xi.shape[0] // eps) // 4, 1)
    with monkeypatch.context() as mp:
        mp.setitem(TL._KMEANS_ELEMS, "cpu", 37 * k)
        _same_layout(TL.layout_kmeans(xi, tg, eps, device=CPU), want)
    hist = []
    lay = TL.make_layout(tg, eps, "kmeans", x=xi, history=hist, device=CPU)
    _same_layout(lay, JL.make_layout(jax_vamana, eps, "kmeans", x=xi))
    lay.validate()
    assert hist == [TL.overlap_ratio(tg, lay)]
    with pytest.raises(ValueError):
        TL.make_layout(tg, eps, "kmeans", device=CPU)


@pytest.mark.parametrize("seed", range(3))
def test_cluster_means_bits_equal_mask_form(seed):
    """The centroid update from one stable sort gives the bits of JAX's
    per-cluster boolean mask, empty clusters left as they were."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3000, 24)).astype(np.float32) * 7.3
    k = 120
    assign = rng.integers(0, k, 3000)
    assign[assign == 17] = 18                         # an empty cluster
    init = rng.standard_normal((k, 24)).astype(np.float32)
    want = init.copy()
    for c in range(k):
        m = assign == c
        if m.any():
            want[c] = x[m].mean(axis=0)
    got = init.copy()
    TL.cluster_means(x, assign, got)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


# the share of float-data k-means assignments equal to JAX's (measured
# 1.0 on both cases below; JAX's numpy matmul and the plain l2_tile sum
# in other orders, so only a near-tie may go the other way)
KMEANS_FLOAT_AGREE = 0.999


@pytest.mark.parametrize("case", ["clustered", "gaussian"])
def test_kmeans_assign_on_float_data_near_jax(case):
    """One assignment step from the same centroids, then the whole
    packer: every disagreement with JAX's ``argmin(pairwise)`` is a
    near-tie (its two distances within 1e-5 relative), and the share of
    equal assignments and block ids is bounded below."""
    from repro.data.vectors import clustered_vectors
    rng = np.random.default_rng(4)
    x = (clustered_vectors(3000, 32, num_clusters=16, seed=4)
         if case == "clustered"
         else rng.standard_normal((3000, 32)).astype(np.float32))
    cent = x[rng.choice(3000, 150, replace=False)]
    dj = JD.pairwise(x, cent)
    want = np.argmin(dj, axis=1)
    got = TL.kmeans_assign(torch.as_tensor(x), cent)
    off = np.flatnonzero(got != want)
    assert (got == want).mean() >= KMEANS_FLOAT_AGREE
    a, b = dj[off, got[off]], dj[off, want[off]]
    assert np.all(np.abs(a - b) <= 1e-5 * np.maximum(np.abs(b), 1.0))
    adj, degs = _random_graph(3000, 4, 0)
    g = JG.Graph(adj=adj, deg=degs, entry=0)
    lw = JL.layout_kmeans(x, g, 6, iters=4)
    lg = TL.layout_kmeans(x, TG.Graph(adj=adj, deg=degs, entry=0), 6,
                          iters=4, device=CPU)
    assert (lg.block_of == lw.block_of).mean() >= KMEANS_FLOAT_AGREE


@pytest.fixture(scope="module")
def jax_hnsw(xi):
    return JG.build_hnsw(xi, JGP(algo="hnsw", **GP))


def test_build_hnsw_equals_jax(xi, jax_hnsw):
    """Level sets from the same generator, Vamana at level 0 (800 > 512
    vertices) and NSG above, each layer equal to JAX's."""
    got = TG.build_hnsw(xi, TP.GraphParams(algo="hnsw", **GP), device=CPU)
    assert len(got.layers) == len(jax_hnsw.layers) >= 3
    for lg, lw, ig, iw in zip(got.layers, jax_hnsw.layers, got.level_ids,
                              jax_hnsw.level_ids):
        np.testing.assert_array_equal(ig, iw)
        _same_graph(lg, lw)
    sizes = [ids.size for ids in got.level_ids]
    assert sizes == sorted(sizes, reverse=True)
    assert got.base.max_degree == GP["max_degree"]
    assert got.layers[1].max_degree == GP["max_degree"] // 2
    base = TG.build_graph(xi, TP.GraphParams(algo="hnsw", **GP), device=CPU)
    _same_graph(base, jax_hnsw.base)


@pytest.mark.parametrize("upper", [True, False])
def test_from_hnsw_layers_equals_jax(xi, jax_hnsw, upper):
    """The level-1 layer as the navigation graph, or, with no upper
    layer (every level 0), the NSG sample."""
    p = dict(sample_ratio=0.25, max_degree=8, build_beam=16, seed=3)
    h = jax_hnsw if upper else JG.build_hnsw(
        xi[:300], JGP(algo="hnsw", **GP), level_mult=1e-9)
    xs = xi if upper else xi[:300]
    th = TG.HNSWGraph(layers=[_tgraph(g) for g in h.layers],
                      level_ids=h.level_ids, metric=h.metric)
    assert len(th.layers) == (3 if upper else 1)
    want = JN.from_hnsw_layers(xs, h, JNP(**p))
    got = TN.from_hnsw_layers(xs, th, TP.NavGraphParams(**p), device=CPU)
    np.testing.assert_array_equal(got.sample_ids, want.sample_ids)
    np.testing.assert_array_equal(got.vectors, want.vectors)
    _same_graph(got.graph, want.graph)
    q = _ints(20, 16, seed=9)
    np.testing.assert_array_equal(got.entry_points(q, 12, 4, device=CPU),
                                  want.entry_points(q, 12, 4))


def _t_params_all(jp):
    """Every field of a JAX ``SegmentParams`` in the port's classes."""
    return TP.SegmentParams(**{
        f.name: (getattr(TP, type(v).__name__)(**dataclasses.asdict(v))
                 if dataclasses.is_dataclass(v) else v)
        for f in dataclasses.fields(jp)
        for v in [getattr(jp, f.name)]})


def _same_segment(got, want):
    """The port's ``Segment`` against a JAX one, stage by stage."""
    _same_graph(got.graph, want.graph)
    _same_layout(got.layout, want.view.layout)
    for f in ("vid", "vecs", "meta"):
        np.testing.assert_array_equal(getattr(got, f),
                                      getattr(want.view.store, f), err_msg=f)
    nav = want.view.nav
    np.testing.assert_array_equal(got.nav_ids, nav.sample_ids)
    np.testing.assert_array_equal(got.nav_vecs, nav.vectors)
    np.testing.assert_array_equal(got.nav_adj, nav.graph.adj)
    np.testing.assert_array_equal(got.nav_deg, nav.graph.deg)
    assert got.nav_entry == nav.graph.entry
    np.testing.assert_array_equal(got.pq_codes, want.view.pq_codes)
    np.testing.assert_allclose(got.pq_cent, want.view.pq_cb.centroids,
                               rtol=1e-5, atol=1e-5)
    assert got.overlap_ratio == pytest.approx(want.overlap_ratio, abs=1e-6)
    assert got.memory_bytes() == want.memory_bytes()


INT_SEGMENT = dict(
    graph=dict(max_degree=12, build_beam=24, insert_batch=64),
    layout=dict(block_kb=0.5, shuffle="bnf", bnf_iters=3, bns_iters=1,
                gain_tau=0.001),
    pq=dict(num_subspaces=4, num_centroids=32, train_iters=4,
            train_sample=400),
    nav=dict(sample_ratio=0.25, max_degree=8, build_beam=16))


def int_segment_params(algo="vamana", shuffle="bnf"):
    """Small JAX ``SegmentParams`` for integer data of width 16 (ε = 4)."""
    from repro.core import params as JP
    kw = {k: dict(v) for k, v in INT_SEGMENT.items()}
    kw["graph"]["algo"] = algo
    kw["layout"]["shuffle"] = shuffle
    return JP.SegmentParams(
        graph=JGP(**kw["graph"]), layout=JP.LayoutParams(**kw["layout"]),
        pq=JP.PQParams(**kw["pq"]), nav=JNP(**kw["nav"]))


@pytest.mark.parametrize("algo,shuffle", [("hnsw", "bnf"),
                                          ("vamana", "bns"),
                                          ("vamana", "kmeans")])
def test_build_segment_variants_equal_jax(algo, shuffle):
    """``build_segment`` through HNSW's base layer, BNS and the k-means
    packer on integer data: every stage equal to JAX's."""
    x = _ints(400, 16, seed=1)
    jp = int_segment_params(algo, shuffle)
    want = JS.build_segment(x, jp)
    got = TS.build_segment(x, _t_params_all(jp), device=CPU)
    _same_segment(got, want)
    hist = got.build_info["or_history"]
    assert got.overlap_ratio == pytest.approx(max(hist))
    if shuffle == "bns":
        assert hist[-1] >= max(hist[:-1])           # Lemma 4.2 on BNF's


def test_navgraph_equals_jax(xi):
    p = dict(sample_ratio=0.25, max_degree=8, build_beam=16, seed=3)
    want = JN.build_navgraph(xi, JNP(**p), algo="nsg")
    got = TN.build_navgraph(xi, TP.NavGraphParams(**p), algo="nsg",
                            device=CPU)
    np.testing.assert_array_equal(got.sample_ids, want.sample_ids)
    np.testing.assert_array_equal(got.vectors, want.vectors)
    _same_graph(got.graph, want.graph)
    assert got.memory_bytes() == want.memory_bytes()
    q = _ints(30, 16, seed=9)
    np.testing.assert_array_equal(got.entry_points(q, 12, 4, device=CPU),
                                  want.entry_points(q, 12, 4))


def test_build_store_equals_jax(xi, jax_vamana):
    lay = JL.layout_bnp(jax_vamana, 5)
    want = JB.build_store(xi, jax_vamana, lay, 1.0)
    got = TB.build_store(xi, _tgraph(jax_vamana), TL.BlockLayout(
        lay.blocks, lay.block_of, lay.slot_of), 1.0)
    for f in ("vid", "vecs", "meta"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.vertex_bytes() == want.vertex_bytes()
    assert got.disk_bytes() == want.disk_bytes()


def test_adc_equals_jax():
    """The JAX API on integer data (every f32 sum exact): numpy LUTs and
    distances, equal to JAX's, for one query and for a batch."""
    rng = np.random.default_rng(4)
    cent = rng.integers(-4, 5, (4, 32, 4)).astype(np.float32)
    q = rng.integers(-4, 5, (9, 16)).astype(np.float32)
    codes = rng.integers(0, 32, (50, 4)).astype(np.uint8)
    for metric in ("l2", "ip"):
        cbj = JPQ.PQCodebook(cent, 16, metric)
        cbt = TPQ.PQCodebook(cent, 16, metric)
        luts = JPQ.adc_lut_batch(q, cbj)
        got = TPQ.adc_lut_batch(q, cbt, device=CPU)
        assert isinstance(got, np.ndarray) and got.dtype == np.float32
        np.testing.assert_array_equal(got, luts)
        one = TPQ.adc_lut(q[2], cbt, device=CPU)
        assert isinstance(one, np.ndarray)
        np.testing.assert_array_equal(one, JPQ.adc_lut(q[2], cbj))
        dist = TPQ.adc_distance(luts[2], codes, device=CPU)
        assert isinstance(dist, np.ndarray) and dist.shape == (50,)
        np.testing.assert_array_equal(dist, JPQ.adc_distance(luts[2], codes))
    np.testing.assert_array_equal(TPQ.reconstruct(codes, cbt),
                                  JPQ.reconstruct(codes, cbj))


# ------------------------------------------------------- float data

@pytest.fixture(scope="module")
def t_segment(small_data, small_segment):
    x, _ = small_data
    return TS.build_segment(x, _t_segment_params(small_segment.params),
                            device=CPU)


def test_build_segment_agrees_with_jax(small_segment, t_segment):
    seg = t_segment
    adj_rows = (seg.adj == small_segment.graph.adj).all(1).mean()
    assert adj_rows >= 0.99
    assert abs(seg.overlap_ratio - small_segment.overlap_ratio) <= 0.01
    assert set(seg.build_times) == {"disk_graph_s", "shuffling_s",
                                    "memory_graph_s", "pq_s"}
    # BNF keeps its best layout: OR(G) is the history's maximum
    assert seg.overlap_ratio == pytest.approx(max(
        seg.build_info["or_history"]))
    assert seg.memory_bytes() == small_segment.memory_bytes()
    assert seg.disk_bytes() == small_segment.disk_bytes()
    assert seg.check_budget() == small_segment.check_budget()
    seg.layout.validate()


def test_built_segment_recall_matches_jax(small_data, small_segment,
                                          t_segment):
    """200 queries through each package's device search (JAX on its
    plain ``jnp`` round, the port on its plain versions)."""
    from repro.data.vectors import query_set
    x, _ = small_data
    q = query_set(x, 200, seed=11)
    oracle = JD.brute_force_knn(x, q, 10)
    jp = JDP(k=10, candidates=48, max_hops=64, fetch_width=2,
             fetch_impl="jnp")
    jr = JDS.device_anns(JDS.from_segment(small_segment), jnp.asarray(q), jp)
    tp = TP.DeviceSearchParams(k=10, candidates=48, max_hops=64,
                               fetch_width=2, fetch_impl="ref")
    tr = TDS.device_anns(TDS.from_segment(t_segment, device=CPU),
                         torch.as_tensor(q), tp)
    rj = recall_at_k(np.asarray(jr.ids), oracle)
    rt = recall_at_k(tr.ids.numpy(), oracle)
    assert abs(rj - rt) <= 0.01, (rj, rt)


def test_port_built_segment_serves_in_jax(small_data, t_segment, tmp_path):
    """Save with the port, load with the JAX package, serve the same ids
    through JAX ``device_anns``."""
    x, q = small_data
    path = str(tmp_path / "seg.npz")
    TS.save_segment(t_segment, path)
    jseg = JS.load_segment(path, dataclasses.replace(
        JS.SegmentParams(), metric="l2"))
    assert jseg.overlap_ratio == pytest.approx(t_segment.overlap_ratio)
    np.testing.assert_array_equal(jseg.view.nav.graph.deg, t_segment.nav_deg)
    jp = JDP(k=10, candidates=48, max_hops=64, fetch_width=2,
             fetch_impl="jnp")
    jr = JDS.device_anns(JDS.from_segment(jseg), jnp.asarray(q), jp)
    tp = TP.DeviceSearchParams(k=10, candidates=48, max_hops=64,
                               fetch_width=2, fetch_impl="ref")
    tr = TDS.device_anns(TDS.from_segment(TS.load_segment(path),
                                          device=CPU), torch.as_tensor(q), tp)
    np.testing.assert_array_equal(tr.ids.numpy(), np.asarray(jr.ids))


def test_build_segment_refuses_the_host_cache(small_data):
    """The host block cache is ported: where ``build_segment`` refused a
    cache budget, it now fronts the view's store with the cache
    (``io.cached_store``) and charges its budget as C_cache."""
    from repro_torch.io.cached_store import CachedBlockStore
    x, _ = small_data
    p = dataclasses.replace(TSS.SEGMENT_BENCH,
                            cache=TP.CacheParams(budget_frac=0.1))
    seg = TS.build_segment(x[:100], p, device=CPU)
    store = seg.view.store
    assert isinstance(store, CachedBlockStore)
    assert store.memory_bytes() == int(0.1 * seg.disk_bytes())
    plain = dataclasses.replace(seg, view=dataclasses.replace(
        seg.view, store=store.base))
    assert seg.memory_bytes() == plain.memory_bytes() + store.memory_bytes()
