"""The port's data, PQ, layout and synthetic-segment code against the
JAX package (``repro_torch.data``, ``repro_torch.pq``,
``repro_torch.io.hotset``)."""
import collections

import numpy as np
import pytest
import torch

from repro_torch.core.params import PQParams, SEGMENT_BENCH_DEVICE
from repro_torch.core.segment import segment_from_arrays
from repro_torch.data import synthetic as SY
from repro_torch.data.vectors import clustered_vectors, query_set
from repro_torch.io import hotset as TH
from repro_torch.pq.pq import encode_pq, train_pq


@pytest.mark.parametrize("n,dim,clusters,seed", [(500, 16, 8, 0),
                                                 (2500, 32, 24, 3)])
def test_vectors_identical_to_jax_package(n, dim, clusters, seed):
    from repro.data import vectors as JV
    x = clustered_vectors(n, dim, num_clusters=clusters, seed=seed)
    np.testing.assert_array_equal(
        x, JV.clustered_vectors(n, dim, num_clusters=clusters, seed=seed))
    for in_db in (False, True):
        np.testing.assert_array_equal(
            query_set(x, 24, in_db=in_db, seed=1),
            JV.query_set(x, 24, in_db=in_db, seed=1))


def test_pq_matches_jax():
    """Same sample, same initial centroids, same Lloyd steps: codebooks
    agree to float tolerance (f32 matmuls sum in another order) and the
    codes are equal."""
    from repro.pq import pq as JPQ
    from repro.core.params import PQParams as JPQParams
    x = clustered_vectors(3000, 32, num_clusters=12, seed=2)
    kw = dict(num_subspaces=8, num_centroids=64, train_iters=6,
              train_sample=2048, seed=0)
    cb = JPQ.train_pq(x, JPQParams(**kw))
    cent = train_pq(x, PQParams(**kw), device="cpu")
    np.testing.assert_allclose(cent, cb.centroids, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(encode_pq(x, cent, device="cpu"),
                                  JPQ.encode_pq(x, cb))


def test_layout_and_store_copies_match_jax():
    """``layout_bnp`` / ``_from_block_of`` / ``build_store`` equal the
    JAX package's on the same graph."""
    from repro.core import blockstore as JB
    from repro.core import graph as JG
    from repro.core import layout as JL
    rng = np.random.default_rng(0)
    n, deg_max, eps = 403, 8, 5
    adj = rng.integers(0, n, (n, deg_max)).astype(np.int32)
    deg = rng.integers(1, deg_max + 1, n).astype(np.int32)
    adj[np.arange(deg_max)[None, :] >= deg[:, None]] = -1
    g = JG.Graph(adj=adj, deg=deg, entry=0, metric="l2")
    want = JL.layout_bnp(g, eps)
    blocks, block_of, slot_of = SY.layout_bnp(adj, deg, eps)
    np.testing.assert_array_equal(blocks, want.blocks)
    np.testing.assert_array_equal(block_of, want.block_of)
    np.testing.assert_array_equal(slot_of, want.slot_of)
    x = rng.standard_normal((n, 12)).astype(np.float32)
    st = JB.build_store(x, g, want, 4.0)
    for got, w in zip(SY.build_store(x, adj, deg, blocks),
                      (st.vid, st.vecs, st.meta)):
        np.testing.assert_array_equal(got, w)


def test_hotset_copies_match_jax(small_segment):
    from repro.io import hotset as JH
    seg = small_segment
    v = seg.view
    args = (v.layout.block_of, seg.graph.adj, seg.graph.deg,
            JH.view_seed_ids(v))
    ranking = TH.hot_block_ranking(*args)
    assert ranking == JH.hot_block_ranking(*args)
    rho = v.store.num_blocks
    obs = {3: 5, 1: 5, 7: 1, rho + 4: 9}
    for budget in (0, 5, rho // 3, rho + 2):
        assert (TH.plan_tier0(ranking, obs, budget, rho)
                == JH.plan_tier0(ranking, obs, budget, rho))
        assert TH.fill_to(ranking, budget, rho) == JH.fill_to(ranking,
                                                             budget, rho)
    assert (TH.repack_from_frequencies(ranking, obs)
            == JH.repack_from_frequencies(ranking, obs))


def _reachable(adj, deg, entry):
    seen = np.zeros(adj.shape[0], bool)
    seen[entry] = True
    todo = collections.deque([entry])
    while todo:
        u = todo.popleft()
        for w in adj[u, : deg[u]]:
            if w >= 0 and not seen[w]:
                seen[w] = True
                todo.append(w)
    return seen


def test_synthetic_segment_is_a_valid_index():
    times = {}
    a = SY.synthetic_segment(1500, 32, seed=0, device="cpu", times=times)
    seg = segment_from_arrays(a, SEGMENT_BENCH_DEVICE)
    n = 1500
    assert set(times) == {"vectors_s", "disk_graph_s", "layout_store_s",
                          "pq_s", "nav_graph_s"}
    # layout: a bijection vertex <-> (block, slot)
    flat = seg.blocks[seg.blocks >= 0]
    np.testing.assert_array_equal(np.sort(flat), np.arange(n))
    np.testing.assert_array_equal(seg.blocks[seg.block_of, seg.slot_of],
                                  np.arange(n))
    assert seg.vid.shape[1] == SEGMENT_BENCH_DEVICE.layout.verts_per_block(
        32, 24)
    # disk graph: Λ = 24 out-edges each, every vertex reachable
    assert seg.adj.shape == (n, 24) and (seg.deg == 24).all()
    assert ((seg.adj >= 0) & (seg.adj < n)).all()
    assert _reachable(seg.adj, seg.deg, seg.entry).all()
    # store rows carry each vertex's vector and adjacency
    x = clustered_vectors(n, 32, seed=0)
    ok = seg.vid >= 0
    np.testing.assert_array_equal(seg.vecs[ok], x[seg.vid[ok]])
    np.testing.assert_array_equal(seg.meta[ok][:, 1:], seg.adj[seg.vid[ok]])
    # navigation graph: 10% sample, degree 12, reachable from its entry
    assert seg.nav_ids.shape[0] == 150 and seg.nav_adj.shape[1] == 12
    nav_deg = (seg.nav_adj >= 0).sum(1)
    assert _reachable(seg.nav_adj, nav_deg, seg.nav_entry).all()
    np.testing.assert_array_equal(seg.nav_vecs, x[seg.nav_ids])
    # PQ codes index real centroids
    assert seg.pq_codes.shape == (n, 8) and seg.pq_cent.shape == (8, 256, 4)


def test_synthetic_knn_edges_are_nearest():
    xt = torch.as_tensor(clustered_vectors(300, 8, seed=1))
    adj = SY.knn_graph(xt, 24, np.random.default_rng(0))
    d = torch.cdist(xt, xt).numpy()
    np.fill_diagonal(d, np.inf)
    want = np.sort(d, axis=1)[:, 19]
    got = np.take_along_axis(d, adj[:, :20].astype(np.int64), 1).max(1)
    np.testing.assert_allclose(got, want, rtol=1e-4)
