"""The port's data, PQ, layout and hot-set code against the JAX package
(``repro_torch.data``, ``repro_torch.pq``, ``repro_torch.core.layout``
and ``blockstore``, ``repro_torch.io.hotset``)."""
import numpy as np
import pytest

from repro_torch.core import blockstore as TB
from repro_torch.core import graph as TG
from repro_torch.core import layout as TL
from repro_torch.core.params import PQParams
from repro_torch.data.vectors import clustered_vectors, query_set
from repro_torch.io import hotset as TH
from repro_torch.pq.pq import PQCodebook, encode_pq, train_pq


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


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_pq_matches_jax(metric):
    """Same sample, same initial centroids, same Lloyd steps: codebooks
    agree to float tolerance (f32 matmuls sum in another order) and the
    codes are equal. Both packages are called the JAX way (the metric
    third, positional), the port with its trailing ``device``."""
    from repro.pq import pq as JPQ
    from repro.core.params import PQParams as JPQParams
    x = clustered_vectors(3000, 32, num_clusters=12, seed=2)
    kw = dict(num_subspaces=8, num_centroids=64, train_iters=6,
              train_sample=2048, seed=0)
    cb = JPQ.train_pq(x, JPQParams(**kw), metric)
    tcb = train_pq(x, PQParams(**kw), metric, device="cpu")
    assert isinstance(tcb, PQCodebook)
    assert (tcb.dim, tcb.metric) == (cb.dim, cb.metric)
    assert tcb.centroids.dtype == cb.centroids.dtype == np.float32
    np.testing.assert_allclose(tcb.centroids, cb.centroids, rtol=1e-4,
                               atol=1e-4)
    codes = encode_pq(x, tcb, device="cpu")
    assert codes.dtype == np.uint8
    np.testing.assert_array_equal(codes, JPQ.encode_pq(x, cb))
    np.testing.assert_array_equal(encode_pq(x, tcb, 1000, device="cpu"),
                                  codes)


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
    tg = TG.Graph(adj=adj, deg=deg, entry=0)
    lay = TL.layout_bnp(tg, eps)
    np.testing.assert_array_equal(lay.blocks, want.blocks)
    np.testing.assert_array_equal(lay.block_of, want.block_of)
    np.testing.assert_array_equal(lay.slot_of, want.slot_of)
    x = rng.standard_normal((n, 12)).astype(np.float32)
    st = JB.build_store(x, g, want, 4.0)
    got = TB.build_store(x, tg, lay, 4.0)
    for f in ("vid", "vecs", "meta"):
        np.testing.assert_array_equal(getattr(got, f), getattr(st, f))


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
