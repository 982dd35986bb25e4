"""The port's distance primitives (``repro_torch.core.distances``)
against the JAX package's, on the CPU (the ``l2_tile`` kernel's plain
version; the JAX brute force through XLA).

On integer-valued vectors every f32 distance is exact in both packages,
so the ids must be equal bit for bit, ties included: the port must
reproduce ``jax.lax.top_k``'s lower-index-first order.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import distances as JD

from repro_torch.core import distances as TD


def _ints(n, d, lo=-8, hi=8, seed=0):
    return np.random.default_rng(seed).integers(lo, hi + 1, (n, d)).astype(
        np.float32)


@pytest.fixture(scope="module")
def xq():
    return _ints(800, 16, seed=0), _ints(60, 16, seed=1)


@pytest.mark.parametrize("k", [1, 10, 33])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_brute_force_knn_equals_jax(xq, k, metric):
    x, q = xq
    want = JD.brute_force_knn(x, q, k, metric=metric)
    got = TD.brute_force_knn(x, q, k, metric=metric, device="cpu")
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_brute_force_knn_chunks_do_not_matter(xq):
    x, q = xq
    np.testing.assert_array_equal(
        TD.brute_force_knn(x, q, 12, chunk=7, device="cpu"),
        JD.brute_force_knn(x, q, 12))


@pytest.mark.parametrize("n,d,k,lo,hi", [(800, 16, 20, -8, 8),
                                         (300, 4, 12, -1, 1)])
def test_knn_graph_equals_jax(n, d, k, lo, hi):
    """The second case is all duplicates and ties (3^4 distinct points)."""
    x = _ints(n, d, lo, hi, seed=n)
    np.testing.assert_array_equal(TD.knn_graph(x, k, device="cpu"),
                                  JD.knn_graph(x, k))


@pytest.mark.parametrize("radius", [0.0, 150.0, 400.0])
def test_brute_force_range_equals_jax(xq, radius):
    x, q = xq
    want = JD.brute_force_range(x, q, radius)
    got = TD.brute_force_range(x, q, radius, chunk=17, device="cpu")
    assert len(got) == len(want) == q.shape[0]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_pairwise_and_point_to_points_equal_jax(xq, metric):
    x, q = xq
    np.testing.assert_array_equal(
        TD.pairwise(q, x, metric, device="cpu").numpy(),
        JD.pairwise(q, x, metric))
    want = JD.point_to_points(q[0], x, metric)
    np.testing.assert_array_equal(TD.point_to_points(q[0], x, metric), want)
    got = TD.point_to_points(torch.as_tensor(q[:3]),
                             torch.as_tensor(np.stack([x] * 3)), metric)
    np.testing.assert_array_equal(got[0].numpy(), want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_topk_smallest_is_lax_top_k_order(seed):
    """Many ties, some across the k-th / (k+1)-th boundary."""
    d = np.random.default_rng(seed).integers(0, 5, (40, 57)).astype(
        np.float32)
    for k in (1, 4, 9, 56):
        _, want = jax.lax.top_k(-jnp.asarray(d), k)
        got = TD.topk_smallest(torch.as_tensor(d), k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_brute_force_knn_float_data_matches_jax_off_near_ties():
    """On float data the f32 sums run in another order: ids must agree
    wherever consecutive distances differ by more than 1e-3."""
    from repro.data.vectors import clustered_vectors
    x = clustered_vectors(2000, 32, seed=4)
    q = x[:100] + 0.05
    k = 10
    want = JD.brute_force_knn(x, q, k + 1)
    got = TD.brute_force_knn(x, q, k + 1, device="cpu")
    dd = np.take_along_axis(JD.pairwise(q, x), want.astype(np.int64), 1)
    clear = (np.diff(dd, axis=1) > 1e-3).all(1)
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(got[clear, :k], want[clear, :k])
