"""The segment build on the card against the same build on the CPU.

On integer-valued vectors every f32 distance is exact whatever the
summation order, so the card's build (the ``l2_tile`` kernel, CUDA
sorts and scatters) must equal the CPU's (the plain versions) bit for
bit. These tests need a CUDA card and skip without one; they import
nothing of the JAX package, so they run where JAX is not installed
(``pytest -m gpu --noconftest``).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import distances as D
from repro_torch.core import graph as G
from repro_torch.configs.starling_segment import SEGMENT_BENCH_DEVICE
from repro_torch.core import params as P
from repro_torch.core import segment as S

GP = dict(max_degree=12, build_beam=24, insert_batch=64)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _ints(n, d, seed):
    return np.random.default_rng(seed).integers(-8, 9, (n, d)).astype(
        np.float32)


@pytest.mark.gpu
def test_cuda_brute_force_equals_cpu(cuda):
    x, q = _ints(3000, 32, 0), _ints(300, 32, 1)
    np.testing.assert_array_equal(D.brute_force_knn(x, q, 17, device=cuda),
                                  D.brute_force_knn(x, q, 17, device="cpu"))
    np.testing.assert_array_equal(D.knn_graph(x, 24, device=cuda),
                                  D.knn_graph(x, 24, device="cpu"))


@pytest.mark.gpu
@pytest.mark.parametrize("algo", ["nsg", "vamana"])
def test_cuda_graph_equals_cpu(cuda, algo):
    x = _ints(1500, 16, 2)
    p = P.GraphParams(algo=algo, **GP)
    got = G.build_graph(x, p, device=cuda)
    want = G.build_graph(x, p, device="cpu")
    np.testing.assert_array_equal(got.adj, want.adj)
    np.testing.assert_array_equal(got.deg, want.deg)
    assert got.entry == want.entry


@pytest.mark.gpu
def test_cuda_build_segment_equals_cpu(cuda):
    x = _ints(2000, 32, 3)
    params = dataclasses.replace(
        SEGMENT_BENCH_DEVICE,
        graph=P.GraphParams(max_degree=16, build_beam=32, algo="nsg"),
        layout=P.LayoutParams(block_kb=1.0, shuffle="bnf", bnf_iters=4),
        nav=P.NavGraphParams(sample_ratio=0.1, max_degree=8, build_beam=16))
    got = S.build_segment(x, params, device=cuda)
    want = S.build_segment(x, params, device="cpu")
    for f in ("adj", "deg", "blocks", "block_of", "vid", "meta", "nav_ids",
              "nav_adj"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    assert got.overlap_ratio == want.overlap_ratio
    # PQ centroids are means: f32 sums in another order, so a code may
    # flip where two centroids are near-equidistant
    np.testing.assert_allclose(got.pq_cent, want.pq_cent, rtol=1e-4,
                               atol=1e-4)
    assert (got.pq_codes == want.pq_codes).mean() >= 0.99
