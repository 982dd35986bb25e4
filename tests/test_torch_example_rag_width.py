"""The RAG bridge's segment at gemma3-1b's full width (d_model 1,152) on
the CPU, in both packages.

``chip_smoke.py`` indexes ``clustered_vectors(100,000, 1,152)`` for the
bridge with ``SEGMENT_BENCH_DEVICE`` at η = 16 KB (ε = 3: a 4,708 B
vertex does not fit 4 KB) and an NSG disk graph. Here the same
parameters index 1,500 vectors of that width. JAX's segment reaches the
port through ``save_segment`` -> ``load_segment``; on it the port's
``device_anns`` must give JAX's ids, ``io`` and ``tier0_hits``, dists
within ROADMAP's device-search bound 2.5e-4 plus 1e-6 of their size
(the squared distances reach ~4e4 at this width, where one f32 ulp is
3.9e-3; the packages' summation orders part by up to two), for two kinds
of query: the example's (embedding rows of the LM, scale 0.02, near the
origin) and ``query_set`` rows drawn from the corpus. The port's own build must land
within ROADMAP's ±0.01 of JAX's recall@4 for both. Queries drawn from
the corpus reach a higher recall than the embedding rows in both
packages: the bridge's low recall belongs to its queries.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.starling_segment import SEGMENT_BENCH_DEVICE as J_BENCH
from repro.core import device_search as JDS
from repro.core import segment as JSEG
from repro.core.params import DeviceSearchParams as JDP

from repro_torch.configs.starling_segment import SEGMENT_BENCH_DEVICE
from repro_torch.core import device_search as TDS
from repro_torch.core import segment as TSEG
from repro_torch.core.params import DeviceSearchParams as TDP
from repro_torch.core.params import LayoutParams
from repro_torch.data.vectors import clustered_vectors, query_set
from tests.test_torch_example_quickstart import (  # noqa: F401
    carry, one_torch_thread)

N, DIM, BLOCK_KB = 1500, 1152, 16.0
RETRIEVE = dict(k=4, candidates=32, max_hops=64)   # rag_serving's
DIST_ATOL, DIST_RTOL = 2.5e-4, 1e-6
RECALL_TOL = 0.01


def full_width(p):
    """``SEGMENT_BENCH_DEVICE`` as ``chip_smoke.py`` changes it for the
    bridge: η 16 KB and an NSG disk graph."""
    return dataclasses.replace(
        p, layout=dataclasses.replace(p.layout, block_kb=BLOCK_KB),
        graph=dataclasses.replace(p.graph, algo="nsg"))


@pytest.fixture(scope="module")
def corpus():
    return clustered_vectors(N, DIM, num_clusters=16, seed=0)


@pytest.fixture(scope="module")
def queries(corpus):
    return {"embedding rows": (np.random.default_rng(3).standard_normal(
                (8, DIM)) * 0.02).astype(np.float32),
            "corpus": query_set(corpus, 32, seed=1)}


@pytest.fixture(scope="module")
def jax_seg(corpus):
    return JSEG.build_segment(corpus, full_width(J_BENCH))


@pytest.fixture(scope="module")
def carried(jax_seg, tmp_path_factory):
    return carry(jax_seg, tmp_path_factory, full_width(SEGMENT_BENCH_DEVICE))


@pytest.fixture(scope="module")
def port_seg(corpus):
    return TSEG.build_segment(corpus, full_width(SEGMENT_BENCH_DEVICE),
                              device="cpu")


def truth(corpus, q, k):
    q64, x64 = q.astype(np.float64), corpus.astype(np.float64)
    d = ((q64 ** 2).sum(1)[:, None] + (x64 ** 2).sum(1)[None]
         - 2.0 * q64 @ x64.T)
    return np.argsort(d, axis=1, kind="stable")[:, :k]


def recall(ids, want):
    return float(np.mean([len(set(a.tolist()) & set(b.tolist())) / len(b)
                          for a, b in zip(np.asarray(ids), want)]))


@pytest.fixture(scope="module")
def searched(jax_seg, carried, port_seg, queries):
    """Each kind of query searched by JAX on its segment, and by the port
    on JAX's segment carried across and on its own."""
    jds = JDS.from_segment(jax_seg)
    cds, tds = (TDS.from_segment(s, device="cpu") for s in (carried,
                                                            port_seg))
    out = {}
    for kind, q in queries.items():
        tq = torch.as_tensor(q)
        out[kind] = {
            "jax": JDS.device_anns(jds, jnp.asarray(q), JDP(**RETRIEVE)),
            "carried": TDS.device_anns(cds, tq, TDP(**RETRIEVE)),
            "port": TDS.device_anns(tds, tq, TDP(**RETRIEVE))}
    return out


def test_block_holds_three_vertices(jax_seg, carried, port_seg):
    """ε 3 at 16 KB; a 4 KB block cannot hold a vertex of this width."""
    assert jax_seg.view.store.vecs.shape[1] == 3
    assert carried.vecs.shape[1] == port_seg.vecs.shape[1] == 3
    with pytest.raises(ValueError, match="4708B"):
        LayoutParams(block_kb=4.0).verts_per_block(DIM, 24)


@pytest.mark.parametrize("kind", ["embedding rows", "corpus"])
@pytest.mark.parametrize("field", ["ids", "io", "tier0_hits", "dists"])
def test_device_anns_on_jax_segment_equals_jax(searched, kind, field):
    want = np.asarray(getattr(searched[kind]["jax"], field))
    got = getattr(searched[kind]["carried"], field).numpy()
    if field == "dists":
        np.testing.assert_allclose(got, want, rtol=DIST_RTOL,
                                   atol=DIST_ATOL)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["embedding rows", "corpus"])
def test_port_build_recall_near_jax(corpus, queries, searched, kind):
    want = truth(corpus, queries[kind], RETRIEVE["k"])
    j = recall(searched[kind]["jax"].ids, want)
    t = recall(searched[kind]["port"].ids.numpy(), want)
    assert abs(t - j) <= RECALL_TOL, (kind, t, j)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_corpus_queries_recall_above_embedding_rows(corpus, queries,
                                                    searched, pkg):
    got = {kind: recall(np.asarray(searched[kind][pkg].ids),
                        truth(corpus, q, RETRIEVE["k"]))
           for kind, q in queries.items()}
    assert got["corpus"] > got["embedding rows"], got
