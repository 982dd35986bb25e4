import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: build-heavy test (segment/graph builds, jit compiles); "
        "deselected by `make test-fast` / the fast CI lane")
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA card (the port's hand-written kernels); "
        "skips without one")

from repro.core.params import (GraphParams, LayoutParams, NavGraphParams,
                               PQParams, SegmentParams)
from repro.data.vectors import clustered_vectors, query_set


SMALL_SEGMENT = SegmentParams(
    graph=GraphParams(max_degree=16, build_beam=48),
    layout=LayoutParams(block_kb=1.0, shuffle="bnf", bnf_iters=4),
    pq=PQParams(num_subspaces=8, train_iters=6, train_sample=2048),
    nav=NavGraphParams(sample_ratio=0.1, max_degree=8, build_beam=24),
)


@pytest.fixture(scope="session")
def small_data():
    x = clustered_vectors(2500, 32, num_clusters=24, seed=0)
    q = query_set(x, 24, seed=1)
    return x, q


@pytest.fixture(scope="session")
def small_segment(small_data):
    from repro.core.segment import build_segment
    x, _ = small_data
    return build_segment(x, SMALL_SEGMENT)
