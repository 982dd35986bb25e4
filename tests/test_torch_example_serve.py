"""``examples_torch/serve_segments.py`` against ``examples/
serve_segments.py`` on the CPU.

JAX's example runs once in this process, with its ``build_segment`` and
``QueryCoordinator`` globals wrapped to keep the three segments and
each batch's ids, dists and stats dict. On those segments carried across,
the port's servers (the plain round on the CPU) serve the same 24
requests: ids equal, dists within ROADMAP's device-search bound 2.5e-4,
and each batch's stats dict equal to JAX's column by column. The port's
``main`` then runs end to end once.
"""
from types import SimpleNamespace

import numpy as np
import pytest

from repro_torch.configs.starling_segment import SEGMENT_BENCH
from repro_torch.data.vectors import clustered_vectors, query_set
from tests.test_torch_example_quickstart import (  # noqa: F401
    carry, load_example, one_torch_thread, recorder, run_jax_example)

DIST_ATOL = 2.5e-4


@pytest.fixture(scope="module")
def jax_serve(tmp_path_factory):
    mod = load_example("examples/serve_segments.py", "jax_serve_segments")
    built, batches = [], []
    mod.build_segment = recorder(mod.build_segment, built)

    class Recording(mod.QueryCoordinator):
        def search(self, queries, k=10):
            out = super().search(queries, k=k)
            batches.append(out)
            return out

    mod.QueryCoordinator = Recording
    text, failed = run_jax_example(mod)
    assert failed is None, failed
    segs = [carry(s, tmp_path_factory, SEGMENT_BENCH) for s in built]
    return SimpleNamespace(text=text, segs=segs, batches=batches)


@pytest.fixture(scope="module")
def port():
    return load_example("examples_torch/serve_segments.py",
                        "torch_serve_segments")


@pytest.fixture(scope="module")
def served(jax_serve, port):
    """The port's servers on JAX's segments, the example's 24 requests."""
    union = np.concatenate([clustered_vectors(port.N_PER, port.DIM,
                                              num_clusters=16, seed=s)
                            for s in range(port.NUM_SEGMENTS)])
    queries = query_set(union, 24, seed=9)
    return port.serve(port.make_servers(jax_serve.segs, "cpu"), queries)


def test_same_batches(jax_serve, served):
    assert len(served["batches"]) == len(jax_serve.batches) >= 1


@pytest.mark.parametrize("what", ["ids", "dists", "stats"])
def test_batches_equal_jax(jax_serve, served, what):
    """Each batch: ids equal, dists within 2.5e-4, the stats dict equal
    key by key."""
    for got, (gi, gd, stats) in zip(served["batches"], jax_serve.batches):
        if what == "ids":
            np.testing.assert_array_equal(got["ids"], np.asarray(gi))
        elif what == "dists":
            np.testing.assert_allclose(got["dists"], np.asarray(gd),
                                       rtol=0, atol=DIST_ATOL)
        else:
            assert set(got["stats"]) == set(stats)
            for key, v in stats.items():
                assert got["stats"][key] == v, key


def test_printed_lines_equal_jax(jax_serve, served):
    for got in served["batches"]:
        s = got["stats"]
        assert (f"segments={s['segments_searched']}, mean block "
                f"reads/query={s['mean_block_reads_per_query']:.1f}"
                in jax_serve.text)


def test_main_end_to_end(jax_serve, port, capsys):
    """The port's example with its own three builds: recall@10 printed,
    within ±0.01 of JAX's, and the wall line names the device and the
    plain round."""
    r = port.main(["--device", "cpu"])
    text = capsys.readouterr().out
    want = float(jax_serve.text.split("segments: ")[1].split()[0])
    assert abs(r["recall"] - want) <= 0.01
    assert f"recall@10 over 3 segments: {r['recall']:.3f}" in text
    assert "wall (cpu, plain round): " in text
    assert r["ids"].shape == (24, 10)
