"""``examples_torch/quickstart.py`` against ``examples/quickstart.py`` on
the CPU.

JAX's example runs once, in this process: it is loaded from its file,
its own ``build_segment``, ``anns``, baseline and ``range_search``
globals are wrapped to keep what they return, and its printed lines are
read. The segment it built reaches the port through ``save_segment`` ->
``repro_torch.core.segment.load_segment``. On that segment the port's
``search`` must give JAX's ids and every per-query ``IOStats`` field of
the three searches, so every printed number is equal; the port's own
``main`` (its own build) must land within ROADMAP's ±0.01 of JAX's
recall and AP.

The helpers here (``load_example``, ``run_jax_example``, ``carry``) are
shared by the other ``test_torch_example_*`` files.
"""
import contextlib
import dataclasses
import importlib.util
import io
import pathlib
import re
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (the JAX package's import order)
from repro.core import segment as JSEG

from repro_torch.configs.starling_segment import SEGMENT_BENCH
from repro_torch.core import segment as TSEG

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread while the module runs: the
    examples' many small ops otherwise meet every other xdist worker's
    threads at each parallel region's barrier."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def load_example(rel: str, name: str):
    """A fresh module object of the script at ``ROOT / rel`` (not put in
    ``sys.modules``: its globals can be wrapped without reaching anyone
    else)."""
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def recorder(fn, into: list):
    """``fn`` that appends each result to ``into``."""
    def call(*a, **kw):
        out = fn(*a, **kw)
        into.append(out)
        return out
    return call


def run_jax_example(mod, argv=()):
    """``mod.main()`` with ``sys.argv`` set to ``argv``: its stdout, and
    the ``AssertionError`` of the example's own check if it failed (else
    None)."""
    out, failed = io.StringIO(), None
    with pytest.MonkeyPatch.context() as mp, \
            contextlib.redirect_stdout(out):
        mp.setattr(sys, "argv", [mod.__name__, *argv])
        try:
            mod.main()
        except AssertionError as e:
            failed = e
    return out.getvalue(), failed


def carry(jseg, tmp_path_factory, params):
    """A JAX-built segment through ``save_segment`` -> the port's
    ``load_segment`` with the port's ``params``."""
    path = tmp_path_factory.mktemp("seg") / "seg.npz"
    JSEG.save_segment(jseg, str(path))
    return TSEG.load_segment(str(path), params)


def number(text: str, pattern: str) -> float:
    return float(re.search(pattern, text).group(1))


@pytest.fixture(scope="module")
def jax_quickstart(tmp_path_factory):
    mod = load_example("examples/quickstart.py", "jax_quickstart")
    built, searched, base, ranged = [], [], [], []
    mod.build_segment = recorder(mod.build_segment, built)
    mod.anns = recorder(mod.anns, searched)
    mod.B = SimpleNamespace(vertex_anns=recorder(mod.B.vertex_anns, base))
    mod.range_search = recorder(mod.range_search, ranged)
    text, failed = run_jax_example(mod)
    assert failed is None, failed
    return SimpleNamespace(
        text=text, seg=carry(built[0], tmp_path_factory, SEGMENT_BENCH),
        anns=searched[0], base=base[0], range=ranged[0])


@pytest.fixture(scope="module")
def port():
    return load_example("examples_torch/quickstart.py", "torch_quickstart")


def asdicts(stats):
    return [dataclasses.asdict(s) for s in stats]


@pytest.fixture(scope="module")
def port_search(jax_quickstart, port):
    """The port's ``search`` on JAX's segment."""
    x, q, truth = port.data("cpu")
    return port.search(jax_quickstart.seg, x, q, truth, "cpu")


@pytest.mark.parametrize("kind,ids,stats,jax_at", [
    ("starling", "ids", "stats", ("anns", 0, 2)),
    ("baseline", "base_ids", "base_stats", ("base", 0, 2)),
    ("range", "range_ids", "range_stats", ("range", 0, 1))])
def test_search_equals_jax_on_its_segment(jax_quickstart, port_search, kind,
                                          ids, stats, jax_at):
    """On JAX's segment: each search's ids and every ``IOStats`` field,
    query by query."""
    got = getattr(jax_quickstart, jax_at[0])
    want_ids, want_stats = got[jax_at[1]], got[jax_at[2]]
    assert len(port_search[ids]) == len(want_ids)
    for a, b in zip(port_search[ids], want_ids):
        np.testing.assert_array_equal(a, b)
    assert asdicts(port_search[stats]) == asdicts(want_stats)


def test_printed_numbers_equal_jax(jax_quickstart, port_search):
    """Every number JAX's example prints of the searches, as the port's
    ``search`` gives it on JAX's segment."""
    r, text = port_search, jax_quickstart.text
    line = re.search(r"starling .*", text).group(0)
    assert f"recall={r['recall']:.3f}" in line
    assert f"mean_io={r['mean_io']:.1f}" in line
    assert f"xi={r['xi']:.3f}" in line
    assert f"modeled_latency={r['latency_us']:.0f}us" in line
    line = re.search(r"baseline .*", text).group(0)
    assert f"recall={r['base_recall']:.3f}" in line
    assert f"mean_io={r['base_mean_io']:.1f}" in line
    assert f"xi={r['base_xi']:.3f}" in line
    assert f"modeled_latency={r['base_latency_us']:.0f}us" in line
    assert (f"AP={r['ap']:.3f} mean_io={r['range_mean_io']:.1f}"
            in text)


def test_main_own_build_within_roadmap_bound(jax_quickstart, port, capsys):
    """The port's example end to end (its own build on the CPU): recall@10
    and AP within ±0.01 of JAX's printed ones; its lines name the NVMe
    model and the device."""
    r = port.main(["--device", "cpu"])
    text = capsys.readouterr().out
    j = jax_quickstart.text
    assert abs(r["recall"] - number(j, r"starling\s+recall=(\S+)")) <= 0.01
    assert abs(r["ap"] - number(j, r"AP=(\S+)")) <= 0.01
    assert "modeled_latency(NVMe model)=" in text
    assert "on cpu (cpu)" in text
    assert r["mean_io"] < r["base_mean_io"]
