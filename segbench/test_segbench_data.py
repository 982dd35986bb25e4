"""The SIFT-shaped generator and the plain reference, on the CPU at a tiny
size."""
import numpy as np
import pytest
import torch

from segbench import harness
from segbench.generators import sift

SPEC = harness.load_cell("bigann-1m.stream").config["data"]
REF = harness.plugin("references", "exact_knn")


def test_generator_is_deterministic_per_seed():
    a = sift.queries(SPEC, 300, 2 ** 31 + 7, "queries", "cpu")
    b = sift.queries(SPEC, 300, 2 ** 31 + 7, "queries", "cpu")
    c = sift.queries(SPEC, 300, 2 ** 31 + 8, "queries", "cpu")
    assert torch.equal(a, b)
    assert not torch.equal(a, c)


def test_the_base_set_is_the_configurations():
    a = sift.base(SPEC, 400, "cpu")
    assert torch.equal(a, sift.base(SPEC, 400, "cpu"))
    other = dict(SPEC, data_seed=SPEC["data_seed"] + 1)
    assert not torch.equal(a, sift.base(other, 400, "cpu"))


def test_rows_are_sift_shaped_integers():
    x = sift.queries(SPEC, 2000, 3, "base", "cpu")
    assert x.shape == (2000, 128) and x.dtype == torch.float32
    assert torch.equal(x, torch.round(x))
    assert float(x.min()) >= 0 and float(x.max()) <= 255
    # a histogram: many empty bins, none negative
    assert 0.1 < float((x == 0).float().mean()) < 0.9


def test_queries_are_never_base_rows():
    x = sift.base(SPEC, 3000, "cpu").numpy()
    q = sift.queries(SPEC, 500, 5, "queries", "cpu").numpy()
    base_rows = {r.tobytes() for r in x}
    assert not any(r.tobytes() in base_rows for r in q)
    # the streams differ and share the mixture
    assert not np.array_equal(x[:500], q)


def test_exact_topk_matches_brute_force():
    x = sift.queries(SPEC, 700, 1, "base", "cpu")
    q = sift.queries(SPEC, 40, 1, "queries", "cpu")
    ids, d = REF.exact_topk(x, q, 10, block=256)
    full = ((q.double()[:, None, :] - x.double()[None]) ** 2).sum(-1)
    want = torch.sort(full, 1).values[:, :10]
    assert torch.equal(d, want)
    assert torch.equal(torch.gather(full, 1, ids), want)


def test_judge_counts_each_fault():
    x = sift.queries(SPEC, 600, 2, "base", "cpu").numpy()
    q = sift.queries(SPEC, 30, 2, "queries", "cpu").numpy()
    ids, d = REF.exact_topk(torch.as_tensor(x), torch.as_tensor(q), 10)
    ids, d = ids.numpy(), d.numpy().astype(np.float32)
    sample = np.arange(30)
    ok = REF.judge(x, q, ids, d, sample, 10, "cpu")
    assert ok == {"bad_answers": 0, "dist_gap": 0.0, "recall": 1.0}
    bad = ids.copy()
    bad[0, 1] = bad[0, 0]                       # an id twice
    bad[1, 0] = -1                              # a missing slot
    assert REF.judge(x, q, bad, d, sample, 10, "cpu")["bad_answers"] == 2
    off = d.copy()
    off[3, 4] *= 1.01
    assert REF.judge(x, q, ids, off, sample, 10, "cpu")["dist_gap"] \
        == pytest.approx(0.01, rel=1e-3)
    full = ((q[:, None, :] - x[None]) ** 2).sum(-1)
    far = np.argsort(full, 1, kind="stable")[:, -10:]
    far_d = np.take_along_axis(full, far, 1).astype(np.float32)
    got = REF.judge(x, q, far, far_d, sample, 10, "cpu")
    assert got["recall"] == 0.0 and got["dist_gap"] == 0.0


def test_bf16_control_departs_from_the_reference():
    x = sift.queries(SPEC, 900, 4, "base", "cpu")
    q = sift.queries(SPEC, 64, 4, "queries", "cpu")
    ids, d = REF.control(x, q, 10)
    got = REF.judge(x.numpy(), q.numpy(), ids, d, np.arange(64), 10, "cpu")
    assert got["dist_gap"] > 1e-3
