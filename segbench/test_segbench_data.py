"""The generator and the plain reference, on the CPU at a tiny size."""
import numpy as np
import pytest
import torch

from segbench import data, harness

SPEC = harness.load_cell("bigann-1m.stream").config["data"]
REF = harness.plugin("references", "exact_knn")


def test_generator_is_deterministic_per_seed():
    a = data.make(SPEC, 2 ** 31 + 7, 300, "cpu")
    b = data.make(SPEC, 2 ** 31 + 7, 300, "cpu")
    c = data.make(SPEC, 2 ** 31 + 8, 300, "cpu")
    assert torch.equal(a, b)
    assert not torch.equal(a, c)


def test_the_base_set_is_the_configurations():
    mix = data.mixture(SPEC, SPEC["data_seed"], "cpu")
    a = data.base_rows(mix, SPEC, 400, "cpu")
    assert torch.equal(a, data.base_rows(mix, SPEC, 400, "cpu"))
    other = dict(SPEC, data_seed=SPEC["data_seed"] + 1)
    assert not torch.equal(a, data.base_rows(
        data.mixture(other, other["data_seed"], "cpu"), other, 400, "cpu"))


def test_rows_are_sift_shaped_integers():
    x = data.make(SPEC, 3, 2000, "cpu", "base")
    assert x.shape == (2000, 128) and x.dtype == torch.float32
    assert torch.equal(x, torch.round(x))
    assert float(x.min()) >= 0 and float(x.max()) <= 255
    # a histogram: many empty bins, none negative
    assert 0.1 < float((x == 0).float().mean()) < 0.9


def test_queries_are_never_base_rows():
    mix = data.mixture(SPEC, SPEC["data_seed"], "cpu")
    x = data.base_rows(mix, SPEC, 3000, "cpu").numpy()
    q = data.sample(mix, SPEC, 500, 5, "queries", "cpu").numpy()
    base_rows = {r.tobytes() for r in x}
    assert not any(r.tobytes() in base_rows for r in q)
    # the streams differ and share the mixture
    assert not np.array_equal(x[:500], q)


def test_exact_topk_matches_brute_force():
    x = data.make(SPEC, 1, 700, "cpu", "base")
    q = data.make(SPEC, 1, 40, "cpu", stream="queries")
    ids, d = REF.exact_topk(x, q, 10, block=256)
    full = ((q.double()[:, None, :] - x.double()[None]) ** 2).sum(-1)
    want = torch.sort(full, 1).values[:, :10]
    assert torch.equal(d, want)
    assert torch.equal(torch.gather(full, 1, ids), want)


def test_judge_counts_each_fault():
    x = data.make(SPEC, 2, 600, "cpu", "base").numpy()
    q = data.make(SPEC, 2, 30, "cpu", stream="queries").numpy()
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
    x = torch.as_tensor(data.make(SPEC, 4, 900, "cpu", "base"))
    q = data.make(SPEC, 4, 64, "cpu", stream="queries")
    ids, d = REF.control(x, q, 10)
    got = REF.judge(x.numpy(), q.numpy(), ids, d, np.arange(64), 10, "cpu")
    assert got["dist_gap"] > 1e-3
