"""The seam by which a configuration names its data generator
(``harness.data_source``, ``harness.rows``), the SIFT-shaped generator's
rows through it, and the Text-to-Image-shaped generator's properties, on
the CPU."""
import copy
import hashlib
import json

import numpy as np
import pytest
import torch

from segbench import harness, tiny
from segbench.generators import text2image

CONFIGS = ["bigann-1m.stream", "bigann-4x250k.bulk"]
SEED = 2 ** 31 + 5

# sha256 of the rows the harness drew before the seam, computed once
# from the parent commit's ``segbench.data`` at SEED: a 600-row base and
# 64 rows each of the ``queries`` and ``warmup`` streams; both
# configurations hold the same data group
PINNED = {
    "base": "503af3a460b70ec009cb898773d6ab79467b5bcd62654535e50662b1d8545831",
    "pool": "b0859aaf8c175220006eda339801f7f2b6e5303375ad88f6f1912dff6610465d",
    "warm": "03db621ad3d0fdb8da72d71d70b057f515f483beeac769a792789b5a5c4672b9",
}

T2I = text2image.DATA_GROUP


def sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


@pytest.mark.parametrize("name", CONFIGS)
def test_sift_through_the_seam_gives_the_parents_rows(name):
    cfg = copy.deepcopy(harness.load_cell(name).config)
    assert cfg["data"]["generator"] == "sift"
    cfg["segments"] = [600]
    base, pool, warm = harness.rows(cfg, SEED, 64, 64, "cpu")
    assert base.dtype == pool.dtype == warm.dtype == np.float32
    assert {"base": sha(base), "pool": sha(pool), "warm": sha(warm)} \
        == PINNED


def test_a_data_group_without_a_generator_names_the_key():
    cfg = copy.deepcopy(harness.load_cell(CONFIGS[0]).config)
    del cfg["data"]["generator"]
    with pytest.raises(KeyError, match='"generator"'):
        harness.rows(cfg, SEED, 4, 4, "cpu")
    with pytest.raises(KeyError, match='"generator"'):
        tiny.cut(harness.Cell("x", 1, cfg, {}, []))


def test_each_generator_cuts_its_own_data_group():
    for spec in (harness.load_cell(CONFIGS[0]).config["data"], T2I):
        cut = harness.data_source(spec).tiny(spec)
        assert cut["clusters"] == 16 and spec["clusters"] == 256
        assert {k: v for k, v in cut.items() if k != "clusters"} == {
            k: v for k, v in spec.items() if k != "clusters"}


def test_text2image_is_deterministic_per_seed():
    a = text2image.queries(T2I, 300, SEED, "queries", "cpu")
    assert torch.equal(a, text2image.queries(T2I, 300, SEED, "queries",
                                             "cpu"))
    assert not torch.equal(a, text2image.queries(T2I, 300, SEED + 1,
                                                 "queries", "cpu"))
    assert not torch.equal(a, text2image.queries(T2I, 300, SEED, "warmup",
                                                 "cpu"))
    assert a.shape == (300, 200) and a.dtype == torch.float32


def test_text2image_base_is_fixed_by_data_seed():
    a = text2image.base(T2I, 400, "cpu")
    assert torch.equal(a, text2image.base(T2I, 400, "cpu"))
    assert not torch.equal(a, text2image.base(
        dict(T2I, data_seed=T2I["data_seed"] + 1), 400, "cpu"))


@pytest.fixture(scope="module")
def crossmodal():
    """20,000 base rows to fit on, 2,000 held-out base rows and 2,000
    queries, with their topics, as float64."""
    x, xt = text2image.draw(T2I, 22_000, T2I["data_seed"], "base", "image",
                            "cpu")
    q, qt = text2image.draw(T2I, 2_000, SEED, "queries", "text", "cpu")
    return x.double(), xt, q.double(), qt


# The three properties' thresholds are choices made for this benchmark,
# not figures measured on the real Text-to-Image set.

def test_text2image_rows_are_signed_floats(crossmodal):
    x, _, q, _ = crossmodal
    for rows in (x, q):
        assert float((rows < 0).double().mean()) >= 0.30
        integer_rows = (rows == torch.round(rows)).all(1)
        assert float(integer_rows.double().mean()) < 0.01


def test_text2image_queries_lie_off_the_base_distribution(crossmodal):
    x, _, q, _ = crossmodal
    fit, held = x[:20_000], x[20_000:]
    mean = fit.mean(0)
    prec = torch.linalg.inv(torch.cov((fit - mean).T))

    def mahalanobis_sq(v):
        d = v - mean
        return ((d @ prec) * d).sum(1)
    dim = T2I["dim"]
    held_d = mahalanobis_sq(held)
    # the measure is sound: its mean over rows of the fitted distribution
    # is the dimension, whatever that distribution
    assert abs(float(held_d.mean()) - dim) <= 0.15 * dim
    assert float(mahalanobis_sq(q).median()) >= 2 * float(held_d.median())


def test_text2image_queries_keep_their_topic(crossmodal):
    x, xt, q, qt = crossmodal
    top = (q @ x[:20_000].T).topk(10, dim=1).indices
    same = xt[:20_000][top] == qt[:, None]
    assert float(same.double().mean()) >= 0.5


def test_a_configuration_file_alone_chooses_its_data(monkeypatch):
    """``bigann-1m.stream``'s configuration with the text2image data group
    (200-d) in place of SIFT's, the metric kept at L2, through a tiny
    run: the rows the system and the reference get are the generator's."""
    c = harness.load_cell("bigann-1m.stream")
    cfg = copy.deepcopy(c.config)
    cfg["data"] = copy.deepcopy(T2I)
    assert cfg["index"]["metric"] == "l2"
    small = tiny.cut(harness.Cell(c.name, c.chips, cfg, c.traffic,
                                  c.metrics))
    assert small.config["data"]["clusters"] == 16
    seen = []
    real = harness.rows

    def keep(cfg_, *a, **kw):
        got = real(cfg_, *a, **kw)
        seen.append(got)
        return got
    monkeypatch.setattr(harness, "rows", keep)
    out = tiny.run(small)
    assert out["correct"] is True and out["failed"] == 0, out["checks"]
    assert out["attempted"] > 0
    base, pool, warm = seen[0]
    assert base.shape == (600, 200) and pool.shape[1] == 200
    assert float((base < 0).mean()) > 0.3
    assert np.array_equal(base, text2image.base(
        small.config["data"], 600, "cpu").numpy())


def test_the_inner_product_rehearsal_on_a_tiny_segment(capsys):
    from segbench import rehearsal_ip
    assert rehearsal_ip.main(["--device", "cpu", "--n", "1500",
                              "--queries", "128", "--seed", "3"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["ran"] is True, out.get("traceback")
    assert out["index"]["metric"] == "ip"
    assert out["index"]["graph"]["max_degree"] == 54
    for name in ("queries", "held_out_base"):
        got = out[name]
        assert got["bad_answers"] == 0 and got["key_gap"] < 1e-5
        assert got["recall_at_10"] > 0.8 and got["io_per_query"] > 0
