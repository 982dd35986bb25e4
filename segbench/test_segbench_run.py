"""Whole runs of the cells at a tiny size on the CPU: the result line's
keys, a run without a card, and a configuration, traffic mix and metric
reader dropped in as files."""
import contextlib
import io
import json
import shutil

import pytest
import torch

from segbench import ROOT, harness, run, tiny

CELLS = [w["name"] for w in harness.load_json(ROOT / "BENCHMARK.json")
         ["workloads"]]
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device",
               "checks"]


@pytest.fixture(scope="module")
def builds():
    torch.set_num_threads(1)
    return tiny.Builds()


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_result_line_has_the_contract_keys(name, trace, builds):
    cell = tiny.cell(name)
    out = tiny.run(cell, trace=trace, builds=builds)
    keys = list(out)
    if trace:
        assert keys.pop(keys.index("breakdown"))
    assert keys == RESULT_KEYS          # the checks come last
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    kind = "per_layer" if trace else "end_to_end"
    named = {m["name"] for m in cell.metrics if m["kind"] == kind}
    assert set(out["metrics"]) <= named
    if not trace:
        assert set(out["metrics"]) == named
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(out)


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                   "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err


def test_files_dropped_in_by_name_are_found(tmp_path, monkeypatch, builds):
    """A new configuration, traffic mix and metric reader are new files
    and BENCHMARK.json entries; no file of the harness changes."""
    small = tiny.cell("bigann-1m.stream")
    tree = tmp_path / "segbench"
    shutil.copytree(harness.HERE, tree,
                    ignore=shutil.ignore_patterns("__pycache__"))
    cfg = harness.load_json(tree / "configs" / "bigann-1m.json")
    cfg["name"] = "bigann-1m-b"
    (tree / "configs" / "bigann-1m-b.json").write_text(json.dumps(cfg))
    traffic = dict(harness.load_json(tree / "traffic" / "stream.json"),
                   rate_qps=150)
    (tree / "traffic" / "trickle.json").write_text(json.dumps(traffic))
    (tree / "metrics" / "answered_share.trickle.py").write_text(
        "def read(run):\n"
        "    idx = run.window_requests()\n"
        "    return float((run.rec.done[idx] <= run.seconds).mean())\n")
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    bench["configs"].append(dict(bench["configs"][0], name="bigann-1m-b",
                                 file="segbench/configs/bigann-1m-b.json"))
    bench["workloads"].append({"name": "bigann-1m-b.trickle",
                               "config": "bigann-1m-b", "traffic": "trickle",
                               "chips": 1, "why": "a drop-in"})
    bench["per_layer"].append({
        "name": "answered_share.trickle", "unit": "share",
        "better": "higher", "source": "host_clock", "layer": "x",
        "moves": "latency_p95_ms", "workloads": ["bigann-1m-b.trickle"]})
    bench["end_to_end"][1]["workloads"].append("bigann-1m-b.trickle")
    monkeypatch.setattr(harness, "HERE", tree)
    monkeypatch.setattr(harness, "ROOT", tmp_path)
    cell = harness.load_cell("bigann-1m-b.trickle", bench)
    assert cell.traffic["rate_qps"] == 150
    assert cell.config["name"] == "bigann-1m-b"
    cell = harness.Cell(cell.name, 1, small.config,
                        dict(small.traffic, rate_qps=150), cell.metrics)
    out = tiny.run(cell, trace=True, builds=builds)
    assert 0 < out["metrics"]["answered_share.trickle"]["value"] <= 1
    out = tiny.run(cell, trace=False, builds=builds)
    assert "latency_p95_ms" in out["metrics"]


def test_run_prints_checks_last_on_stderr(monkeypatch, capsys):
    """``run.main`` with the card check passed: the compared numbers are
    the last lines on standard error, the result the last on standard
    output."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    real = harness.run_cell

    def on_cpu(cell, seed, seconds, trace, device, t_start, log=print):
        small = tiny.cell(cell.name)
        return real(small, seed, seconds, trace, "cpu", t_start, log=log)
    monkeypatch.setattr(harness, "run_cell", on_cpu)
    # this process may hold the JAX tests' modules; the subprocess check
    # of test_segbench_imports covers what a run loads
    monkeypatch.setattr(run, "forbidden_modules", lambda: [])
    with contextlib.redirect_stdout(io.StringIO()) as out:
        rc = run.main(["--workload", CELLS[0], "--seed", "9",
                       "--seconds", "0.5", "--trace", "0"])
    assert rc == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    err = capsys.readouterr().err.strip().splitlines()
    assert err[-len(line["checks"]):] == [
        f"check {n} {c['value']!r} limit {c['limit']!r}"
        for n, c in line["checks"].items()]
