"""Each metric reader on synthetic spans, counters and device figures,
and every metric of BENCHMARK.json found by its name."""
import collections

import numpy as np
import pytest

from segbench import ROOT, harness

Span = collections.namedtuple("Span", "name dur_us")
BENCH = harness.load_json(ROOT / "BENCHMARK.json")
NAMES = [m["name"] for k in ("end_to_end", "per_layer") for m in BENCH[k]]


def synthetic_run(device=True):
    """Three batches in a 10 s window, the third in the traced
    sub-window, and one after it; six requests due in the window, one
    answered only after it."""
    rec = harness.Recorder(8, 10)
    rec.arrival[:7] = [0.0, 1.0, 2.0, 3.0, 4.0, 8.0, 10.5]
    rec.dispatch[:7] = [0.5, 1.5, 2.5, 3.5, 4.5, 9.0, 11.0]
    rec.done[:7] = [1.0, 2.0, 3.0, 4.0, 5.0, 11.0, 12.0]
    rec.batches = [
        dict(t_dispatch=0.5, t_done=2.0, n_valid=2, rounds=100, io=100,
             spans=(0, 3), in_sub=False),
        dict(t_dispatch=2.5, t_done=5.0, n_valid=3, rounds=120, io=180,
             spans=(3, 6), in_sub=False),
        dict(t_dispatch=9.0, t_done=11.0, n_valid=1, rounds=80, io=70,
             spans=(6, 9), in_sub=True),
        dict(t_dispatch=11.0, t_done=12.0, n_valid=1, rounds=90, io=60,
             spans=(9, 12), in_sub=False)]
    spans = []
    for whole, seg in ((1000, 900), (2000, 1850), (3000, 2700),
                       (500, 400)):
        spans += [Span("coord.segment", seg / 2), Span("coord.segment",
                                                       seg / 2),
                  Span("coord.batch", whole)]
    dev = {"busy_s": 2.0, "window_s": 8.0, "kernels": 600, "rounds": 120,
           "kernel_s": {"rank_kernel": 0.1,
                        "union_gather_kernel": 0.3, "aten::sort": 1.0},
           "least_s": {"gather_union": 0.05, "fused_round_rank": 0.03},
           "idle_by_host": {}} if device else None
    cell = harness.Cell("x", 1, {}, {}, [])
    return harness.Run(cell, 10.0, 95.5,
                       [{"disk_graph_s": 40.0}, {"disk_graph_s": 2.5}],
                       rec, spans=spans, device=dev,
                       check={"recall": 0.93})


EXPECT = {
    "setup_s": 95.5,
    # batches done inside the window: 2 + 3 queries by t = 5 s
    "qps": 5 / 5.0,
    # latencies 1, 1, 1, 1, 1 and 11 - 8 = 3 (answered in the drain)
    "latency_p95_ms": float(np.percentile([1, 1, 1, 1, 1, 3], 95)) * 1e3,
    "recall_at_10": 0.93,
    # the host-side readers: the two batches before the sub-window
    "queue_wait_ms.stream": 500.0,
    "batch_queries.stream": 2.5,
    "coord_self_ms": (100 + 150) / 2 / 1e3,
    "rounds_per_batch": 110.0,
    "ms_per_round": (900 + 1850) / 1e3 / 220,
    "io_per_query": 280 / 5,
    "round_kernels_roofline": 100 * 0.08 / 0.4,
    "device_idle": 0.75,
    "launches_per_round": 5.0,
    "build_graph_s": 42.5,
    # the round-loop readers read nothing here: this run holds no round
    # span and no sync count, as a traced run of a program without them
    # holds none; their values on runs that hold them are pinned in
    # test_segbench_spans.py and test_segbench_graph_share.py
    "syncs_per_round": None,
    "sync_wait_ms": None,
    "issue_ms": None,
    "graph_round_share": None,
}


@pytest.mark.parametrize("name", NAMES)
def test_reader_on_synthetic_run(name):
    want = EXPECT[name] if name in EXPECT else EXPECT[name.split(".")[0]]
    got = harness.plugin("metrics", name).read(synthetic_run())
    assert got == pytest.approx(want, rel=1e-12)


def test_p95_counts_a_request_never_answered_at_the_loops_end():
    run = synthetic_run()
    run.rec.done[5] = np.nan
    run.rec.t_end = 70.0
    got = harness.plugin("metrics", "latency_p95_ms").read(run)
    assert got == pytest.approx(
        float(np.percentile([1, 1, 1, 1, 1, 70 - 8], 95)) * 1e3)


@pytest.mark.parametrize("name", [n for n in NAMES if any(
    m["name"] == n and m["source"] == "device_trace"
    for m in BENCH["per_layer"])])
def test_device_reader_without_a_trace_reads_nothing(name):
    assert harness.plugin("metrics", name).read(
        synthetic_run(device=False)) is None


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in BENCH["workloads"]:
        cell = harness.load_cell(w["name"])
        e2e = {m["name"] for m in cell.metrics if m["kind"] == "end_to_end"}
        layers = [m for m in cell.metrics if m["kind"] == "per_layer"]
        assert "setup_s" in e2e and len(e2e) >= 2 and layers
        for m in layers:
            assert m["moves"] in e2e


def test_device_events_reduce_to_busy_time_gaps_and_labels():
    from segbench import devtrace
    dev = [("void rank_kernel<false>(float const*)", 10.0, 20.0),
           ("(anonymous namespace)::union_gather_kernel(int const*)",
            15.0, 30.0),
           ("Memcpy DtoD (Device -> Device)", 50.0, 55.0),
           ("late", 95.0, 120.0)]
    dev = devtrace.clip(dev, 0.0, 100.0)
    busy = devtrace.busy_intervals(dev)
    assert busy == [(10.0, 30.0), (50.0, 55.0), (95.0, 100.0)]
    gaps = devtrace.idle_gaps(busy, 0.0, 100.0)
    assert gaps == [(0.0, 10.0), (30.0, 50.0), (55.0, 95.0)]
    host = [("cudaLaunchKernel", 2.0, 8.0), ("cudaMemcpyAsync", 60.0, 90.0),
            ("cudaStreamSynchronize", 62.0, 80.0)]
    labels = devtrace.label_gaps(gaps, host)
    assert labels == pytest.approx({"cudaLaunchKernel": 10e-6,
                                    "(host between runtime calls)": 20e-6,
                                    "cudaStreamSynchronize": 40e-6})
    assert [devtrace.short_name(n) for n, _, _ in dev[:3]] == [
        "rank_kernel", "union_gather_kernel", "Memcpy DtoD"]
