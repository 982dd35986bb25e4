"""The round-loop readers (``segbench.spans``) on hand-made spans, and
the sub-window's idle and device time put down to the program's spans
on hand-made intervals; ``spancheck``'s on-cost and report on tiny CPU runs."""
from unittest import mock

import pytest

from segbench import harness, spancheck, spans as S, tiny
from repro_torch.core import device_search as DS
from repro_torch.obs import TraceEvent, Tracer, manual_tracer

NAMES = [f"{m}.{c}" for m in ("syncs_per_round", "sync_wait_ms",
                              "issue_ms") for c in ("stream", "bulk")]


def X(name, ts, dur, **args):
    return TraceEvent(name=name, cat="search", ph="X", ts_us=float(ts),
                      dur_us=float(dur), args=args)


def segment_search(t0, rounds, compact=True):
    """One segment search from ``t0`` (µs), in the order a tracer
    records it (a span when it closes): a 50 µs prologue, rounds of
    1,000 µs (eight phases of 125 µs) with a 10 µs loop test before each
    and one after the last, two 20 µs compaction reads in each, then nine
    5 µs copies."""
    ev = [X("search.prologue", t0, 50)]
    t = t0 + 50
    for r in range(rounds):
        ev.append(X("sync.loop", t, 10))
        t += 10
        if compact:
            ev += [X("sync.compact", t + 100, 20),
                   X("sync.compact", t + 200, 20)]
        ev.append(X("search.round", t, 1000, t=r, fired=False,
                    phases=tuple(t + 125.0 * i for i in range(1, 9))))
        t += 1000
    ev.append(X("sync.loop", t, 10))
    t += 10
    ev += [X("sync.readback", t + 5 * i, 5) for i in range(9)]
    ev.append(X("search.readback", t, 45,
                syncs=(3 if compact else 1) * rounds + 10))
    return ev


def run_of(batches, sub_batch=True):
    """A Run whose batches each hold the given segment searches inside
    ``coord.segment`` / ``coord.batch``; with ``sub_batch`` one more
    batch lies in the traced sub-window."""
    rec = harness.Recorder(4, 10)
    spans = []
    for i, searches in enumerate(batches + ([[3]] if sub_batch else [])):
        e0 = len(spans)
        rounds = 0
        for j, r in enumerate(searches):
            t0 = 1e6 * i + 1e5 * j
            spans += segment_search(t0, r)
            spans.append(X("coord.segment", t0, 1e5))
            rounds += r
        spans.append(X("coord.batch", 1e6 * i, 2e5))
        rec.batches.append(dict(t_dispatch=float(i), t_done=i + 0.5,
                                n_valid=1, rounds=rounds, io=0,
                                spans=(e0, len(spans)),
                                in_sub=i == len(batches)))
    return harness.Run(harness.Cell("x", 1, {}, {}, []), 10.0, 0.0, [],
                       rec, spans=spans)


def test_readers_on_hand_made_spans():
    run = run_of([[4], [2, 3]])           # one segment, then two
    r, searches = 4 + 2 + 3, 3
    assert S.syncs_per_round(run) == pytest.approx(
        (3 * r + 10 * searches) / r)
    # every sync span: the loop tests (R + 1 a search), the compaction
    # reads and the copies
    wait_us = 10 * (r + searches) + 40 * r + 45 * searches
    assert S.sync_wait_ms(run) == pytest.approx(wait_us / 1e3 / r)
    # the rounds less the compaction reads that start inside them
    assert S.issue_ms(run) == pytest.approx((1000 - 40) / 1e3)


@pytest.mark.parametrize("name", NAMES)
def test_metric_files_are_the_readers(name):
    read = harness.plugin("metrics", name).read
    assert read is getattr(S, name.split(".")[0])
    assert read(run_of([[5]])) == pytest.approx(read(run_of([[5]])))


def test_readers_read_nothing_without_round_spans():
    run = run_of([[4], [2]])
    run.spans = [e for e in run.spans if not e.name.startswith(
        ("search.", "round.", "sync."))]
    for b in run.rec.batches:
        b["spans"] = (0, len(run.spans))
    assert S.syncs_per_round(run) is None
    assert S.sync_wait_ms(run) is None and S.issue_ms(run) is None


def test_the_phases_are_the_programs():
    assert S.ROUND_PHASES == DS.ROUND_PHASES


def test_idle_and_device_time_by_span():
    ends = (15.0, 20.0, 30.0, 32.0, 34.0, 40.0, 45.0, 50.0)
    spans = S.program_spans([
        X("sync.compact", 11, 2), X("search.round", 10, 40, phases=ends),
        X("sync.loop", 50, 10),
        TraceEvent("io.fetch_submit", "io", "i", 55.0)])
    assert spans == [("sync.compact", 11.0, 13.0),
                     ("search.round", 10.0, 50.0)] + list(zip(
                         S.ROUND_PHASES, (10.0,) + ends[:-1], ends)) + [
                     ("sync.loop", 50.0, 60.0)]
    gaps = [(0.0, 4.0), (11.5, 12.5), (22.0, 24.0), (36.0, 38.0),
            (52.0, 58.0)]
    assert S.idle_by_span(gaps, spans) == pytest.approx({
        S.OUTSIDE: 4e-6, "sync.compact": 1e-6, "round.stage": 2e-6,
        "round.expand": 2e-6, "sync.loop": 6e-6})
    device = [("rank_kernel", 100.0, 108.0, 7, 0),    # launched at 25
              ("sort", 110.0, 113.0, 0, 8),           # linked: at 47
              ("copy", 114.0, 116.0, 9, 0),           # no such call
              ("late", 118.0, 130.0, 10, 0)]          # cut at 120
    runtime = {7: 25.0, 8: 47.0, 10: 70.0}
    assert S.launch_times(device, runtime) == [25.0, 47.0, None, 70.0]
    assert S.device_by_span(device, runtime, spans, 0.0, 120.0) == \
        pytest.approx({"round.stage": 8e-6, "round.merge": 3e-6,
                       S.NO_LAUNCH: 2e-6, S.OUTSIDE: 2e-6})


def test_a_round_without_phases_is_one_span():
    assert S.program_spans([X("search.round", 10, 40, t=0)]) == [
        ("search.round", 10.0, 50.0)]


def test_readers_skip_the_batches_a_full_tracer_cut():
    whole = run_of([[4], [2]])
    run = run_of([[4], [2], [3]])
    run.rec.tracer = Tracer(max_events=run.rec.batches[1]["spans"][1] + 1)
    run.rec.tracer.dropped = 5
    # the third batch ends past the cap: read as if it were not there
    run.rec.batches[2]["spans"] = (run.rec.batches[2]["spans"][0],
                                   run.rec.tracer.max_events)
    for name in ("syncs_per_round", "sync_wait_ms", "issue_ms"):
        reader = getattr(S, name)
        assert reader(run) == pytest.approx(reader(whole)), name


def test_the_tracers_cost_on_a_tiny_cell():
    got = spancheck.oncost(tiny.cell("bigann-1m.stream"), 2 ** 31 + 7, 2,
                           "cpu", log=lambda m: None)
    assert len(got["pairs"]) == 2
    for row in got["pairs"]:
        assert row["same_rounds"] and row["rounds"] > 0
        # a round, its loop test and its two compaction reads, and a
        # search's prologue, read-back and nine copies over its rounds
        assert 4 < row["events_per_round"] < 4 + 20 / row["rounds"] + 1
        assert len(row["gc_on"]) == len(row["gc_off"]) == 3
    assert len(got["diff_ms_per_round_quartiles"]) == 3
    assert got["alone_us"]["round_us"] > 0 and got["alone_us"]["sync_us"] > 0


def test_round_spans_alone_leave_the_tracer_empty():
    tr = manual_tracer()
    got = spancheck.alone_us(tr, n=10)
    assert set(got) == {"round_us", "sync_us"} and len(tr) == 0


def test_points_inside_intervals():
    assert spancheck._inside([0.5, 1.0, 2.5, 4.0, 9.0],
                             [(1.0, 2.0), (3.0, 4.0)]) == 2


def test_span_report_on_a_tiny_traced_run():
    c = tiny.cell("bigann-4x250k.bulk")
    kept = {}
    reading = harness.device_reading

    def keep(sub, rec):
        kept["sub"], kept["rec"] = sub, rec
        return reading(sub, rec)
    with mock.patch.object(harness, "device_reading", keep):
        out = tiny.run(c, trace=True)
    assert out["correct"]
    got = spancheck.span_report(kept["rec"], kept["sub"], 5.0, True)
    assert got["dropped"] == 0 and got["rounds"] > 0
    assert got["searches_off_formula"] == 0
    assert 0.9 < got["cover_of_coord_segment"] <= 1.0
    assert set(S.ROUND_PHASES) <= set(got["phase_ms_per_round"])
