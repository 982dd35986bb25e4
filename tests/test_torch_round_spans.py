"""The spans and the host-sync count inside the port's device round loop
(``core.device_search``: ``search.*``, ``round.*``, ``sync.*``), on
``test_torch_serving``'s small segment, and ``obs.WallClock``'s epoch
base.

A tracer must change nothing the search returns or counts; under
``manual_tracer()`` every round's phases end in order inside it, and the
``sync.*`` spans are exactly the reads that ``batch_stats()["syncs"]``
counts: per segment search of R rounds, R + 1 loop tests, 2R compaction
tests with ``compact_frac`` > 0 and nine copies of the results.
"""
import dataclasses
import time

import numpy as np
import pytest

from test_torch_serving import TORCH, _device_server, segs  # noqa: F401

from repro_torch.core import device_search as TDS
from repro_torch.obs import Tracer, WallClock, manual_tracer
from repro_torch.serving.coordinator import QueryCoordinator

PHASES = ("round.compact", "round.pick", "round.stage", "round.account",
          "round.fold", "round.expand", "round.route", "round.merge")


def _server(seg, **knobs):
    srv = _device_server(TORCH, seg)
    srv.params = dataclasses.replace(srv.params, **knobs)
    return srv


def _served(srv, q, tracer=None):
    """One batch through a coordinator that got its tracer after it was
    built -> (ids, dists, batch_stats)."""
    coord = QueryCoordinator([srv])
    coord.tracer = tracer
    ids, dists, _ = coord.search(q, k=10)
    return ids, dists, srv.batch_stats()


def _within(inner, outer):
    return (outer.ts_us <= inner.ts_us
            and inner.ts_us + inner.dur_us <= outer.ts_us + outer.dur_us)


@pytest.mark.parametrize("speculate", [False, True])
@pytest.mark.parametrize("compact_frac", [0.0, 0.25])
def test_tracer_changes_no_result_or_counter(segs, small_data,  # noqa: F811
                                             compact_frac, speculate):
    q = small_data[1]
    srv = _server(segs["torch"], compact_frac=compact_frac,
                  speculate=speculate)
    plain = _served(srv, q)
    tr = manual_tracer()
    traced = _served(srv, q, tr)
    assert tr.by_name("search.round") and tr.dropped == 0
    for a, b in zip(plain[:2], traced[:2]):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert set(plain[2]) == set(traced[2])
    for name, v in plain[2].items():
        w = traced[2][name]
        if isinstance(v, np.ndarray):
            assert v.dtype == w.dtype and v.tobytes() == w.tobytes(), name
        else:
            assert v == w, name


@pytest.mark.parametrize("compact_frac", [0.0, 0.25])
def test_rounds_hold_their_phases_and_syncs_are_counted(
        segs, small_data, compact_frac):  # noqa: F811
    q = small_data[1][:6]
    srv = _server(segs["torch"], compact_frac=compact_frac)
    tr = manual_tracer()
    _, _, st = _served(srv, q, tr)
    r = st["rounds"]
    assert 0 < r < srv.params.max_hops
    rounds = tr.by_name("search.round")
    assert len(rounds) == r
    assert [e.args["t"] for e in rounds] == list(range(r))
    assert all(isinstance(e.args["fired"], bool) for e in rounds)
    assert TDS.ROUND_PHASES == PHASES
    for rnd in rounds:
        ends = rnd.args["phases"]
        # one clock read a phase end: each phase lasts at least a tick
        assert len(ends) == len(PHASES)
        assert all(b > a for a, b in zip((rnd.ts_us,) + ends, ends))
        assert ends[-1] == rnd.ts_us + rnd.dur_us
    assert not any(e.name.startswith("round.") for e in tr.events)
    syncs = [e for e in tr.events if e.name.startswith("sync.")]
    assert len(syncs) == st["syncs"]
    by_site = {n: [e for e in syncs if e.name == n]
               for n in ("sync.loop", "sync.compact", "sync.readback")}
    assert sum(map(len, by_site.values())) == len(syncs)
    assert len(by_site["sync.loop"]) == r + 1
    assert not any(_within(e, rnd) for e in by_site["sync.loop"]
                   for rnd in rounds)
    assert len(by_site["sync.compact"]) == (2 * r if compact_frac else 0)
    for e in by_site["sync.compact"]:          # inside round.compact
        assert any(rnd.ts_us < e.ts_us
                   and e.ts_us + e.dur_us < rnd.args["phases"][0]
                   for rnd in rounds)
    (readback,) = tr.by_name("search.readback")
    assert len(by_site["sync.readback"]) == 9
    assert all(_within(e, readback) for e in by_site["sync.readback"])
    assert st["syncs"] == (3 if compact_frac else 1) * r + 10
    (prologue,) = tr.by_name("search.prologue")
    (seg_span,) = tr.by_name("coord.segment")
    for e in [prologue, readback] + rounds + syncs:
        assert _within(e, seg_span)
    assert prologue.ts_us + prologue.dur_us <= rounds[0].ts_us
    assert rounds[-1].ts_us + rounds[-1].dur_us <= readback.ts_us


def test_a_loop_stopped_at_max_hops_makes_one_test_a_round(
        segs, small_data):  # noqa: F811
    srv = _server(segs["torch"], compact_frac=0.0, max_hops=3)
    tr = manual_tracer()
    _, _, st = _served(srv, small_data[1][:6], tr)
    assert st["rounds"] == 3
    assert len(tr.by_name("sync.loop")) == 3
    assert st["syncs"] == 3 + 9


def test_one_query_makes_one_compaction_test_a_round(
        segs, small_data):  # noqa: F811
    srv = _server(segs["torch"], compact_frac=0.25)
    _, _, st = _served(srv, small_data[1][:1])
    r = st["rounds"]
    assert st["syncs"] == (r + 1) + r + 9


def test_the_coordinators_tracer_is_the_one_switch(
        segs, small_data):  # noqa: F811
    q = small_data[1][:4]
    srv = _server(segs["torch"])
    tr = manual_tracer()
    coord = QueryCoordinator([srv])
    coord.search(q, k=10)
    coord.tracer = tr                  # set after construction
    coord.search(q, k=10)
    n = len(tr)
    assert tr.by_name("search.prologue") and tr.by_name("sync.readback")
    coord.tracer = None                # and off again
    coord.search(q, k=10)
    assert len(tr) == n
    tr2 = manual_tracer()
    QueryCoordinator([srv], tracer=tr2).search(q, k=10)
    assert tr2.by_name("search.round") and len(tr) == n


def test_host_syncs_count_with_or_without_a_tracer():
    import torch
    x = torch.arange(4)
    plain = TDS.HostSyncs()
    assert plain.read("a", bool, (x > 2).any()) is True
    assert plain.read("b", TDS.to_numpy, x).tolist() == [0, 1, 2, 3]
    assert plain.count == 2
    tr = manual_tracer()
    traced = TDS.HostSyncs(tr)
    assert traced.read("loop", float, x.float().mean()) == 1.5
    assert traced.count == 1
    (e,) = tr.events
    assert (e.name, e.cat, e.ph, e.track) == ("sync.loop", "search", "X",
                                              TDS.SEARCH_TRACK)
    assert e.dur_us == 1.0 and e.args == {}


def test_round_spans_read_the_clock_once_a_phase_end():
    tr = manual_tracer()
    rnd = TDS.RoundSpans(tr)
    rnd.start()
    for _ in PHASES:
        rnd.end()
    rnd.close(7, True)
    (e,) = tr.events
    assert (e.name, e.cat, e.ph, e.track) == ("search.round", "search", "X",
                                              TDS.SEARCH_TRACK)
    assert e.ts_us == 0.0 and e.dur_us == len(PHASES)
    assert e.args == {"t": 7, "fired": True, "graph": False,
                      "phases": tuple(float(i) for i in range(1, 9))}
    assert tr.clock.now_us() == len(PHASES) + 1     # nine reads in all
    # without a tracer the loop's phase ends do nothing
    none = TDS._NO_ROUND_SPANS
    none.start()
    none.end()
    none.close(0, False)


def test_wall_clock_is_monotonic_on_the_epoch_base():
    c = WallClock()
    ts = [c.now_us() for _ in range(10_000)]
    assert all(b >= a for a, b in zip(ts, ts[1:]))
    for _ in range(5):
        before = time.time_ns() / 1e3
        now = c.now_us()
        after = time.time_ns() / 1e3
        assert before - 1e3 <= now <= after + 1e3
    assert Tracer().clock.now_us() == pytest.approx(time.time_ns() / 1e3,
                                                    abs=1e3)
