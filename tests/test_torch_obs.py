"""The port's observability plane (``repro_torch.obs``: clocks, tracer,
metrics registry, Chrome-trace export, calibration) and the serving
plane's spans and metrics, against the JAX package's ``repro.obs``.

The unit cases of ``tests/test_obs.py`` run on both packages with the
same inputs and their records must be equal (fitted constants within
1e-9 relative). Then the serving scenarios run under ``manual_tracer()``
(a ``ManualClock`` that ticks 1 µs a read) with a ``MetricsRegistry``:
every event (name, category, phase, timestamp, duration, track, args
with their Python types) and the registry's ``snapshot()`` must equal
JAX's, and each scenario untraced must return the same ids, distances
and stats as traced.
"""
import dataclasses
import json
from types import SimpleNamespace

import numpy as np
import pytest

import repro.core  # noqa: F401  (the JAX package's import order)
import repro.obs as JO
from repro.core import iostats as JI
from repro.core import params as JP
from repro.configs.starling_segment import SEGMENT_BENCH_ASYNC as J_ASYNC
from repro.core.params import HotTierParams, SegmentParams
from repro.core.segment import build_segment, save_segment
from repro.io import hottier as JH
from test_torch_serving import (JAX, TORCH, _device_server,  # noqa: F401
                                _two_servers, segs, two_segments)

import repro_torch.obs as TO
from repro_torch.core import iostats as TI
from repro_torch.core import params as TP
from repro_torch.configs import starling_segment as TSS
from repro_torch.core.segment import load_segment
from repro_torch.io import hottier as TH

CPU = "cpu"
JM = SimpleNamespace(**vars(JAX), O=JO, I=JI, P=JP,
                     hot_params=lambda p: p,
                     build_hot_tier=JH.build_hot_tier,
                     async_preset=J_ASYNC)
TM = SimpleNamespace(**vars(TORCH), O=TO, I=TI, P=TP,
                     hot_params=lambda p: TP.HotTierParams(
                         **dataclasses.asdict(p)),
                     build_hot_tier=lambda seg, p: TH.build_hot_tier(
                         seg, p, device=CPU),
                     async_preset=TSS.SEGMENT_BENCH_ASYNC)


def both(fn, *args, segs=None):
    """Run a scenario on both packages; their records must be equal."""
    recs = []
    for m in (JM, TM):
        extra = (segs[m.name],) if segs is not None else ()
        recs.append(fn(m, *extra, *args))
    assert recs[0] == recs[1]
    return recs[0]


def typed(obj):
    """``obj`` with every leaf paired with its type's name, so a numpy
    scalar or a tensor where JAX has a Python number shows."""
    if isinstance(obj, dict):
        return {k: typed(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [typed(v) for v in obj]
    return (type(obj).__name__, obj)


def events(tr):
    """A tracer's buffer as comparable records, args typed."""
    return [(e.name, e.cat, e.ph, e.ts_us, e.dur_us, e.track,
             typed(e.args)) for e in tr.events], tr.dropped


# ------------------------------------------------------------------ clocks

def _clocks(m):
    c = m.O.WallClock()
    ts = [c.now_us() for _ in range(100)]
    assert all(b >= a for a, b in zip(ts, ts[1:]))
    c = m.O.ManualClock(start_us=10.0)
    out = [c.now_us(), c.advance(5.0), c.now_us()]
    c.set(100.0)
    out.append(c.now_us())
    with pytest.raises(ValueError):
        c.advance(-1.0)
    with pytest.raises(ValueError):
        c.set(0.0)
    c = m.O.ManualClock(auto_tick_us=2.0)
    out.append((c.now_us(), c.now_us(), c.now_us()))
    return out


def test_clocks_equal_jax():
    assert both(_clocks) == [10.0, 15.0, 15.0, 100.0, (0.0, 2.0, 4.0)]


# ------------------------------------------------------------------ tracer

def _tracer_cases(m):
    out = []
    tr = m.O.Tracer(clock=m.O.ManualClock())
    with tr.span("host.search", cat="serve", track="seg0", k=10) as sp:
        tr.clock.advance(7.0)
        sp["block_reads"] = 42
    out.append(events(tr))
    tr = m.O.Tracer(clock=m.O.ManualClock())
    with pytest.raises(RuntimeError):
        with tr.span("coord.batch"):
            tr.clock.advance(3.0)
            raise RuntimeError("boom")
    out.append(events(tr))
    tr = m.O.manual_tracer(auto_tick_us=1.0)
    tr.event("sched.repack", cat="sched", target="seg0")
    tr.slice("device.round", ts_us=100.0, dur_us=5.0, live=8)
    out.append(events(tr))
    tr = m.O.Tracer(clock=m.O.ManualClock(auto_tick_us=1.0), max_events=3)
    for i in range(10):
        tr.event("e", i=i)
    out.append(events(tr))
    tr.clear()
    out.append((len(tr), tr.dropped))
    tr = m.O.manual_tracer()
    for name in ("a", "b", "a"):
        tr.event(name)
    out.append([len(tr.by_name(n)) for n in ("a", "b", "c")])
    return out


def test_tracer_equal_jax():
    """Spans with outcome args, a span closed by an exception, instants
    and explicit slices, head capture past ``max_events``, ``by_name``."""
    rec = both(_tracer_cases)
    assert rec[0][0][0][3:5] == (0.0, 7.0) and rec[3][1] == 7
    assert [a[6]["i"][1] for a in rec[3][0]] == [0, 1, 2]


# ----------------------------------------------------------------- metrics

def _metrics_cases(m):
    out = []
    c = m.O.Counter()
    c.inc()
    c.inc(4)
    out.append(c.value)
    with pytest.raises(ValueError):
        c.inc(-1)
    h = m.O.Histogram(window=4)
    for v in (1.0, 2.0, 3.0, 4.0, 100.0):
        h.observe(v)
    out.append((h.count, h.total, h.quantile(0.0), h.quantile(0.99),
                typed(h.summary()), m.O.Histogram().quantile(0.5)))
    r = m.O.MetricsRegistry()
    r.counter("serve.block_reads", "seg0").inc(10)
    r.counter("serve.block_reads", "seg1").inc(20)
    r.gauge("serve.cache_hit_rate").set(0.5)
    r.histogram("serve.batch_block_reads").observe(30)
    out.append((r.value("serve.block_reads", "seg0"), r.value("nope"),
                r.targets("serve.block_reads"), typed(r.snapshot())))
    r = m.O.MetricsRegistry()
    r.counter("serve.batches")
    for kind in (r.gauge, r.histogram):
        with pytest.raises(TypeError):
            kind("serve.batches")
    out.append(type(r.gauge("serve.batches", "segX")).__name__)
    return out


def test_metrics_equal_jax():
    """Counters, window quantiles (nearest rank), the registry's
    per-target attribution, snapshot and kind check."""
    rec = both(_metrics_cases)
    assert rec[0] == 5 and rec[1][4]["p50"] == ("float", 4.0)


# ------------------------------------------------------------------ export

def _demo(m):
    tr = m.O.Tracer(clock=m.O.ManualClock(auto_tick_us=1.0))
    with tr.span("coord.batch", track="coord", n_queries=8):
        tr.event("io.read", cat="io", track="io", block=3)
    return tr


def _export_cases(m, tmp):
    out = []
    obj = m.O.chrome_trace(_demo(m), metadata={"run": "t"})
    assert m.O.validate_chrome_trace(obj) == []
    out.append(obj)
    tr = m.O.Tracer(clock=m.O.ManualClock(auto_tick_us=1.0), max_events=1)
    tr.event("a")
    tr.event("b")
    out.append(m.O.chrome_trace(tr))
    path = tmp / m.name / "deep" / "trace.json"
    m.O.write_chrome_trace(path, _demo(m))
    with open(path) as f:
        loaded = json.load(f)
    assert m.O.validate_chrome_trace(loaded) == []
    out.append(loaded)
    bad = {"traceEvents": [
        {"ph": "Q", "name": "x", "pid": 1, "tid": 1},
        {"ph": "X", "pid": 1, "tid": 1, "ts": 0, "dur": 1},
        {"ph": "X", "name": "x", "pid": 1, "tid": 1, "ts": 0, "dur": -1},
        {"ph": "i", "name": "x", "pid": 1, "tid": 1, "ts": "a"},
        {"ph": "i", "name": "x", "pid": 1, "tid": 1, "ts": 0,
         "args": {"v": np.int64(3)}}]}
    out.append([m.O.validate_chrome_trace(x)
                for x in ([], {"traceEvents": 3}, bad)])
    return out


def test_export_equal_jax(tmp_path):
    """The Chrome trace object, the dropped count, the written file and
    the schema check's findings (a numpy int among the args is one)."""
    rec = both(_export_cases, tmp_path)
    assert len(rec[3][2]) == 5 and rec[1]["obs_dropped_events"] == 1


def _records(m):
    r = m.O.RoundRecord
    return [r(0, live=8, cold=10, tier0=2, joins=3, joins_x=1,
              compacted=False),
            r(1, live=4, cold=6, tier0=1, joins=1, joins_x=0,
              compacted=True, spec_hits=2, spec_wasted=1),
            r(2, live=1, cold=2, tier0=0, joins=0, joins_x=0,
              compacted=False, spec_hits=0, spec_wasted=3)]


def _timeline(m, dma_track, cm_name):
    cm = getattr(m.I, cm_name)
    tr = m.O.timeline_from_round_log(_records(m), cm, dma_track=dma_track)
    assert m.O.validate_chrome_trace(m.O.chrome_trace(tr)) == []
    tr2 = m.O.timeline_from_round_log(_records(m), cm, tracer=m.O.Tracer(
        clock=m.O.ManualClock()), track="dev", t0_us=50.0, batch=3,
        dma_track=dma_track)
    return events(tr), events(tr2)


@pytest.mark.parametrize("dma_track", [False, True],
                         ids=["rounds", "dma_track"])
@pytest.mark.parametrize("cm", ["TPU_HBM_SEGMENT", "NVME_SEGMENT"])
def test_timeline_from_round_log_equal_jax(dma_track, cm):
    """Modeled ``device.round`` slices (and with ``dma_track`` the demand
    and speculative DMA rows) priced through the port's ``CostModel``."""
    rec = both(_timeline, dma_track, cm)
    names = {e[0] for e in rec[0][0]}
    assert ("device.dma.spec" in names) == dma_track


# ------------------------------------------------------------- calibration

def _device_stats(m, io, t0, hops, saved, rounds):
    return m.I.IOStats.from_device(io, t0, hops, saved, rounds)


_ROWS = [(40, 5, 30, 4, 12), (80, 9, 55, 10, 20), (25, 2, 18, 1, 9),
         (60, 7, 44, 6, 16)]


def _fit_record(model, report, fields):
    return [getattr(model, f) for f in fields], report


def _same_fit(got, want):
    """Fitted constants within 1e-9 relative; the rest of the report
    (unfit, base, sample count) equal; errors within 1e-9."""
    (gc, gr), (wc, wr) = got, want
    assert gc == pytest.approx(wc, rel=1e-9, abs=1e-12)
    assert gr.keys() == wr.keys()
    for key in gr:
        if key == "fitted":
            assert gr[key].keys() == wr[key].keys()
            for f in gr[key]:
                assert gr[key][f] == pytest.approx(wr[key][f], rel=1e-9)
        elif key.startswith("error"):
            for f in wr[key]:
                assert gr[key][f] == pytest.approx(wr[key][f], rel=1e-9,
                                                   abs=1e-12)
        else:
            assert gr[key] == wr[key], key


def _recovery(m):
    truth = dataclasses.replace(m.I.TPU_HBM_SEGMENT, t_batch_block=0.7,
                                t_round=2.5, t_round_comp=0.3)
    samples = [m.O.CalibrationSample(_device_stats(m, *r),
                                     truth.latency_us(_device_stats(m, *r)))
               for r in _ROWS]
    fields = ("t_batch_block", "t_round", "t_round_comp")
    model, report = m.O.fit_cost_model(m.I.TPU_HBM_SEGMENT, samples, fields)
    for f in fields:
        assert getattr(model, f) == pytest.approx(getattr(truth, f),
                                                  abs=1e-6)
    assert report["unfit"] == []
    assert report["error_after"]["mean_abs_rel_err"] < 1e-9
    # the default fields on the same samples, and the pipelined regime
    out = [_fit_record(model, report, fields)]
    m2, r2 = m.O.fit_cost_model(m.I.TPU_HBM_SEGMENT, samples)
    assert tuple(r2["fields"]) == ("t_block_io", "t_batch_block", "t_round",
                                   "t_round_comp")     # DEFAULT_FIELDS
    out.append(_fit_record(m2, r2, r2["fields"]))
    piped = [dataclasses.replace(s, pipeline=True) for s in samples]
    m3, r3 = m.O.fit_cost_model(m.I.NVME_SEGMENT, piped)
    out.append(_fit_record(m3, r3, r3["fields"]))
    return out


def _unfit(m):
    samples = [m.O.CalibrationSample(m.I.IOStats(
        block_reads=r, cache_misses=r, hops=r), float(100 * r))
        for r in (5, 11, 23)]
    fields = ("t_block_io", "t_round", "t_round_comp")
    model, report = m.O.fit_cost_model(m.I.NVME_SEGMENT, samples,
                                       fields=fields)
    assert set(report["unfit"]) == {"t_round", "t_round_comp"}
    assert model.t_round == m.I.NVME_SEGMENT.t_round
    return [_fit_record(model, report, fields)]


def _clipped(m):
    with pytest.raises(ValueError):
        m.O.fit_cost_model(m.I.NVME_SEGMENT, [])
    s = [m.O.CalibrationSample(m.I.IOStats(block_reads=r, cache_misses=r),
                               0.0) for r in (3, 7)]
    model, report = m.O.fit_cost_model(m.I.NVME_SEGMENT, s,
                                       fields=("t_block_io",))
    assert model.t_block_io >= 0.0
    return [_fit_record(model, report, ("t_block_io",))]


@pytest.mark.parametrize("case", [_recovery, _unfit, _clipped],
                         ids=["recovery", "unfit", "clipped"])
def test_fit_cost_model_equals_jax(case):
    """Recovery of known device constants (the default fields too, and
    the pipelined host regime), unidentifiable fields reported ``unfit``
    with their base values, clipping at 0 and the empty-sample error."""
    for got, want in zip(case(TM), case(JM)):
        _same_fit(got, want)


def _preset(m, tmp):
    truth = dataclasses.replace(m.I.TPU_HBM_SEGMENT, t_round=4.0)
    stats = [_device_stats(m, 40, 5, 30, 4, 12),
             _device_stats(m, 70, 6, 50, 8, 18)]
    samples = [m.O.CalibrationSample(s, truth.latency_us(s)) for s in stats]
    path = tmp / f"{m.name}.json"
    model, preset, report = m.O.calibrate(
        m.I.TPU_HBM_SEGMENT, samples, fields=("t_round",),
        source="unit test", preset_path=str(path))
    loaded = m.O.CalibrationPreset.load(path)
    assert loaded == preset
    applied = loaded.apply(m.I.TPU_HBM_SEGMENT)
    assert applied.t_round == pytest.approx(4.0, abs=1e-6)
    assert applied.t_block_io == m.I.TPU_HBM_SEGMENT.t_block_io
    with pytest.raises(ValueError):
        loaded.apply(m.I.NVME_SEGMENT)
    return (dataclasses.asdict(applied), json.loads(path.read_text()),
            report["unfit"], report["n_samples"])


def test_calibrate_presets_equal_jax(tmp_path):
    """``calibrate`` fits, packages and stores a preset (to a temporary
    path): the stored JSON and the applied model are JAX's."""
    (ga, gj, gu, gn), (wa, wj, wu, wn) = _preset(TM, tmp_path), _preset(
        JM, tmp_path)
    assert gu == wu and gn == wn and ga.keys() == wa.keys()
    for f in wa:
        assert ga[f] == pytest.approx(wa[f], rel=1e-9), f
    assert gj["constants"]["t_round"] == pytest.approx(
        wj["constants"]["t_round"], rel=1e-9)
    assert {k: v for k, v in gj.items() if k not in ("constants", "error")
            } == {k: v for k, v in wj.items()
                  if k not in ("constants", "error")}


def test_obs_exports_equal_jax():
    assert TO.__all__ == JO.__all__


# ------------------------------------------ serving scenarios, traced

class _Fake:
    """Duck-typed device-less server: fixed results, zero traffic."""

    def __init__(self, offset=0):
        self.offset = offset

    def search(self, queries, k):
        n = queries.shape[0]
        return (np.tile(np.arange(k, dtype=np.int64), (n, 1)),
                np.ones((n, k), np.float32), np.zeros(n, np.int64))


def _fake_coordinator(m):
    tr, reg = m.O.manual_tracer(), m.O.MetricsRegistry()
    coord = m.QueryCoordinator([_Fake(0), _Fake(100)], tracer=tr,
                               metrics=reg)
    q = np.zeros((4, 8), np.float32)
    stats = [coord.search(q, k=3)[2] for _ in range(2)]
    return events(tr), typed(reg.snapshot()), stats


def test_fake_coordinator_spans_and_metrics_equal_jax():
    """``tests/test_obs.py``'s coordinator over two duck-typed servers:
    two batches, four segment spans, the ``serve.*`` registry."""
    (evs, _), snap, _ = both(_fake_coordinator)
    assert [e[0] for e in evs].count("coord.segment") == 4
    assert snap["serve.batches"][""] == ("float", 2.0)


def _serve(m, traced, make):
    """Build a scenario with ``make(m, tracer, metrics)`` -> (coord,
    batches), serve it, and return its record (and the obs record when
    traced)."""
    tr = m.O.manual_tracer() if traced else None
    reg = m.O.MetricsRegistry() if traced else None
    coord, batches, extra = make(m, tr, reg)
    out = []
    for qb in batches:
        gi, gd, st = coord.search(qb, k=10)
        out.append((gi.tolist(), np.asarray(gd), st))
    rec = (out, extra())
    if traced:
        return rec, (events(tr), typed(reg.snapshot()))
    return rec, None


def _check_scenario(make, dist_tol):
    """Traced and untraced runs in both packages: the events and the
    registry equal JAX's; ids and stats equal across the four runs;
    distances equal within each package and within ``dist_tol`` of
    JAX's; every ``STATS_SCHEMA`` total equal to the registry's."""
    runs = {}
    for m in (JM, TM):
        for traced in (True, False):
            runs[m.name, traced] = _serve(m, traced, make)
    assert runs["jax", True][1] == runs["torch", True][1]
    base = runs["jax", False][0]
    for key, (rec, _) in runs.items():
        out, extra = rec
        assert extra == base[1], key
        untraced = runs[key[0], False][0][0]
        for (gi, gd, st), (bi, bd, bst), (_, ud, _) in zip(
                out, base[0], untraced):
            assert gi == bi and st == bst, key
            np.testing.assert_array_equal(gd, ud)
            np.testing.assert_allclose(gd, bd, rtol=dist_tol,
                                       atol=dist_tol)
    (evs, dropped), snap = runs["torch", True][1]
    assert dropped == 0 and evs
    totals = {k: sum(st[k] for _, _, st in base[0])
              for k in ("total_block_reads", "total_tier0_hits",
                        "total_dedup_saved", "total_dedup_cross",
                        "total_spec_hits", "total_spec_wasted",
                        "total_hot_tier_hits")}
    for k, v in totals.items():
        assert snap[f"serve.{k}"][""] == ("float", float(v)), k
    return evs, snap


def _two_device(xs, q):
    def make(m, tr, reg):
        segs_m = make.segs[m.name]
        sched = m.RepackScheduler(m.RepackParams(interval_batches=1))
        coord = m.QueryCoordinator(_two_servers(m, segs_m, xs),
                                   scheduler=sched, tracer=tr,
                                   metrics=reg)
        return coord, [q[:8], q[8:]], lambda: sched.stats()
    return make


def test_coordinator_over_two_device_segments_traced(two_segments):
    """The coordinator over two device segments (one with a tier-0 pack)
    and a scheduler evaluating every batch: ``coord.batch``,
    ``coord.segment``, ``sched.eval`` events and the registry."""
    from repro.data.vectors import query_set
    xs, segs2 = two_segments
    make = _two_device(xs, query_set(np.concatenate(xs), 16, seed=3))
    make.segs = segs2
    evs, snap = _check_scenario(make, 2.5e-4)
    names = [e[0] for e in evs]
    assert names.count("coord.batch") == 2
    assert names.count("coord.segment") == 4
    assert names.count("sched.eval") == 2
    assert snap["sched.evals"][""] == ("float", 2.0)


def _async_host(q):
    def make(m, tr, reg):
        seg = make.segs[m.name]
        cp = m.async_preset.cache
        views = [m.cached_view(seg.view, seg.graph, cp) for _ in range(2)]
        servers = [m.host_server(view=v, params=seg.params.search,
                                 offset=off, num_vectors=seg.num_vectors)
                   for v, off in zip(views, (0, seg.num_vectors))]
        shared = m.attach_shared_fetch_queue(servers,
                                             depth=cp.queue_depth)
        coord = m.QueryCoordinator(servers, tracer=tr, metrics=reg)

        def extra():
            return ([s.cache_stats() for s in servers],
                    [[dataclasses.asdict(x) for x in s.last_stats]
                     for s in servers],
                    shared.submitted, shared.delivered, shared.reorders)
        return coord, [q[:8], q[8:16]], extra
    return make


def test_host_servers_async_queue_traced(segs, small_data):
    """Two host servers on ``SEGMENT_BENCH_ASYNC``'s tiered cache and one
    shared 8-deep queue: ``host.search``, ``io.read`` spans and the
    queue's ``io.fetch_submit`` / ``io.fetch_complete`` events, the
    ``io.*`` gauges ``cache_stats`` republishes."""
    make = _async_host(small_data[1])
    make.segs = segs
    evs, snap = _check_scenario(make, 0.0)
    names = {e[0] for e in evs}
    assert {"host.search", "io.read", "io.fetch_submit",
            "io.fetch_complete"} <= names
    assert set(snap["io.block_reads"]) == {"seg0",
                                           f"seg{segs['jax'].num_vectors}"}


def _drifted(x):
    def make(m, tr, reg):
        seg = make.segs[m.name]
        cview = m.cached_view(seg.view, seg.graph,
                              m.CacheParams(budget_frac=0.10))
        hserver = m.host_server(view=cview, params=seg.params.search,
                                offset=0, num_vectors=seg.num_vectors)
        server = _device_server(m, seg)
        sched = m.RepackScheduler(m.RepackParams(interval_batches=2,
                                                 hysteresis=0.2))
        sched.attach_feed(cview.store)
        coord = m.QueryCoordinator([server], scheduler=sched, tracer=tr,
                                   metrics=reg)
        cold_vid = np.flatnonzero(~np.isin(
            seg.view.layout.block_of, sorted(m.hot(server.segment))))
        rng = np.random.default_rng(3)
        qs = (x[rng.choice(cold_vid, 16)]
              + rng.normal(0, 0.01, (16, x.shape[1]))).astype(np.float32)
        hserver.search(qs)
        return coord, [qs] * 3, lambda: (sched.stats(),
                                         sorted(m.hot(server.segment)))
    return make


def test_scheduled_repack_traced(segs, small_data):
    """``test_torch_serving``'s drifted stream: the repack fires at the
    second batch; ``sched.repack`` and ``sched.eval`` events, the
    ``sched.*`` counters, and the same results traced and untraced."""
    make = _drifted(small_data[0])
    make.segs = segs
    evs, snap = _check_scenario(make, 2.5e-4)
    names = [e[0] for e in evs]
    assert names.count("sched.repack") == 1 and "sched.eval" in names
    assert snap["sched.repacks"][""] == ("float", 1.0)


def test_layout_swap_event_equals_jax(segs):
    def scenario(m, seg):
        tr = m.O.manual_tracer()
        sched = m.RepackScheduler(tracer=tr)
        server = _device_server(m, seg)
        sched.attach_target(server)
        sched._window.update({0: 3, 10 ** 6: 2})
        sched.note_layout_swap(server)
        return events(tr), dict(sched._window)
    (evs, _), window = both(scenario, segs=segs)
    assert [e[0] for e in evs] == ["sched.layout_swap"] and window == {0: 3}


N_HYB, DIM_HYB = 600, 24


@pytest.fixture(scope="module")
def hybrid_segs(tmp_path_factory):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((N_HYB, DIM_HYB)).astype(np.float32)
    q = rng.standard_normal((12, DIM_HYB)).astype(np.float32)
    seg = build_segment(x, SegmentParams())
    path = tmp_path_factory.mktemp("hyb") / "seg.npz"
    save_segment(seg, str(path))
    return q, {"jax": seg, "torch": load_segment(str(path))}


def _hybrid(q):
    def make(m, tr, reg):
        seg = make.segs[m.name]
        hot = m.build_hot_tier(seg, m.hot_params(HotTierParams(
            budget_frac=0.10)))
        srv = m.server(segment=m.from_segment(seg, tier0_frac=0.1),
                       offset=0, num_vectors=N_HYB, host=seg, hot_tier=hot)
        coord = m.QueryCoordinator([srv], tracer=tr, metrics=reg)
        return coord, [q[:6], q[6:]], lambda: (hot.size, hot.live_count)
    return make


def test_hybrid_hot_route_traced(hybrid_segs):
    """A hybrid server behind the coordinator: one ``hot.route`` span a
    batch, the ``hot.*`` gauges and counters."""
    q, segs_h = hybrid_segs
    make = _hybrid(q)
    make.segs = segs_h
    evs, snap = _check_scenario(make, 1e-4)
    assert [e[0] for e in evs].count("hot.route") == 2
    assert snap["hot.routed_queries"]["seg0"] == ("float", 12.0)
    assert snap["hot.size"]["seg0"][1] > 0
