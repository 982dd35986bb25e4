"""What the program's spans say of a cell's runs, beside its result lines.
Not run by the benchmark.

Runs (one process builds the cell's query node once):

    python3 -m segbench.spancheck --workload bigann-1m.stream \
        --seeds 11,12,13 --trace 1,1,1 --seconds 30 --out spans.jsonl

Each run prints ``{"seed", "trace", "result"}`` and, when traced,
``"spans"``: the tracer's events and drops; the sub-window's idle and
device seconds by the innermost span (``segbench.spans``), and the sort
kernels' alone; the share of ``rank_kernel`` launches inside a
``round.stage`` phase and the median lead of a ``sync.*`` span's start
over its copy's runtime call (the two clocks' alignment); ``cudaMalloc``
seconds by span; the share of ``coord.segment`` time that
``search.prologue``, ``search.round`` and ``search.readback`` cover; each
round phase's host ms a round; and the segment searches whose ``syncs``
differ from 3R + 10 (R + 10 without compaction).

The tracer's cost (``--oncost PAIRS``):

    python3 -m segbench.spancheck --workload bigann-1m.stream \
        --seeds 11 --oncost 10

builds the node, searches one batch of the cell's shape drawn from the
seed untraced and traced in turns (ABBA, the same batch each time), and
prints each pair's ms a round, the paired difference's median and
quartiles, the events a round, the garbage collections each side made,
and what one round's spans and one sync span cost alone in a tight loop.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import collections  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from unittest import mock  # noqa: E402

COPY_CALLS = ("cudaMemcpyAsync", "cudaStreamSynchronize", "cudaMemcpy")
SEARCH_SPANS = ("search.prologue", "search.round", "search.readback")


def _inside(points, intervals) -> int:
    """How many of ``points`` lie inside one of ``intervals`` (sorted,
    disjoint (start, end) pairs)."""
    starts = [a for a, _ in intervals]
    n = 0
    for t in points:
        i = bisect.bisect_right(starts, t) - 1
        n += i >= 0 and t <= intervals[i][1]
    return n


def _sorted_items(d: dict) -> list:
    return sorted(d.items(), key=lambda kv: -kv[1])


def span_report(rec, sub, seconds: float, compact: bool) -> dict:
    """What the program's spans say of one traced run (see above)."""
    import numpy as np
    from segbench import devtrace, spans as S
    tr = rec.tracer
    ev = tr.events
    sp = S.program_spans(ev)
    dev, host, (lo, hi) = sub.window.events()
    gaps = devtrace.idle_gaps(devtrace.busy_intervals(
        devtrace.clip(dev, lo, hi)), lo, hi)
    cdev, runtime = S.correlated(sub.window)
    sorts = [e for e in cdev if "Sort" in e[0]]
    out = {"events": len(ev), "dropped": tr.dropped,
           "window_s": (hi - lo) / 1e6,
           "idle_s": sum(b - a for a, b in gaps) / 1e6,
           "idle_by_span": _sorted_items(S.idle_by_span(gaps, sp)),
           "device_by_span": _sorted_items(
               S.device_by_span(cdev, runtime, sp, lo, hi)),
           "sort_device_by_span": _sorted_items(
               S.device_by_span(sorts, runtime, sp, lo, hi))}

    # alignment: each rank_kernel's launch inside a round.stage phase
    stage = sorted((a, b) for n, a, b in sp if n == "round.stage")
    launches = [t for (n, a, b, _, _), t in zip(
        cdev, S.launch_times(cdev, runtime))
        if "rank_kernel" in n and lo <= a <= hi and t is not None]
    out["rank_launches"] = len(launches)
    out["rank_in_stage"] = (_inside(launches, stage) / len(launches)
                            if launches else None)
    calls = sorted(a for n, a, b in host if n in COPY_CALLS)
    lead = []
    for n, a, b in sp:
        if n.startswith("sync.") and lo <= a <= hi:
            i = bisect.bisect_left(calls, a)
            if i < len(calls) and calls[i] <= b:
                lead.append(calls[i] - a)
    out["sync_with_copy_call"] = len(lead)
    out["sync_copy_lead_us_median"] = (float(np.median(lead)) if lead
                                       else None)
    malloc = [(a, b) for n, a, b in host if n == "cudaMalloc"]
    out["cudaMalloc_by_span"] = S.idle_by_span(malloc, sp)

    # coverage, phases and the sync formula over the window's batches
    seg_us = cover_us = 0.0
    phase_us = collections.defaultdict(float)
    n_rounds = 0
    off_formula = []
    for b in rec.batches:
        if b["t_dispatch"] >= seconds:
            continue
        bsp = ev[b["spans"][0]:b["spans"][1]]
        seg_us += sum(e.dur_us for e in bsp if e.name == "coord.segment")
        cover_us += sum(e.dur_us for e in bsp if e.name in SEARCH_SPANS)
        r = 0
        for e in bsp:                       # spans close inner first
            if e.name.startswith("sync."):
                phase_us[e.name] += e.dur_us
            elif e.name == "search.round":
                r += 1
                for name, a, z in S.round_phases(e):
                    phase_us[name] += z - a
            elif e.name == "search.readback":
                want = (3 if compact else 1) * r + 10
                if e.args["syncs"] != want:
                    off_formula.append((e.args["syncs"], r))
                n_rounds += r
                r = 0
    out["cover_of_coord_segment"] = cover_us / seg_us if seg_us else None
    out["rounds"] = n_rounds
    out["phase_ms_per_round"] = (
        {k: v / 1e3 / n_rounds for k, v in sorted(phase_us.items())}
        if n_rounds else {})
    out["syncs_off_formula"] = off_formula[:10]
    out["searches_off_formula"] = len(off_formula)
    return out


def _quartiles(xs) -> list:
    return (statistics.quantiles(xs, n=4) if len(xs) > 1
            else [xs[0]] * 3)


def alone_us(tracer, n: int = 20_000) -> dict:
    """µs that one round's spans (a start, eight phase ends and the
    event) and one ``sync.*`` span (a read of a host value) cost alone."""
    from repro_torch.core import device_search as DS
    rnd, reads = DS.RoundSpans(tracer), DS.HostSyncs(tracer)
    out = {}
    t0 = time.perf_counter()
    for t in range(n):
        rnd.start()
        for _ in DS.ROUND_PHASES:
            rnd.end()
        rnd.close(t, False)
    out["round_us"] = (time.perf_counter() - t0) / n * 1e6
    t0 = time.perf_counter()
    for _ in range(n):
        reads.read("loop", bool, True)
    out["sync_us"] = (time.perf_counter() - t0) / n * 1e6
    tracer.clear()
    return out


def oncost(cell, seed: int, pairs: int, device: str, log=print) -> dict:
    """The tracer's cost on one batch of the cell's shape: ``pairs``
    untraced and traced searches in turns (see above)."""
    import torch
    from repro_torch.obs import Tracer, WallClock
    from segbench import data, harness
    cfg, traffic = cell.config, cell.traffic
    spec = cfg["data"]
    dev = torch.device(device)
    mix = data.mixture(spec, spec["data_seed"], dev)
    base = data.base_rows(mix, spec, sum(cfg["segments"]), dev).cpu().numpy()
    shape = max(harness.plugin("loops", traffic["loop"]).warm_shapes(
        traffic, spec["dim"]))
    q = data.sample(mix, spec, shape, seed, "queries", dev).cpu().numpy()
    node = harness.plugin("systems", cfg["system"]).build(cfg, base, dev)
    tracer = Tracer(WallClock())
    k = traffic["k"]

    def once(traced: bool):
        tracer.clear()
        node.coordinator.tracer = tracer if traced else None
        before = [s["collections"] for s in gc.get_stats()]
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        node.search(q, k)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        rounds = node.batch_counts(shape)["rounds"]
        gcs = [s["collections"] - b for s, b in zip(gc.get_stats(), before)]
        return ms / rounds, rounds, len(tracer.events), gcs

    for traced in (False, True):                     # warm-up
        once(traced)
    rows = []
    for i in range(pairs):
        order = (False, True) if i % 2 == 0 else (True, False)
        got = dict(zip(order, (once(t) for t in order)))
        (off, r_off, _, gc_off), (on, r_on, n_ev, gc_on) = \
            got[False], got[True]
        rows.append({"off_ms_per_round": off, "on_ms_per_round": on,
                     "rounds": r_on, "same_rounds": r_on == r_off,
                     "events_per_round": n_ev / r_on, "gc_off": gc_off,
                     "gc_on": gc_on})
        log(f"pair {i}: off {off:.4f} on {on:.4f} ms a round")
    node.coordinator.tracer = None
    diff = [r["on_ms_per_round"] - r["off_ms_per_round"] for r in rows]
    off = [r["off_ms_per_round"] for r in rows]
    return {"pairs": rows, "diff_ms_per_round_median": statistics.median(
                diff),
            "diff_ms_per_round_quartiles": _quartiles(diff),
            "off_ms_per_round_median": statistics.median(off),
            "events_per_round": statistics.median(
                r["events_per_round"] for r in rows),
            "alone_us": alone_us(tracer)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m segbench.spancheck")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--trace", default=None,
                    help="0 or 1 for each seed, comma-separated")
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--oncost", type=int, default=0,
                    help="pairs of the tracer's cost on one batch a seed")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch
    from segbench import harness
    if not torch.cuda.is_available():
        print("segbench.spancheck: no CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    traces = ([bool(int(t)) for t in args.trace.split(",")]
              if args.trace is not None else [])
    if not args.oncost and len(traces) != len(seeds):
        print("segbench.spancheck: one --trace flag a seed",
              file=sys.stderr)
        return 2

    def log(m):
        print(f"  {m}", file=sys.stderr)
    sink = open(args.out, "a") if args.out else None

    def emit(line):
        text = json.dumps(line)
        print(text, flush=True)
        if sink is not None:
            sink.write(text + "\n")
            sink.flush()

    if args.oncost:
        for seed in seeds:
            emit({"workload": args.workload, "seed": seed,
                  "oncost": oncost(cell, seed, args.oncost, "cuda", log)})
    else:
        compact = cell.config["search"]["compact_frac"] > 0
        builds = harness.BuildCache()
        kept = {}
        reading = harness.device_reading

        def keep_reading(sub, rec):
            kept["sub"], kept["rec"] = sub, rec
            return reading(sub, rec)

        with mock.patch.object(harness, "device_reading", keep_reading):
            for seed, trace in zip(seeds, traces):
                kept.clear()
                out = harness.run_cell(cell, seed, args.seconds, trace,
                                       "cuda", time.perf_counter(),
                                       build_node=builds, log=log)
                line = {"workload": args.workload, "seed": seed,
                        "trace": trace, "result": out}
                if trace and "sub" in kept:
                    line["spans"] = span_report(kept["rec"], kept["sub"],
                                                args.seconds, compact)
                emit(line)
    if sink is not None:
        sink.close()
    print(json.dumps({"seconds": time.perf_counter() - T_START,
                      "card": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
