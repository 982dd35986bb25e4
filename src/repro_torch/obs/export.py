"""Chrome-trace-event / Perfetto JSON export (port of ``repro.obs.export``).

Converts a ``Tracer`` buffer into the Chrome trace-event JSON object
format (the dialect ``ui.perfetto.dev`` and ``chrome://tracing`` both
load): ``{"traceEvents": [...], "displayTimeUnit": "ms"}`` with
complete spans (``ph="X"``, µs timestamps/durations) and instants
(``ph="i"``). Tracks map to Chrome thread ids — one row per track,
named via ``"M"`` (metadata) events — so a coordinator batch, the
store's reads, the scheduler's decisions, and the modeled device
rounds each render on their own timeline row.

``validate_chrome_trace`` is the schema check ``chip_smoke.py`` runs on
its export: no external JSON-schema dependency, just the structural
rules the viewers actually require.

``timeline_from_round_log`` renders a folded device round log
(``obs.roundlog``) as back-to-back *modeled* ``device.round``
slices priced through a ``CostModel`` — the per-round view of where a
batch's lockstep chain spent its modeled time (args carry the raw
counters so the viewer shows live/cold/tier0/joins per round).
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

from repro_torch.obs.trace import TraceEvent, Tracer

PID = 1  # single-process traces; tracks are rendered as threads


def chrome_trace(tracer: Tracer,
                 metadata: Optional[Dict] = None) -> Dict:
    """``Tracer`` buffer -> Chrome trace-event JSON object format."""
    tids: Dict[str, int] = {}
    events: List[Dict] = []
    for ev in tracer.events:
        tid = tids.get(ev.track)
        if tid is None:
            tid = tids[ev.track] = len(tids) + 1
        rec = {"name": ev.name, "cat": ev.cat, "ph": ev.ph,
               "ts": ev.ts_us, "pid": PID, "tid": tid}
        if ev.ph == "X":
            rec["dur"] = ev.dur_us
        if ev.ph == "i":
            rec["s"] = "t"          # instant scope: thread
        if ev.args:
            rec["args"] = dict(ev.args)
        events.append(rec)
    # thread-name metadata first, so viewers label rows on load
    meta_events = [{"name": "thread_name", "ph": "M", "pid": PID,
                    "tid": tid, "args": {"name": track}}
                   for track, tid in tids.items()]
    out = {"traceEvents": meta_events + events, "displayTimeUnit": "ms"}
    if tracer.dropped:
        out["obs_dropped_events"] = tracer.dropped
    if metadata:
        out["metadata"] = dict(metadata)
    return out


def write_chrome_trace(path, tracer: Tracer,
                       metadata: Optional[Dict] = None) -> Dict:
    """Export + write to ``path``; returns the exported object."""
    obj = chrome_trace(tracer, metadata=metadata)
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)
    return obj


def validate_chrome_trace(obj) -> List[str]:
    """Structural schema check; returns a list of problems (empty =
    valid). Covers the rules the Perfetto/Chrome loaders enforce:
    object format with a ``traceEvents`` list; every event has
    ``name``/``ph``/``pid``/``tid``; ``ph`` is one we emit; ``X``
    events carry numeric non-negative ``ts``+``dur``; instants carry
    ``ts``; args, when present, are JSON-serializable dicts."""
    problems: List[str] = []
    if not isinstance(obj, dict):
        return [f"top level must be an object, got {type(obj).__name__}"]
    evs = obj.get("traceEvents")
    if not isinstance(evs, list):
        return ["traceEvents must be a list"]
    for i, ev in enumerate(evs):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            problems.append(f"{where}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in ("X", "i", "M"):
            problems.append(f"{where}: unsupported ph {ph!r}")
            continue
        for key in ("name", "pid", "tid"):
            if key not in ev:
                problems.append(f"{where}: missing {key!r}")
        if ph in ("X", "i"):
            ts = ev.get("ts")
            if not isinstance(ts, (int, float)):
                problems.append(f"{where}: ts must be a number")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(
                    f"{where}: X event needs numeric dur >= 0")
        args = ev.get("args")
        if args is not None:
            if not isinstance(args, dict):
                problems.append(f"{where}: args must be an object")
            else:
                try:
                    json.dumps(args)
                except (TypeError, ValueError) as e:
                    problems.append(f"{where}: args not serializable: {e}")
    return problems


def timeline_from_round_log(records: Sequence, cost_model,
                            tracer: Optional[Tracer] = None,
                            track: str = "device", t0_us: float = 0.0,
                            batch: int = 0,
                            dma_track: bool = False) -> Tracer:
    """Render folded ``RoundRecord``s as modeled back-to-back
    ``device.round`` slices.

    Each round's modeled duration is its share of the round-granular
    regime: the lockstep ``t_round`` chain unit, the occupancy-weighted
    compute (``live x t_round_comp``), and its cold DMAs streaming at
    ``t_batch_block`` (falling back to ``t_block_io`` when the model
    has no streaming rate — matching ``CostModel._io_time``). Durations
    are *modeled*, so the slices go in with explicit timing
    (``Tracer.slice``), not the tracer's clock.

    ``dma_track=True`` additionally renders the gather stream on its
    own ``<track>.dma`` row so the ``max(dma, compute)`` overlap the
    cost model prices is visible in Perfetto instead of serialized
    into the round slice: each round's demand stream
    (``cold - joins - spec_hits`` blocks) starts WITH the round slice
    (overlapping its compute), and a round's speculatively consumed +
    wasted blocks (``spec_hits + spec_wasted``) render as a
    ``device.dma.spec`` slice back in the PREVIOUS round — where their
    copies were actually in flight, overlapping that round's
    expansion/top-M compute (DESIGN.md §9). Round boundaries (and the
    round slices themselves) are unchanged either way, so the default
    rendering stays bit-compatible."""
    from repro_torch.obs.trace import manual_tracer

    tr = tracer if tracer is not None else manual_tracer(auto_tick_us=0.0)
    t_stream = (cost_model.t_batch_block if cost_model.t_batch_block
                else cost_model.t_block_io)
    t = float(t0_us)
    prev_t = float(t0_us)
    for r in records:
        spec_h = getattr(r, "spec_hits", 0)
        spec_w = getattr(r, "spec_wasted", 0)
        dur = (cost_model.t_round
               + r.live * cost_model.t_round_comp
               + (r.cold - r.joins) * t_stream
               + r.tier0 * cost_model.t_tier0_hit
               + r.joins * cost_model.t_dedup_hit)
        args = {"live": r.live, "cold": r.cold, "tier0": r.tier0,
                "joins": r.joins, "joins_x": r.joins_x,
                "compacted": r.compacted, "spec_hits": spec_h,
                "spec_wasted": spec_w}
        if batch:
            args["batch"] = batch
        tr.slice("device.round", ts_us=t, dur_us=max(dur, 0.0),
                 cat="device", track=track, **args)
        if dma_track:
            demand = max(r.cold - r.joins - spec_h, 0)
            if demand > 0:
                tr.slice("device.dma", ts_us=t,
                         dur_us=demand * t_stream, cat="device",
                         track=f"{track}.dma", blocks=demand,
                         round=r.round)
            spec_blocks = spec_h + spec_w
            if spec_blocks > 0:
                # issued while the PREVIOUS round's expansion/top-M
                # maintenance ran — render it there, overlapping
                tr.slice("device.dma.spec", ts_us=prev_t,
                         dur_us=spec_blocks * t_stream, cat="device",
                         track=f"{track}.dma", spec_hits=spec_h,
                         spec_wasted=spec_w, round=r.round)
        prev_t = t
        t += max(dur, 0.0)
    return tr
