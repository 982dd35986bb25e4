"""The round loop's spans and host-sync count (the port's
``core.device_search``: ``search.round``, whose ``phases`` arg holds the
ends of its ``ROUND_PHASES``, a ``sync.<site>`` span around each
blocking read of a device value, ``search.readback``'s ``syncs`` arg,
which is the segment search's ``batch_stats()["syncs"]``), reduced to
the per-layer metrics over the batches before the traced sub-window
(``Run.host_batches``, less any whose spans the tracer's head capture
cut), as ``segbench.reduce``'s host-side readers; each is ``None`` where
the program records no such span.

Below them, the sub-window's idle and device time put down to the
program's spans (``WallClock`` is on the profiler's time base):
``idle_by_span`` and ``device_by_span``, which ``segbench.spancheck``
reports beside a traced run.
"""
from __future__ import annotations

import bisect
import collections
from typing import Dict, List, Optional, Tuple

from segbench import devtrace

# the phases of a round in the loop's order, as the program names them
# (``repro_torch.core.device_search.ROUND_PHASES``; a test holds the two
# equal, and a program without them records no round)
ROUND_PHASES = ("round.compact", "round.pick", "round.stage",
                "round.account", "round.fold", "round.expand",
                "round.route", "round.merge")


def _batches(run) -> list:
    """``run.host_batches()`` whose spans the tracer kept whole: once it
    drops events (head capture), a batch's span range is cut or empty."""
    out = run.host_batches()
    tracer = getattr(run.rec, "tracer", None)
    if tracer is not None and tracer.dropped:
        out = [b for b in out if b["spans"][1] < tracer.max_events]
    return out


def _rounds(spans) -> list:
    return sorted((e for e in spans if e.name == "search.round"),
                  key=lambda e: e.ts_us)


def syncs_per_round(run) -> Optional[float]:
    """Blocking reads of device values over rounds, summed over the
    batches' segment searches."""
    syncs = rounds = 0
    for b in _batches(run):
        sp = run.batch_spans(b)
        n = sum(e.name == "search.round" for e in sp)
        if n:
            syncs += sum(e.args["syncs"] for e in sp
                         if e.name == "search.readback")
            rounds += n
    return syncs / rounds if rounds else None


def sync_wait_ms(run) -> Optional[float]:
    """The ``sync.*`` spans' time in the batches' segment searches (the
    loop tests between the rounds, the reads in them and the read-back
    copies), in ms over the ``search.round`` spans."""
    ms = rounds = 0
    for b in _batches(run):
        sp = run.batch_spans(b)
        n = sum(e.name == "search.round" for e in sp)
        if n:
            ms += sum(e.dur_us for e in sp
                      if e.name.startswith("sync.")) / 1e3
            rounds += n
    return ms / rounds if rounds else None


def issue_ms(run) -> Optional[float]:
    """The ``search.round`` spans' time less the ``sync.*`` spans that
    start inside them, in ms a round: the host's own time issuing a
    round's work."""
    ms = rounds = 0
    for b in _batches(run):
        sp = run.batch_spans(b)
        rs = _rounds(sp)
        if not rs:
            continue
        starts = [e.ts_us for e in rs]
        inside = 0.0
        for e in sp:
            if not e.name.startswith("sync."):
                continue
            i = bisect.bisect_right(starts, e.ts_us) - 1
            if i >= 0 and e.ts_us < rs[i].ts_us + rs[i].dur_us:
                inside += e.dur_us
        ms += (sum(e.dur_us for e in rs) - inside) / 1e3
        rounds += len(rs)
    return ms / rounds if rounds else None


# ------------------------------------------ the device trace by span

# the labels of what no program span, or no launch, accounts for
OUTSIDE = "(outside every span)"
NO_LAUNCH = "(launch not found)"


def round_phases(ev) -> List[Tuple[str, float, float]]:
    """A ``search.round`` event's phases as (name, start_us, end_us):
    each runs from the end of the one before (the round's start) to its
    own end."""
    out, t0 = [], ev.ts_us
    for name, t1 in zip(ROUND_PHASES, ev.args.get("phases", ())):
        out.append((name, t0, t1))
        t0 = t1
    return out


def program_spans(events) -> List[Tuple[str, float, float]]:
    """The program's ``obs.Tracer`` spans as (name, start_us, end_us),
    each round followed by its phases."""
    out = []
    for e in events:
        if e.ph != "X":
            continue
        out.append((e.name, e.ts_us, e.ts_us + e.dur_us))
        if e.name == "search.round":
            out += round_phases(e)
    return out


def correlated(window: devtrace.DeviceWindow):
    """A stopped ``DeviceWindow``'s raw events with their correlation
    ids: (device [(name, start_us, end_us, correlation, linked)],
    runtime {correlation: start_us} of the host's CUDA runtime and
    driver calls). A kernel or copy carries the correlation id of the
    runtime call that launched it; ``linked`` is that of the operator
    around the launch, where the profiler records one."""
    import torch
    cpu = torch.autograd.DeviceType.CPU
    device, runtime = [], {}
    for e in window.prof.profiler.kineto_results.events():
        a = e.start_ns() / 1e3
        if e.is_user_annotation():
            continue
        if e.device_type() == cpu:
            if e.name().startswith("cu"):
                runtime[e.correlation_id()] = a
        else:
            device.append((e.name(), a, a + e.duration_ns() / 1e3,
                           e.correlation_id(), e.linked_correlation_id()))
    return device, runtime


def idle_by_span(gaps, spans) -> Dict[str, float]:
    """Idle seconds by the innermost program span open at each gap's
    middle, ``OUTSIDE`` where none is (``devtrace.label_gaps`` over the
    spans, which nest)."""
    out = devtrace.label_gaps(gaps, spans)
    none = out.pop("(host between runtime calls)", 0.0)
    if none:
        out[OUTSIDE] = none
    return out


def launch_times(device, runtime) -> List[Optional[float]]:
    """The start of the runtime call that launched each device event
    (joined by its correlation id, else the linked one), or None."""
    return [runtime.get(corr, runtime.get(linked))
            for _, _, _, corr, linked in device]


def device_by_span(device, runtime, spans, lo: float,
                   hi: float) -> Dict[str, float]:
    """Device seconds in [lo, hi] by the innermost program span open
    when each kernel's or copy's runtime call started, ``NO_LAUNCH``
    where no call of the trace matches. Each event becomes an interval
    of its own length centred on its launch, labelled by its middle;
    times are taken relative to ``lo``, which keeps their low bits."""
    out: Dict[str, float] = collections.defaultdict(float)
    at = []
    for (_, a, b, _, _), t in zip(device, launch_times(device, runtime)):
        d = min(b, hi) - max(a, lo)
        if d <= 0:
            continue
        if t is None:
            out[NO_LAUNCH] += d / 1e6
        else:
            at.append((t - lo - d / 2, t - lo + d / 2))
    rel = [(n, a - lo, b - lo) for n, a, b in spans]
    for name, s in idle_by_span(at, rel).items():
        out[name] += s
    return dict(out)
