"""The reductions that the metric readers share, from a ``harness.Run``
to one number (``None`` where the run holds nothing to read).

Times on the host's clock are seconds after the window's start; spans
are the port's ``obs.Tracer`` events (µs); the host-side layer metrics
read the batches before the traced sub-window (``Run.host_batches``),
the device figures those of the sub-window.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from segbench import bounds


def setup_s(run) -> float:
    return run.setup_s


def qps(run) -> Optional[float]:
    """Queries of the batches that finished inside the window, over the
    time from the window's start to the last of them."""
    done = [b for b in run.rec.batches if b["t_done"] <= run.seconds]
    if not done:
        return None
    return sum(b["n_valid"] for b in done) / max(b["t_done"] for b in done)


def latency_p95_ms(run) -> Optional[float]:
    """95th percentile over every request due in the window, from its
    scheduled arrival to its answer on the host, those answered in the
    drain after the window included; one never answered counts at the
    loop's end."""
    idx = run.window_requests()
    if not len(idx):
        return None
    done = run.rec.done[idx]
    end = run.rec.t_end if run.rec.t_end is not None else run.seconds
    done = np.where(np.isfinite(done), done, max(end, run.seconds))
    return float(np.percentile(done - run.rec.arrival[idx], 95)) * 1e3


def recall_at_10(run) -> Optional[float]:
    return run.check.get("recall")


def queue_wait_ms(run) -> Optional[float]:
    """Median, over the requests of ``host_batches``, of scheduled
    arrival to their batch's dispatch."""
    bs = run.host_batches()
    if not bs:
        return None
    last = bs[-1]["t_dispatch"]
    d = run.rec.dispatch
    idx = np.nonzero(np.isfinite(d) & (d <= last))[0]
    return float(np.median(d[idx] - run.rec.arrival[idx])) * 1e3


def batch_queries(run) -> Optional[float]:
    bs = run.host_batches()
    return float(np.mean([b["n_valid"] for b in bs])) if bs else None


def coord_self_ms(run) -> Optional[float]:
    """Mean per batch of the ``coord.batch`` span less the
    ``coord.segment`` spans inside it."""
    own = []
    for b in run.host_batches():
        sp = run.batch_spans(b)
        whole = [e.dur_us for e in sp if e.name == "coord.batch"]
        if not whole:
            continue
        segs = sum(e.dur_us for e in sp if e.name == "coord.segment")
        own.append((whole[0] - segs) / 1e3)
    return float(np.mean(own)) if own else None


def rounds_per_batch(run) -> Optional[float]:
    """Rounds a batch takes, summed over the segments it visits."""
    bs = run.host_batches()
    return float(np.mean([b["rounds"] for b in bs])) if bs else None


def ms_per_round(run) -> Optional[float]:
    """The ``coord.segment`` spans' time over the rounds they ran."""
    ms = rounds = 0
    for b in run.host_batches():
        segs = [e.dur_us for e in run.batch_spans(b)
                if e.name == "coord.segment"]
        if segs:
            ms += sum(segs) / 1e3
            rounds += b["rounds"]
    return ms / rounds if rounds else None


def io_per_query(run) -> Optional[float]:
    """Block reads a query takes, summed over the segments it visits."""
    bs = run.host_batches()
    n = sum(b["n_valid"] for b in bs)
    return sum(b["io"] for b in bs) / n if n else None


def round_kernels_roofline(run) -> Optional[float]:
    """The round kernels' summed least time over their summed device
    time in the sub-window, in percent."""
    d = run.device
    if not d or not d["least_s"]:
        return None
    spent = sum(s for n, s in d["kernel_s"].items()
                if n in bounds.ROUND_KERNELS)
    if spent <= 0:
        return None
    return 100.0 * sum(d["least_s"].values()) / spent


def device_idle(run) -> Optional[float]:
    """1 - (union of the device's activity / wall) over the sub-window."""
    d = run.device
    if not d or d["busy_s"] <= 0:
        return None
    return 1.0 - d["busy_s"] / d["window_s"]


def launches_per_round(run) -> Optional[float]:
    """Device kernels in the sub-window (the library's included) over
    the rounds of its batches."""
    d = run.device
    if not d or not d["kernels"] or not d["rounds"]:
        return None
    return d["kernels"] / d["rounds"]


def build_graph_s(run) -> Optional[float]:
    """The disk-graph stage of the build, summed over the segments."""
    t = [bt["disk_graph_s"] for bt in run.build_times if "disk_graph_s" in bt]
    return float(sum(t)) if t else None
