"""What the traced run reads from the card: a ``torch.profiler`` trace
of a steady sub-window of whole batches, and each round-kernel launch's
inputs in that sub-window (for its least time, ``bounds``).

``KernelLaunches`` wraps the Python entry points of the round kernels
(``repro_torch.kernels.tier0_fetch.gather_union`` and
``fused_round_rank``) while it is active and restores them afterwards.
It keeps references to the launches' inputs and reads them only after
the sub-window has closed.
"""
from __future__ import annotations

import bisect
import collections
import time
from typing import Dict, List, Tuple

import torch

from segbench import bounds

class KernelLaunches:
    def __init__(self):
        self.records: List[tuple] = []

    def __enter__(self):
        from repro_torch.kernels import tier0_fetch as t0
        self._t0 = t0
        self._saved = (t0.gather_union, t0.fused_round_rank)
        union, rank = self._saved
        rec = self.records

        def gather_union(b, vecs, vid, nbrs):
            out = union(b, vecs, vid, nbrs)
            rec.append(("gather_union", b.numel(), out[0], tuple(vecs.shape),
                        nbrs.shape[2]))
            return out

        def fused_round_rank(queries, u, rank2d, uniq, hot_slot_of,
                             hot_vecs, hot_vid, hot_nbrs, tv, ti, tn,
                             n_expand, metric="l2", bq=t0.BQ):
            out = rank(queries, u, rank2d, uniq, hot_slot_of, hot_vecs,
                       hot_vid, hot_nbrs, tv, ti, tn, n_expand,
                       metric=metric, bq=bq)
            rec.append(("fused_round_rank", u, uniq, tuple(tv.shape),
                        tn.shape[2], n_expand, bq))
            return out

        t0.gather_union = gather_union
        t0.fused_round_rank = fused_round_rank
        return self

    def __exit__(self, *exc):
        self._t0.gather_union, self._t0.fused_round_rank = self._saved
        return False

    def least_s(self) -> Dict[str, float]:
        """The summed least time of the recorded launches, by wrapper."""
        out = collections.defaultdict(float)
        for r in self.records:
            uniq = r[2]
            ndist = 1 + int((uniq[1:] > uniq[:-1]).sum()) if len(uniq) else 0
            if r[0] == "gather_union":
                _, n, _, (rho, eps, d), lam = r
                out[r[0]] += bounds.gather_union_least_s(n, ndist, eps, d,
                                                         lam)
            else:
                _, u, _, (_, eps, d), lam, n_expand, bq = r
                qn, f = u.shape
                tiles = (u.reshape(-1, bq * f) >= 0).any(1)
                out[r[0]] += bounds.rank_least_s(
                    qn, f, int(tiles.sum()) * bq, ndist, eps, d, lam,
                    n_expand)
        return dict(out)


class DeviceWindow:
    """A profiler over the sub-window. On the card it records the CUDA
    activity alone (kernels, copies and the runtime calls that launch
    them; recording every operator on the host would slow a host-bound
    loop). The sub-window's bounds are read on the wall clock
    (``time.time_ns``), the profiler's own time base, each after a
    synchronise."""

    def __init__(self):
        self.prof = None
        self.bounds_us = (0.0, 0.0)

    @staticmethod
    def _activities():
        if torch.cuda.is_available():
            return [torch.profiler.ProfilerActivity.CUDA]
        return [torch.profiler.ProfilerActivity.CPU]

    @staticmethod
    def prepare() -> None:
        """Import, in set-up, what the profiler's first start imports
        (``torch._dynamo``, seconds), without starting it: a profiler
        started in set-up left every later round of the traced runs
        ~40% slower (10.8-11.1 against ~7.5 ms), the batches before the
        sub-window too."""
        import torch._dynamo  # noqa: F401

    @staticmethod
    def _now_us() -> float:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        return time.time_ns() / 1e3

    def start(self) -> None:
        self.prof = torch.profiler.profile(activities=self._activities())
        self.prof.start()
        self._lo = self._now_us()

    def stop(self) -> None:
        self.bounds_us = (self._lo, self._now_us())
        self.prof.stop()

    def events(self):
        """(device [(name, start_us, end_us)], host [(name, start_us,
        end_us)], (start_us, end_us) of the sub-window), from the
        profiler's raw events; device ranges of annotations are left
        out."""
        cpu = torch.autograd.DeviceType.CPU
        device, host = [], []
        for e in self.prof.profiler.kineto_results.events():
            a = e.start_ns() / 1e3
            row = (e.name(), a, a + e.duration_ns() / 1e3)
            if e.device_type() == cpu:
                host.append(row)
            elif not e.is_user_annotation():
                device.append(row)
        return device, host, self.bounds_us


def clip(events, lo: float, hi: float):
    return [(n, max(a, lo), min(b, hi)) for n, a, b in events
            if b > lo and a < hi and min(b, hi) > max(a, lo)]


def busy_intervals(device) -> List[Tuple[float, float]]:
    """The union of the device events' intervals, merged, in order."""
    out: List[List[float]] = []
    for _, a, b in sorted(device, key=lambda e: e[1]):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def idle_gaps(busy, lo: float, hi: float) -> List[Tuple[float, float]]:
    gaps, t = [], lo
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def short_name(name: str) -> str:
    """A kernel's name without its return type, template arguments and
    parameters."""
    name = name.replace("(anonymous namespace)::", "")
    name = name[5:] if name.startswith("void ") else name
    return name.split("(")[0].split("<")[0].strip()


def label_gaps(gaps, host) -> Dict[str, float]:
    """Idle seconds by the innermost host event open at each gap's
    middle (a runtime call such as a launch or a copy), or "(host
    between runtime calls)" where none is: the interpreter's own
    work."""
    host = sorted(host, key=lambda e: (e[1], -e[2]))
    starts = [e[1] for e in host]
    out = collections.defaultdict(float)
    stack: list = []
    j = 0
    for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = 0.5 * (a + b)
        hi = bisect.bisect_right(starts, mid)
        while j < hi:
            while stack and stack[-1][2] <= host[j][1]:
                stack.pop()
            stack.append(host[j])
            j += 1
        while stack and stack[-1][2] < mid:
            stack.pop()
        name = stack[-1][0] if stack else "(host between runtime calls)"
        out[name] += (b - a) / 1e6
    return dict(out)
