"""Serving-plane metrics registry (port of ``repro.obs.metrics``).

Three instrument kinds — monotone ``Counter``s, last-value ``Gauge``s,
and windowed ``Histogram``s with p50/p95/p99 — keyed by
``(name, target)`` so one registry attributes the same metric to many
targets (segments, stores, schedulers). The ``QueryCoordinator``'s
per-batch stats dict and ``HostSegmentServer.cache_stats()`` are
re-expressed through a registry: the dicts they return are *views* of
registry state, so a dashboard scraping ``snapshot()`` and a caller
reading the stats dict can never disagree.

Naming conventions (DESIGN.md §6): dotted ``plane.metric`` names
(``serve.batches``, ``serve.block_reads``, ``io.cache_hits``,
``sched.repacks``); targets are short stable strings (``seg0``, the
segment offset, or ``""`` for plane-global). Units ride in the name
suffix where ambiguous (``_us``, ``_bytes``).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, Optional, Tuple


class Counter:
    """Monotone counter."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError("counters only go up (use a Gauge)")
        self.value += n


class Gauge:
    """Last-written value."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Sliding-window distribution with exact small-window quantiles.

    ``window`` bounds memory; the quantiles are computed over the most
    recent ``window`` observations (a serving dashboard wants *recent*
    p99, not lifetime). ``count``/``total`` are lifetime."""

    __slots__ = ("_win", "count", "total")

    def __init__(self, window: int = 1024):
        self._win: deque = deque(maxlen=int(window))
        self.count = 0
        self.total = 0.0

    def observe(self, v: float) -> None:
        v = float(v)
        self._win.append(v)
        self.count += 1
        self.total += v

    def quantile(self, q: float) -> float:
        """Exact quantile of the window (nearest-rank); 0 when empty."""
        if not self._win:
            return 0.0
        xs = sorted(self._win)
        i = min(int(q * len(xs)), len(xs) - 1)
        return xs[i]

    def summary(self) -> Dict[str, float]:
        n = len(self._win)
        return {"count": self.count,
                "mean": (self.total / self.count) if self.count else 0.0,
                "window": n,
                "p50": self.quantile(0.50),
                "p95": self.quantile(0.95),
                "p99": self.quantile(0.99),
                "max": max(self._win) if n else 0.0}


@dataclasses.dataclass(frozen=True)
class _Key:
    name: str
    target: str


class MetricsRegistry:
    """Create-on-first-use instrument store with per-target attribution.

    One registry per serving process; every instrument is identified by
    ``(name, target)``. Asking for an existing name with a different
    instrument kind is an error — a metric's kind is part of its
    schema."""

    def __init__(self):
        self._metrics: Dict[Tuple[str, str], object] = {}

    def _get(self, name: str, target: str, kind, **kw):
        key = (name, target)
        m = self._metrics.get(key)
        if m is None:
            m = kind(**kw)
            self._metrics[key] = m
        elif not isinstance(m, kind):
            raise TypeError(
                f"metric {name!r} (target {target!r}) already registered "
                f"as {type(m).__name__}, not {kind.__name__}")
        return m

    def counter(self, name: str, target: str = "") -> Counter:
        return self._get(name, target, Counter)

    def gauge(self, name: str, target: str = "") -> Gauge:
        return self._get(name, target, Gauge)

    def histogram(self, name: str, target: str = "",
                  window: int = 1024) -> Histogram:
        return self._get(name, target, Histogram, window=window)

    # ------------------------------------------------------------- views
    def value(self, name: str, target: str = "") -> Optional[float]:
        m = self._metrics.get((name, target))
        if m is None:
            return None
        return m.value if not isinstance(m, Histogram) else m.count

    def snapshot(self) -> Dict[str, Dict[str, object]]:
        """``{name: {target: value | histogram summary}}`` — the
        dashboard/export view of everything registered."""
        out: Dict[str, Dict[str, object]] = {}
        for (name, target), m in sorted(self._metrics.items()):
            row = out.setdefault(name, {})
            row[target] = (m.summary() if isinstance(m, Histogram)
                           else m.value)
        return out

    def targets(self, name: str):
        return sorted(t for (n, t) in self._metrics if n == name)
