"""Injectable clocks for the observability plane (port of
``repro.obs.clock``).

Every timestamp ``repro_torch.obs`` records comes from a ``Clock`` so the same
tracing code is deterministic in tests and wall-clock in benches:

  * ``WallClock`` — monotonic wall time on the Unix epoch (µs since
    1970, ``time.perf_counter_ns`` plus an epoch offset read once), the
    bench/serving default and the time base of ``torch.profiler``'s
    events, so spans lay over a device trace as they are; the only
    place the port reads real time for observability purposes.
  * ``ManualClock`` — a counter advanced explicitly by the test; spans
    get exact, reproducible durations, so trace goldens are stable.

The clock-injection rule (DESIGN.md §6): *library* code never calls
``time.*`` directly — it asks the tracer, and the tracer asks its
clock. Units are microseconds throughout (the Chrome trace-event
native unit), as floats.
"""
from __future__ import annotations

import time


class WallClock:
    """Monotonic wall time in microseconds since the Unix epoch.

    The offset from ``perf_counter`` to the epoch is read once, when the
    clock is made: later readings move with ``perf_counter`` alone, so a
    step of the system clock (NTP) never makes a span run backwards."""

    def __init__(self):
        self._epoch_ns = time.time_ns() - time.perf_counter_ns()

    def now_us(self) -> float:
        return (time.perf_counter_ns() + self._epoch_ns) / 1e3


class ManualClock:
    """Deterministic test clock: time moves only when told to."""

    def __init__(self, start_us: float = 0.0, auto_tick_us: float = 0.0):
        self._now = float(start_us)
        # auto_tick_us > 0 advances the clock on every read, so two
        # consecutive events never collapse onto one timestamp even
        # when the test does not advance explicitly
        self.auto_tick_us = float(auto_tick_us)

    def now_us(self) -> float:
        t = self._now
        self._now += self.auto_tick_us
        return t

    def advance(self, us: float) -> float:
        if us < 0:
            raise ValueError("clocks only move forward")
        self._now += float(us)
        return self._now

    def set(self, us: float) -> None:
        if us < self._now:
            raise ValueError("clocks only move forward")
        self._now = float(us)
