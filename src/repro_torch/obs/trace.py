"""Span/event tracing for the serving plane (port of ``repro.obs.trace``).

A ``Tracer`` records a flat list of ``TraceEvent``s — complete spans
(``ph="X"``: name, start, duration) and instant events (``ph="i"``) —
against an injected clock (``obs.clock``). The event vocabulary
is deliberately tiny and maps 1:1 onto the Chrome trace-event /
Perfetto JSON format (``obs.export``), so a recorded batch can
be dropped straight into ``ui.perfetto.dev``.

Instrumented call sites (``CachedBlockStore``, ``AsyncFetchQueue``,
``HostSegmentServer``, ``QueryCoordinator``, ``RepackScheduler``) all
take the tracer as an *optional* collaborator: the default is ``None``
and every hook is behind an ``if tracer is not None`` guard, so the
untraced hot path pays one attribute test — results and counters are
identical with tracing on or off (asserted in tests).

Naming conventions (DESIGN.md §6): event names are dotted
``plane.what`` — ``coord.batch``, ``coord.segment``, ``host.search``,
``io.read``, ``io.fetch_submit``, ``io.fetch_complete``,
``sched.eval``, ``sched.repack``, ``device.round``. Categories group
planes: ``serve`` | ``io`` | ``sched`` | ``device``.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterator, List, Optional

from repro_torch.obs.clock import ManualClock, WallClock


@dataclasses.dataclass
class TraceEvent:
    """One Chrome-trace-event-shaped record (times in µs)."""
    name: str
    cat: str
    ph: str                 # "X" complete span | "i" instant
    ts_us: float            # start timestamp
    dur_us: float = 0.0     # span duration (X only)
    track: str = "main"     # rendered as the Chrome tid (one row each)
    args: Dict = dataclasses.field(default_factory=dict)


class Tracer:
    """Bounded in-memory trace buffer with span/event recording.

    ``max_events`` caps memory on long-lived serving processes: the
    buffer keeps the *first* ``max_events`` records and counts the
    rest in ``dropped`` (head-capture semantics — a trace documents a
    window, it is not a ring of the most recent past)."""

    def __init__(self, clock=None, max_events: int = 100_000):
        self.clock = clock if clock is not None else WallClock()
        self.max_events = int(max_events)
        self.events: List[TraceEvent] = []
        self.dropped = 0

    # ----------------------------------------------------------- record
    def _push(self, ev: TraceEvent) -> None:
        if len(self.events) >= self.max_events:
            self.dropped += 1
            return
        self.events.append(ev)

    def event(self, name: str, cat: str = "serve", track: str = "main",
              **args) -> None:
        """Record an instant event at the current clock."""
        self._push(TraceEvent(name=name, cat=cat, ph="i",
                              ts_us=self.clock.now_us(), track=track,
                              args=args))

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "serve", track: str = "main",
             **args) -> Iterator[Dict]:
        """Record a complete span around the ``with`` body.

        Yields the args dict so the body can attach outcomes
        (``sp["tier"] = 1``) that land in the finished event."""
        t0 = self.clock.now_us()
        try:
            yield args
        finally:
            t1 = self.clock.now_us()
            self._push(TraceEvent(name=name, cat=cat, ph="X", ts_us=t0,
                                  dur_us=max(t1 - t0, 0.0), track=track,
                                  args=args))

    def slice(self, name: str, ts_us: float, dur_us: float,
              cat: str = "device", track: str = "main", **args) -> None:
        """Record a span with *explicit* timing — used to render
        modeled timelines (e.g. the device round log priced through a
        ``CostModel``) where durations come from the model, not the
        clock."""
        self._push(TraceEvent(name=name, cat=cat, ph="X", ts_us=ts_us,
                              dur_us=dur_us, track=track, args=args))

    # ------------------------------------------------------------ access
    def __len__(self) -> int:
        return len(self.events)

    def clear(self) -> None:
        self.events.clear()
        self.dropped = 0

    def by_name(self, name: str) -> List[TraceEvent]:
        return [e for e in self.events if e.name == name]


def manual_tracer(auto_tick_us: float = 1.0) -> Tracer:
    """A tracer on a ``ManualClock`` — the deterministic test/CI
    configuration the clock-injection rule (DESIGN.md §6) prescribes."""
    return Tracer(clock=ManualClock(auto_tick_us=auto_tick_us))
