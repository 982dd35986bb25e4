"""Heartbeat-based straggler/failure detection + elastic re-mesh plan
(copy of ``repro.ft.straggler``, pure Python).

Host-side control plane (unit-testable without a pod): workers report
step-completion heartbeats; the monitor flags nodes whose last beat is
older than ``timeout`` (dead) or whose step time exceeds
``straggler_factor`` x the fleet median (straggler). ``plan_remesh``
(distributed/elastic.py) converts the surviving-node count into a new
mesh and per-device batch that preserves the global batch.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional


@dataclasses.dataclass
class StragglerReport:
    dead: List[int]
    stragglers: List[int]
    healthy: List[int]
    median_step_s: float


class HeartbeatMonitor:
    def __init__(self, num_nodes: int, timeout: float = 60.0,
                 straggler_factor: float = 2.0):
        self.num_nodes = num_nodes
        self.timeout = timeout
        self.factor = straggler_factor
        self.last_beat: Dict[int, float] = {}
        self.step_time: Dict[int, float] = {}

    def beat(self, node: int, step_s: float,
             now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        self.last_beat[node] = now
        self.step_time[node] = step_s

    def report(self, now: Optional[float] = None) -> StragglerReport:
        now = time.monotonic() if now is None else now
        dead, stragglers, healthy = [], [], []
        times = sorted(self.step_time.values())
        median = times[len(times) // 2] if times else 0.0
        for node in range(self.num_nodes):
            beat = self.last_beat.get(node)
            if beat is None or now - beat > self.timeout:
                dead.append(node)
            elif (median > 0
                  and self.step_time.get(node, 0.0) > self.factor * median):
                stragglers.append(node)
            else:
                healthy.append(node)
        return StragglerReport(dead=dead, stragglers=stragglers,
                               healthy=healthy, median_step_s=median)
