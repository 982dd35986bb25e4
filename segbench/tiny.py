"""The cells of ``BENCHMARK.json`` cut to a size that a CPU test run
holds: the same files and code paths, a few hundred rows, small
batches. For the tests; never for a measurement."""
from __future__ import annotations

import copy

from segbench import harness

TRAFFIC = {"stream": {"rate_qps": 200, "buckets": [8, 32]},
           "bulk": {"batch": 8, "max_qps": 40000}}


def cell(name: str, n: int = 600, max_hops: int = 16) -> harness.Cell:
    return cut(harness.load_cell(name), n, max_hops)


def cut(c: harness.Cell, n: int = 600, max_hops: int = 16) -> harness.Cell:
    """``c`` at a tiny size; its data group cut as its generator says."""
    cfg = copy.deepcopy(c.config)
    count = cfg["n"] // cfg["segment_n"]
    seg_n = n // count
    cfg.update(n=seg_n * count, segment_n=seg_n, segments=[seg_n] * count,
               recall_sample=64)
    cfg["data"] = harness.data_source(cfg["data"]).tiny(cfg["data"])
    # a short search, so that a loaded CPU still serves several batches
    cfg["search"].update(candidates=16, max_hops=max_hops)
    # the recall floor at this size, from its own readings: the program
    # 0.895-1.0, each planted fault 0.281-0.694 at 2,000 rows and 8 hops
    cfg["limits"]["recall_miss"] = 0.2
    traffic = dict(c.traffic)
    for key, over in TRAFFIC.items():
        if c.name.endswith("." + key):
            traffic.update(over)
    return harness.Cell(c.name, c.chips, cfg, traffic, c.metrics)


Builds = harness.BuildCache


def run(cell_: harness.Cell, seed: int = 2 ** 31 + 5, seconds: float = None,
        trace: bool = False, builds=None, **kw) -> dict:
    """One run on the CPU. The default window holds a few batches even
    on a loaded CPU: a closed loop's rate needs one whole batch inside
    it, a traced run one batch after 0.6 of it."""
    import time
    if seconds is None:
        seconds = 3.0 if cell_.traffic["loop"] == "closed" else 0.6
        seconds += 2.0 if trace else 0.0
    return harness.run_cell(cell_, seed, seconds, trace, "cpu",
                            time.perf_counter(), build_node=builds,
                            log=lambda m: None, **kw)
