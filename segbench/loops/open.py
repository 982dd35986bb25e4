"""Open loop: independent users, each sending one k-NN query, with
Poisson arrivals at a fixed rate (``rate_qps``).

Requests go through ``serving.batcher.RequestBatcher`` with the
traffic's buckets; whenever the query node is free and requests are
waiting, the loop takes ``next_batch()`` and searches it. A request's
latency runs from its scheduled arrival. Arrivals stop at the window's
end; the requests still waiting are then served (the drain), so that
every answer can be judged.
"""
from __future__ import annotations

import math
import time

import numpy as np

from repro_torch.serving.batcher import RequestBatcher

from segbench.data import stream_seed


def pool_size(traffic: dict, seconds: float) -> int:
    mean = traffic["rate_qps"] * seconds
    return int(mean + 8 * math.sqrt(mean) + 64)


def warm_shapes(traffic: dict, dim: int):
    return list(RequestBatcher(dim, buckets=traffic["buckets"]).buckets)


def arrivals(traffic: dict, seconds: float, seed: int) -> np.ndarray:
    """The scheduled arrival times in [0, seconds), seconds after the
    window's start."""
    rng = np.random.default_rng(stream_seed(seed, "arrivals"))
    t = np.cumsum(rng.exponential(1.0 / traffic["rate_qps"],
                                  pool_size(traffic, seconds)))
    if t[-1] < seconds:
        raise RuntimeError("the arrival schedule is shorter than the window")
    return t[t < seconds]


def run(node, traffic: dict, pool: np.ndarray, seconds: float, seed: int,
        rec, drain_s: float = 60.0) -> None:
    arr = arrivals(traffic, seconds, seed)
    batcher = RequestBatcher(pool.shape[1], buckets=traffic["buckets"])
    k = traffic["k"]
    rec.begin(arr)
    n, i = len(arr), 0
    t0 = rec.t0
    while True:
        now = time.perf_counter() - t0
        while i < n and arr[i] <= now:
            batcher.submit(pool[i])
            i += 1
        if batcher.queue:
            if now > seconds + drain_s:
                break
            q, rids, nv = batcher.next_batch()
            rec.serve(node, q, np.asarray(rids), nv, k)
        elif i < n:
            time.sleep(max(arr[i] - now, 0.0))
        else:
            break
