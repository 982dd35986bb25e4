"""Closed loop: one client sends batches of ``batch`` fresh k-NN queries
back to back, the next as soon as the previous one's answers are back.
The batch in flight when the window closes finishes after it.
"""
from __future__ import annotations

import math

import numpy as np


def pool_size(traffic: dict, seconds: float) -> int:
    b = traffic["batch"]
    return b * (math.ceil(traffic["max_qps"] * seconds / b) + 1)


def warm_shapes(traffic: dict, dim: int):
    return [traffic["batch"]]


def run(node, traffic: dict, pool: np.ndarray, seconds: float, seed: int,
        rec, drain_s: float = 60.0) -> None:
    b, k = traffic["batch"], traffic["k"]
    rec.begin(None)
    j = 0
    while rec.now() < seconds:
        if j + b > pool.shape[0]:
            raise RuntimeError(f"the query pool ran out after {j} queries: "
                               f"raise max_qps above the rate served")
        idx = np.arange(j, j + b)
        rec.arrive(idx)
        rec.serve(node, pool[j:j + b], idx, b, k)
        j += b
