"""A query node of the port: sealed segments, each built by
``build_segment`` and served by a ``SegmentServer`` on the card, behind
one ``QueryCoordinator`` that scatters every batch and merges the top-k.

The configuration's ``segments`` lists the segment sizes; the base rows
are split in id order, each segment's ids offset by the rows before it.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from repro_torch.core import device_search as DS
from repro_torch.core.params import (CacheParams, DeviceSearchParams,
                                     GraphParams, LayoutParams,
                                     NavGraphParams, PQParams, SegmentParams)
from repro_torch.core.segment import build_segment
from repro_torch.serving.coordinator import QueryCoordinator, SegmentServer


def segment_params(index: dict) -> SegmentParams:
    """``SegmentParams`` from the configuration's ``index`` group."""
    return SegmentParams(
        graph=GraphParams(**index["graph"]),
        layout=LayoutParams(**index["layout"]),
        pq=PQParams(**index["pq"]), nav=NavGraphParams(**index["nav"]),
        cache=CacheParams(**index["cache"]), metric=index["metric"])


@dataclasses.dataclass
class QueryNode:
    coordinator: QueryCoordinator
    servers: List[SegmentServer]
    build_times: List[dict]
    build_info: List[dict]

    def search(self, queries: np.ndarray, k: int):
        """(ids [Q, k] global, dists [Q, k]) for a padded batch."""
        ids, dists, _ = self.coordinator.search(queries, k)
        return ids, dists

    def batch_counts(self, n_valid: int) -> dict:
        """The last batch's counters over its first ``n_valid`` rows:
        rounds and block reads summed over the segments it visited."""
        rounds = io = 0
        for s in self.servers:
            st = s.batch_stats()
            rounds += int(st["rounds"])
            io += int(np.asarray(st["io"])[:n_valid].sum())
        return {"rounds": rounds, "io": io}


def build(cfg: dict, base: np.ndarray, device, tracer=None) -> QueryNode:
    params = segment_params(cfg["index"])
    search = DeviceSearchParams(**cfg["search"])
    sizes = cfg["segments"]
    if sum(sizes) != base.shape[0]:
        raise ValueError(f"segments {sizes} do not add up to "
                         f"{base.shape[0]} rows")
    servers, times, infos, off = [], [], [], 0
    for n in sizes:
        seg = build_segment(base[off:off + n], params, device=device)
        times.append(dict(seg.build_times))
        infos.append({k: v for k, v in seg.build_info.items()
                      if isinstance(v, (int, float))})
        servers.append(SegmentServer(
            segment=DS.from_segment(seg, device=device), offset=off,
            num_vectors=n, k_default=search.k, params=search,
            metric=params.metric, device=str(device)))
        del seg
        off += n
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return QueryNode(QueryCoordinator(servers, tracer=tracer), servers,
                     times, infos)
