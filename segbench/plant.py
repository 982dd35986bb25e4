"""Faults planted in a built query node, for the readings that set the
recall limit (``segbench.readings``, on the card at a cell's own size)
and for the tests that see ``correct`` come out false (``tiny``, on the
CPU). Each is a context manager that breaks the node and restores it on
leaving:

* ``graph_shuffled``: every segment's disk graph (and the tier-0 pack's
  copy of it) relabelled through a seeded permutation of its vertices;
* ``pq_zeroed``: every PQ code set to 0, so routing reads one centroid;
* ``one_segment_merged``: the coordinator's merge keeps the first
  segment's answers alone.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.serving import coordinator


@contextlib.contextmanager
def _fields(node, names, change):
    """Clones ``names`` of every segment, applies ``change(seg, i)``,
    and puts the clones back on leaving."""
    saved = [{n: getattr(s.segment, n).clone() for n in names}
             for s in node.servers]
    try:
        for i, s in enumerate(node.servers):
            change(s.segment, i)
        yield
    finally:
        for s, keep in zip(node.servers, saved):
            for n, t in keep.items():
                getattr(s.segment, n).copy_(t)


def graph_shuffled(node, seed: int = 0):
    def change(seg, i):
        g = torch.Generator().manual_seed(seed + i)
        perm = torch.randperm(seg.block_of.shape[0], generator=g).to(
            device=seg.nbrs.device, dtype=seg.nbrs.dtype)
        for t in (seg.nbrs, seg.hot_nbrs):
            t.copy_(torch.where(t >= 0, perm[t.clamp_min(0).long()], t))
    return _fields(node, ("nbrs", "hot_nbrs"), change)


def pq_zeroed(node, seed: int = 0):
    return _fields(node, ("pq_codes",),
                   lambda seg, i: seg.pq_codes.zero_())


@contextlib.contextmanager
def one_segment_merged(node, seed: int = 0):
    whole = coordinator.merge_topk

    def first(ids, dists, offsets, k):
        return whole(ids[:1], dists[:1], offsets[:1], k)
    coordinator.merge_topk = first
    try:
        yield
    finally:
        coordinator.merge_topk = whole


FAULTS = {"graph_shuffled": graph_shuffled, "pq_zeroed": pq_zeroed,
          "one_segment_merged": one_segment_merged}
