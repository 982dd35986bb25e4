"""The host ``Segment``: a built index as a container of numpy arrays.

A segment built by the JAX package reaches this package through
``load_segment`` (the ``.npz`` that ``repro.core.segment.save_segment``
writes) or ``segment_from_arrays`` (the same keys as a dict, which is
also what ``data.synthetic.synthetic_segment`` returns).

Arrays (ρ blocks of ε slots, N vertices, Λ max degree):
  vid [ρ, ε] i32 (-1 pad), vecs [ρ, ε, D] f32, meta [ρ, ε, 1+Λ] i32
  (degree, then neighbour ids, -1 pad) — the block store;
  block_of / slot_of [N] i32, blocks [ρ, ε] — the layout;
  adj [N, Λ] i32, deg [N] i32, entry — the disk graph;
  pq_codes [N, M] u8, pq_cent [M, K, dsub] f32 — PQ routing;
  nav_ids [n'] i32, nav_adj [n', Λ'] i32, nav_vecs [n', D] f32,
  nav_entry — the navigation graph over a sample (local ids);
  block_kb, metric.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np

from repro_torch.core.params import SegmentParams

_KEYS = ("adj", "deg", "entry", "blocks", "block_of", "slot_of", "vid",
         "vecs", "meta", "pq_codes", "pq_cent", "nav_ids", "nav_adj",
         "nav_entry", "nav_vecs", "metric", "block_kb")


@dataclasses.dataclass
class Segment:
    vid: np.ndarray
    vecs: np.ndarray
    meta: np.ndarray
    blocks: np.ndarray
    block_of: np.ndarray
    slot_of: np.ndarray
    adj: np.ndarray
    deg: np.ndarray
    entry: int
    pq_codes: np.ndarray
    pq_cent: np.ndarray
    nav_ids: np.ndarray
    nav_adj: np.ndarray
    nav_vecs: np.ndarray
    nav_entry: int
    block_kb: float
    metric: str
    params: SegmentParams

    @property
    def num_vectors(self) -> int:
        return int(self.block_of.shape[0])

    @property
    def num_blocks(self) -> int:
        return int(self.vid.shape[0])

    def disk_bytes(self) -> int:
        """The block file: ρ blocks of η KB."""
        return int(self.num_blocks * self.block_kb * 1024)


def segment_from_arrays(arrays: Mapping[str, np.ndarray],
                        params: Optional[SegmentParams] = None) -> Segment:
    """Build the host ``Segment`` from the ``save_segment`` keys.
    ``params`` supplies the tier-0 budget (``params.cache``); by default
    the segment has none."""
    missing = [k for k in _KEYS if k not in arrays]
    if missing:
        raise KeyError(f"segment arrays lack {missing}")
    a = arrays
    metric = str(np.asarray(a["metric"]))
    params = params or SegmentParams(metric=metric)
    if params.metric != metric:
        raise ValueError(f"segment metric {metric!r} != params "
                         f"{params.metric!r}")
    if np.asarray(a["nav_ids"]).shape[0] == 0:
        raise ValueError("the device search needs a navigation graph")
    return Segment(
        vid=np.asarray(a["vid"], np.int32),
        vecs=np.asarray(a["vecs"], np.float32),
        meta=np.asarray(a["meta"], np.int32),
        blocks=np.asarray(a["blocks"], np.int32),
        block_of=np.asarray(a["block_of"], np.int32),
        slot_of=np.asarray(a["slot_of"], np.int32),
        adj=np.asarray(a["adj"], np.int32),
        deg=np.asarray(a["deg"], np.int32),
        entry=int(np.asarray(a["entry"])),
        pq_codes=np.asarray(a["pq_codes"], np.uint8),
        pq_cent=np.asarray(a["pq_cent"], np.float32),
        nav_ids=np.asarray(a["nav_ids"], np.int32),
        nav_adj=np.asarray(a["nav_adj"], np.int32),
        nav_vecs=np.asarray(a["nav_vecs"], np.float32),
        nav_entry=int(np.asarray(a["nav_entry"])),
        block_kb=float(np.asarray(a["block_kb"])),
        metric=metric,
        params=params)


def load_segment(path: str,
                 params: Optional[SegmentParams] = None) -> Segment:
    """Read a segment written by ``repro.core.segment.save_segment``."""
    with np.load(path, allow_pickle=False) as z:
        return segment_from_arrays({k: z[k] for k in z.files}, params)
