"""The host ``Segment``: a built index as a container of numpy arrays,
its build (``build_segment``) and its space accounting (Eq. 10).

``build_segment`` runs the offline pipeline of Eq. 8 — disk graph
(Vamana, NSG, or HNSW's base layer), block shuffling (BNP, BNF, GP3,
BNS or the k-means packer), the navigation graph on the μ-sample (NSG),
PQ — and returns a ``Segment`` ready for
``device_search.from_segment``. Segments travel both ways between the
packages: ``save_segment`` writes every key ``repro.core.segment.
load_segment`` reads, and ``load_segment`` reads the ``.npz`` that
``repro.core.segment.save_segment`` writes (``segment_from_arrays``
takes the same keys as a dict).

``Segment.view`` is the ``core.search.SegmentView`` the host search
reads, built once with the segment over the same arrays: its store is
shared state (with ``params.cache`` enabled it is the cache-fronted
``io.cached_store.CachedBlockStore``, whose residency and demand counts
persist across queries), so it is never rebuilt behind the caller's
back. ``device_search.from_segment`` reads the flat arrays, the same
ones whether or not the store is cached.

Arrays (ρ blocks of ε slots, N vertices, Λ max degree):
  vid [ρ, ε] i32 (-1 pad), vecs [ρ, ε, D] f32, meta [ρ, ε, 1+Λ] i32
  (degree, then neighbour ids, -1 pad) — the block store;
  block_of / slot_of [N] i32, blocks [ρ, ε] — the layout;
  adj [N, Λ] i32, deg [N] i32, entry — the disk graph;
  pq_codes [N, M] u8, pq_cent [M, K, dsub] f32 — PQ routing;
  nav_ids [n'] i32, nav_adj [n', Λ'] i32, nav_deg [n'] i32,
  nav_vecs [n', D] f32, nav_entry — the navigation graph over a sample
  (local ids);
  block_kb, metric.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch.core import graph as G
from repro_torch.core import layout as L
from repro_torch.core import navgraph as NG
from repro_torch.core.blockstore import BlockStore, build_store
from repro_torch.core.params import SegmentParams
from repro_torch.core.search import SegmentView
from repro_torch.io.cached_store import CachedBlockStore, cached_view
from repro_torch.pq.pq import PQCodebook, encode_pq, train_pq

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
    nav_deg: Optional[np.ndarray] = None      # [n'] i32; None: from nav_adj
    build_times: Dict[str, float] = dataclasses.field(default_factory=dict)
    overlap_ratio: float = float("nan")       # OR(G) of the layout (Eq. 5)
    build_info: Dict = dataclasses.field(default_factory=dict)
    view: Optional[SegmentView] = None        # built once from the arrays

    def __post_init__(self):
        if self.nav_deg is None:
            self.nav_deg = (self.nav_adj >= 0).sum(1).astype(np.int32)
        if self.view is None:
            view = SegmentView(
                store=BlockStore(vid=self.vid, vecs=self.vecs,
                                 meta=self.meta, block_kb=self.block_kb),
                layout=self.layout, nav=self.nav, pq_codes=self.pq_codes,
                pq_cb=PQCodebook(centroids=self.pq_cent,
                                 dim=self.vecs.shape[2], metric=self.metric),
                metric=self.metric, entry=self.entry)
            if self.params.cache.enabled:
                view = cached_view(view, self.graph, self.params.cache)
            self.view = view

    @property
    def num_vectors(self) -> int:
        return int(self.block_of.shape[0])

    @property
    def num_blocks(self) -> int:
        return int(self.vid.shape[0])

    @property
    def graph(self) -> G.Graph:
        return G.Graph(adj=self.adj, deg=self.deg, entry=self.entry,
                       metric=self.metric)

    @property
    def nav(self) -> NG.NavGraph:
        """The navigation graph over the μ-sample (local adjacency,
        global ``sample_ids``)."""
        return NG.NavGraph(
            graph=G.Graph(adj=self.nav_adj, deg=self.nav_deg,
                          entry=self.nav_entry, metric=self.metric),
            sample_ids=self.nav_ids, vectors=self.nav_vecs)

    @property
    def layout(self) -> L.BlockLayout:
        return L.BlockLayout(blocks=self.blocks, block_of=self.block_of,
                             slot_of=self.slot_of)

    def disk_bytes(self) -> int:
        """The block file: ρ blocks of η KB."""
        return int(self.num_blocks * self.block_kb * 1024)

    def memory_bytes(self) -> int:
        """Eq. 10: C_graph (the navigation graph's vectors, adjacency,
        degrees and ids) + C_mapping (block and slot per vertex) +
        C_PQ (codes and centroids) + C_cache (the host block cache's
        reserved budget, every tier, when the view's store is cached) +
        C_tier0 (the device hot-tile budget)."""
        c_graph = (self.nav_vecs.nbytes + self.nav_adj.nbytes
                   + self.nav_deg.nbytes + self.nav_ids.nbytes)
        c_mapping = self.block_of.nbytes + self.slot_of.nbytes
        c_pq = self.pq_codes.nbytes + self.pq_cent.nbytes
        store = self.view.store
        c_cache = (store.memory_bytes()
                   if isinstance(store, CachedBlockStore) else 0)
        return c_graph + c_mapping + c_pq + c_cache + self.tier0_bytes()

    def tier0_bytes(self) -> int:
        """C_tier0: the configured device hot-tile budget."""
        return self.params.cache.resolve_tier0_budget(self.disk_bytes())

    def check_budget(self) -> Dict[str, bool]:
        b = self.params.budget
        return {"memory_ok": self.memory_bytes() <= b.memory_bytes,
                "disk_ok": self.disk_bytes() <= b.disk_bytes,
                "tier0_ok": self.tier0_bytes() <= b.tier0_vmem_bytes}


def segment_from_arrays(arrays: Mapping[str, np.ndarray],
                        params: Optional[SegmentParams] = None) -> Segment:
    """Build the host ``Segment`` from the ``save_segment`` keys.
    ``params`` supplies the search knobs and the cache and tier-0
    budgets (``params.cache``: an enabled host cache fronts the view's
    store); by default the segment has neither."""
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
        params=params,
        nav_deg=(np.asarray(a["nav_deg"], np.int32) if "nav_deg" in a
                 else None),
        overlap_ratio=(float(np.asarray(a["overlap"])) if "overlap" in a
                       else float("nan")))


def load_segment(path: str,
                 params: Optional[SegmentParams] = None) -> Segment:
    """Read a segment written by ``repro.core.segment.save_segment``."""
    with np.load(path, allow_pickle=False) as z:
        return segment_from_arrays({k: z[k] for k in z.files}, params)


def _stage(times: Dict[str, float], name: str, t0: float,
           device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    times[name] = time.perf_counter() - t0


def build_segment(x: np.ndarray, params: SegmentParams,
                  graph: Optional[G.Graph] = None,
                  device="cuda") -> Segment:
    """Build a segment over x [N, D]: disk graph (``params.graph.algo``:
    vamana | nsg | hnsw, whose base layer is the disk graph; unless
    ``graph`` is given), layout (``params.layout.shuffle``: none | bnp |
    bnf | gp3 | bns | kmeans, whose assignment runs on ``device``),
    navigation graph (NSG on the μ-sample), PQ, block store.

    ``build_times`` holds the seconds of each stage under the JAX keys
    (``disk_graph_s``, ``shuffling_s``, ``memory_graph_s``, ``pq_s``);
    ``build_info`` the graph stage's own counters (``knn_s`` and
    ``attached`` for NSG, ``search_s`` and ``attached`` for Vamana) and
    ``or_history``, OR(G) of the initial layout and after each
    shuffling round. With ``params.cache`` enabled the view's store is
    cache-fronted (``io.cached_store.cached_view``)."""
    dev = torch.device(device)
    x = np.ascontiguousarray(x, np.float32)
    times: Dict[str, float] = {}
    info: Dict = {}

    t0 = time.perf_counter()
    g = graph if graph is not None else G.build_graph(
        x, params.graph, params.metric, device=dev, stats=info)
    _stage(times, "disk_graph_s", t0, dev)

    eps = params.layout.verts_per_block(x.shape[1], g.max_degree)
    t0 = time.perf_counter()
    info["or_history"] = []
    lay = L.make_layout(g, eps, params.layout.shuffle, x=x,
                        bnf_iters=params.layout.bnf_iters,
                        bns_iters=params.layout.bns_iters,
                        tau=params.layout.gain_tau,
                        history=info["or_history"], device=dev)
    _stage(times, "shuffling_s", t0, dev)
    lay.validate()

    t0 = time.perf_counter()
    nav = NG.build_navgraph(x, params.nav, params.metric, algo="nsg",
                            device=dev)
    _stage(times, "memory_graph_s", t0, dev)

    t0 = time.perf_counter()
    cb = train_pq(x, params.pq, params.metric, device=dev)
    codes = encode_pq(x, cb, device=dev)
    _stage(times, "pq_s", t0, dev)

    store = build_store(x, g, lay, params.layout.block_kb)
    return Segment(
        vid=store.vid, vecs=store.vecs, meta=store.meta, blocks=lay.blocks,
        block_of=lay.block_of, slot_of=lay.slot_of, adj=g.adj, deg=g.deg,
        entry=int(g.entry), pq_codes=codes, pq_cent=cb.centroids,
        nav_ids=nav.sample_ids, nav_adj=nav.graph.adj,
        nav_vecs=nav.vectors, nav_entry=int(nav.graph.entry),
        block_kb=float(params.layout.block_kb), metric=params.metric,
        params=params, nav_deg=nav.graph.deg, build_times=times,
        overlap_ratio=L.overlap_ratio(g, lay), build_info=info)


def save_segment(seg: Segment, path: str) -> None:
    """Write ``seg`` with every key ``repro.core.segment.load_segment``
    reads."""
    np.savez_compressed(
        path, adj=seg.adj, deg=seg.deg, entry=seg.entry, blocks=seg.blocks,
        block_of=seg.block_of, slot_of=seg.slot_of, vid=seg.vid,
        vecs=seg.vecs, meta=seg.meta, pq_codes=seg.pq_codes,
        pq_cent=seg.pq_cent, nav_ids=seg.nav_ids, nav_adj=seg.nav_adj,
        nav_deg=seg.nav_deg, nav_entry=seg.nav_entry, nav_vecs=seg.nav_vecs,
        metric=seg.metric, block_kb=seg.block_kb, overlap=seg.overlap_ratio)
