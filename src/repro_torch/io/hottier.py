"""The in-memory hot tier above the block hierarchy (port of ``repro.io.
hottier``).

The hot tier is a small navigable graph over the hot-set *vectors*,
taken whole blocks at a time in the order of the ``io.hotset`` ranking
that also picks the tier-0 pack. A hybrid query runs on the hot graph to
convergence first (``HotTier.route``), then the cold block search is
seeded from the hot tier's exit frontier (``device_anns``'s ``seeds``),
and the two answers merge by ``(dist, id)`` (``merge_hot_cold``). The
memory work is the ``hot_tier_hits`` column: the vertices a query
visited on the hot graph.

The hot tier is also a segment's mutable region: ``insert`` appends
vectors (global ids at or past ``base_size``, which exist only here)
by incremental graph insertion, and ``delete`` tombstones an id, masked
at route time.

Where it runs: the state is host numpy, as in the JAX package, so
``insert``/``delete`` keep its exact sequential semantics; the graph's
vectors and adjacency are mirrored on ``device``, where every beam
search (``route``'s batch, each insert's neighbourhood search) runs as
the batched ``core.graph.greedy_search_batch``. An insert writes the
rows it changed to the mirror; a growth of the arrays re-uploads it.
``attach_obs`` wires it into the observability plane: a ``hot.route``
span per routed batch, the routed queries and visits as counters, the
size and memory as gauges.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch

from repro_torch.core import graph as G
from repro_torch.core import navgraph as NG
from repro_torch.core.params import HotTierParams
from repro_torch.io import hotset


@dataclasses.dataclass
class HotRoute:
    """One batch's hot-tier routing output."""
    ids: np.ndarray       # [Q, k] global ids, -1-padded, tombstones masked
    dists: np.ndarray     # [Q, k] exact distances (inf on pad)
    exits: np.ndarray     # [Q, exit_width] int32 cold-graph seed ids
    #                       (-1-padded), handed to the block search
    hot_hits: np.ndarray  # [Q] int32 vertices visited (hot_tier_hits)


def merge_hot_cold(k: int, hot_ids: np.ndarray, hot_dists: np.ndarray,
                   cold_ids: np.ndarray, cold_dists: np.ndarray):
    """Merge one query's hot and cold rows into its top-k: dedup by id,
    keeping the smaller distance (the two tiers may differ in the last
    ulp for one vertex), then order by ``(dist, id)`` as ``merge_topk``
    does. Inputs are -1/inf padded rows; returns ([k] ids, [k] dists)."""
    ids = np.concatenate([hot_ids, cold_ids]).astype(np.int64)
    ds = np.concatenate([hot_dists, cold_dists]).astype(np.float32)
    best: Dict[int, float] = {}
    for i, d in zip(ids, ds):
        i = int(i)
        if i < 0 or not np.isfinite(d):
            continue
        if i not in best or d < best[i]:
            best[i] = float(d)
    order = sorted(best.items(), key=lambda t: (t[1], t[0]))[:k]
    out_i = np.full(k, -1, np.int64)
    out_d = np.full(k, np.inf, np.float32)
    for m, (i, d) in enumerate(order):
        out_i[m] = i
        out_d[m] = d
    return out_i, out_d


def _first(mask: np.ndarray, values: np.ndarray, width: int, fill):
    """Per row, the first ``width`` ``values`` where ``mask`` holds, in
    order, padded with ``fill``."""
    order = np.argsort(~mask, axis=1, kind="stable")[:, :width]
    ok = np.take_along_axis(mask, order, axis=1)
    return np.where(ok, np.take_along_axis(values, order, axis=1), fill)


@dataclasses.dataclass
class HotTier:
    """A navigable in-memory graph over the hot set, with an append
    region. Arrays are allocated at capacity; ``size`` is the live
    prefix. Local ids index the arrays, ``ids`` maps them to global ids;
    global ids below ``base_size`` also exist in the disk segment."""
    vectors: np.ndarray            # [cap, D] f32
    ids: np.ndarray                # [cap] int64 global ids (-1 free)
    adj: np.ndarray                # [cap, Λ] int32 local adjacency
    deg: np.ndarray                # [cap] int32
    size: int
    base_size: int
    dead: np.ndarray               # [cap] bool local tombstones
    params: HotTierParams
    metric: str = "l2"
    entry: int = 0                 # local entry vertex
    device: str = "cuda"
    tracer: Optional[object] = None
    metrics: Optional[object] = None
    _local_of: Dict[int, int] = dataclasses.field(default_factory=dict)
    _mirror: Optional[tuple] = dataclasses.field(default=None, repr=False)

    # ------------------------------------------------------- accounting

    def memory_bytes(self) -> int:
        """The hot tier's Eq. 10 memory charge at full capacity: vectors,
        adjacency, degrees, ids and tombstones."""
        return (self.vectors.nbytes + self.adj.nbytes + self.deg.nbytes
                + self.ids.nbytes + self.dead.nbytes)

    @property
    def live_count(self) -> int:
        return int(self.size - self.dead[: self.size].sum())

    def attach_obs(self, tracer=None, metrics=None,
                   target: str = "hot") -> None:
        """Wire the observability plane: ``route()`` records a
        ``hot.route`` span and hit counters against ``target``."""
        self.tracer = tracer
        if metrics is not None:
            self.metrics = metrics
            metrics.gauge("hot.size", target).set(float(self.size))
            metrics.gauge("hot.memory_bytes", target).set(
                float(self.memory_bytes()))
        self._obs_target = target

    def _on_device(self):
        """(vectors [cap, D], adj [cap, Λ]) on ``device``, uploaded when
        absent or stale after a growth."""
        if (self._mirror is None
                or self._mirror[0].shape[0] != self.vectors.shape[0]):
            dev = torch.device(self.device)
            self._mirror = (torch.as_tensor(self.vectors, device=dev),
                            torch.as_tensor(self.adj, device=dev))
        return self._mirror

    # ------------------------------------------------------------ route

    def route(self, queries: np.ndarray, k: int) -> HotRoute:
        """Run the batch on the hot graph to convergence: the hot top-k
        (tombstones masked), the exit frontier (the best beam entries the
        cold graph knows; tombstoned vertices still navigate, appended
        ones do not exist on disk) and each query's visit count."""
        queries = np.ascontiguousarray(queries, np.float32)
        if self.tracer is not None:
            with self.tracer.span("hot.route", cat="serve", track="hot",
                                  queries=queries.shape[0]):
                out = self._route(queries, k)
        else:
            out = self._route(queries, k)
        if self.metrics is not None:
            tgt = getattr(self, "_obs_target", "hot")
            self.metrics.counter("hot.routed_queries", tgt).inc(
                queries.shape[0])
            self.metrics.counter("hot.route_hits", tgt).inc(
                float(out.hot_hits.sum()))
        return out

    def _route(self, queries: np.ndarray, k: int) -> HotRoute:
        p = self.params
        beam = max(p.search_beam, k, p.exit_width)
        x, adj = self._on_device()
        ids_l, d, vis = G.greedy_search_batch(
            x[: self.size], adj[: self.size], None, self.entry,
            torch.as_tensor(queries, device=x.device), beam=beam,
            metric=self.metric, visited=False)
        ids_l, d = ids_l.cpu().numpy(), d.cpu().numpy()
        valid = ids_l >= 0
        safe = np.maximum(ids_l, 0)
        gids = np.where(valid, self.ids[safe], -1)
        live = valid & ~self.dead[safe]
        return HotRoute(
            ids=_first(live, gids, k, -1).astype(np.int64),
            dists=_first(live, d, k, np.inf).astype(np.float32),
            exits=_first(valid & (gids < self.base_size), gids,
                         p.exit_width, -1).astype(np.int32),
            hot_hits=vis.count.cpu().numpy().astype(np.int32))

    # ------------------------------------------------------- mutability

    def _grow(self) -> None:
        cap = self.vectors.shape[0]
        new_cap = max(cap * 2, cap + 8)
        for name in ("vectors", "ids", "adj", "deg", "dead"):
            a = getattr(self, name)
            shape = (new_cap,) + a.shape[1:]
            b = (np.full(shape, -1, a.dtype) if a.dtype.kind == "i"
                 else np.zeros(shape, a.dtype))
            b[:cap] = a
            setattr(self, name, b)

    def insert(self, vecs: np.ndarray, gids: np.ndarray) -> None:
        """Incremental graph insertion into the append region, one vector
        after the other: a beam search for its neighbourhood on the graph
        as it stands, edges to the best Λ, and reverse edges (the
        farthest neighbour is replaced when a row is full)."""
        vecs = np.atleast_2d(np.asarray(vecs, np.float32))
        gids = np.atleast_1d(np.asarray(gids, np.int64))
        lam = self.adj.shape[1]
        for vec, gid in zip(vecs, gids):
            if self.size == self.vectors.shape[0]:
                self._grow()
            x, adj = self._on_device()
            li = self.size
            self.vectors[li] = vec
            self.ids[li] = gid
            self.dead[li] = False
            x[li] = torch.as_tensor(vec, device=x.device)
            nn: List[int] = []
            if li == 0:
                self.deg[li] = 0
                self.entry = 0
            else:
                ids_l, _, _ = G.greedy_search_batch(
                    x[:li], adj[:li], None, self.entry, x[li: li + 1],
                    beam=max(self.params.build_beam, lam),
                    metric=self.metric, visited=False)
                nn = [v for v in ids_l[0].tolist() if v >= 0][:lam]
                self.adj[li, :] = -1
                self.adj[li, : len(nn)] = nn
                self.deg[li] = len(nn)
                for v in nn:
                    if self.deg[v] < lam:
                        self.adj[v, self.deg[v]] = li
                        self.deg[v] += 1
                    else:
                        nbrs = self.adj[v, :lam]
                        dd = ((self.vectors[nbrs] - self.vectors[v]) ** 2
                              ).sum(axis=1)
                        worst = int(np.argmax(dd))
                        d_new = float(((vec - self.vectors[v]) ** 2).sum())
                        if d_new < float(dd[worst]):
                            self.adj[v, worst] = li
            rows = np.asarray([li] + nn, np.int64)
            adj[torch.as_tensor(rows, device=adj.device)] = torch.as_tensor(
                self.adj[rows], device=adj.device)
            self.size += 1
            self._local_of[int(gid)] = li
        if self.metrics is not None:
            tgt = getattr(self, "_obs_target", "hot")
            self.metrics.gauge("hot.size", tgt).set(float(self.size))

    def delete(self, gid: int) -> bool:
        """Tombstone a global id if it is hot-resident; returns whether
        it was found here (the caller tombstones the cold side too)."""
        li = self._local_of.get(int(gid))
        if li is None:
            return False
        self.dead[li] = True
        return True


def build_hot_tier(seg, p: HotTierParams = HotTierParams(),
                   metric: Optional[str] = None, device="cuda") -> HotTier:
    """The hot tier of a host ``Segment``: blocks in the hot-set ranking
    order (filled to every block) until ``budget_frac`` of the vectors
    are covered, their vectors gathered from the block store, and an NSG
    graph over them (``navgraph.subset_navgraph``) built on ``device``."""
    metric = metric or seg.metric
    block_of = np.asarray(seg.block_of)
    n = int(block_of.shape[0])
    ranking = hotset.hot_block_ranking(
        block_of, seg.adj, seg.deg, hotset.view_seed_ids(seg.view),
        hops=p.hops)
    order = hotset.fill_to(ranking, seg.num_blocks, seg.num_blocks)
    budget = max(int(math.ceil(p.budget_frac * n)), 1)
    hot_ids: List[int] = []
    hot_vecs: List[np.ndarray] = []
    for b in order:
        vid = np.asarray(seg.vid[b])
        live = vid >= 0
        hot_ids.extend(int(v) for v in vid[live])
        hot_vecs.append(np.asarray(seg.vecs[b])[live])
        if len(hot_ids) >= budget:
            break
    ids = np.asarray(hot_ids, np.int64)
    xs = np.ascontiguousarray(np.concatenate(hot_vecs, axis=0), np.float32)
    nav = NG.subset_navgraph(None, ids, max_degree=p.max_degree,
                             build_beam=p.build_beam, metric=metric,
                             algo="nsg", seed=p.seed, vectors=xs,
                             device=device)
    built = ids.shape[0]
    cap = built + int(math.ceil(p.append_slack * built))
    lam = nav.graph.adj.shape[1]
    vectors = np.zeros((cap, xs.shape[1]), np.float32)
    vectors[:built] = nav.vectors
    gids = np.full((cap,), -1, np.int64)
    gids[:built] = ids
    adj = np.full((cap, lam), -1, np.int32)
    adj[:built] = nav.graph.adj
    deg = np.zeros((cap,), np.int32)
    deg[:built] = nav.graph.deg
    return HotTier(vectors=vectors, ids=gids, adj=adj, deg=deg, size=built,
                   base_size=n, dead=np.zeros((cap,), bool), params=p,
                   metric=metric, entry=int(nav.graph.entry), device=device,
                   _local_of={int(g): i for i, g in enumerate(ids)})


def hot_tier_from_arrays(arrays: Mapping, device="cuda") -> HotTier:
    """A ``HotTier`` from the fields of one built elsewhere (the JAX
    package's ``HotTier``): ``vectors``, ``ids``, ``adj``, ``deg``,
    ``size``, ``base_size``, ``dead``, ``entry``, ``params`` (the
    ``HotTierParams`` field values) and optionally ``metric``. The
    arrays are copied."""
    a = arrays
    params = a["params"]
    if not isinstance(params, HotTierParams):
        params = HotTierParams(**dict(params))
    size = int(a["size"])
    ids = np.array(a["ids"], np.int64)
    return HotTier(
        vectors=np.array(a["vectors"], np.float32), ids=ids,
        adj=np.array(a["adj"], np.int32), deg=np.array(a["deg"], np.int32),
        size=size, base_size=int(a["base_size"]),
        dead=np.array(a["dead"], bool), params=params,
        metric=str(a.get("metric", "l2")), entry=int(a["entry"]),
        device=device,
        _local_of={int(g): i for i, g in enumerate(ids[:size].tolist())})
