"""Graph-index construction: Vamana, NSG and HNSW (port of ``repro.
core.graph``).

The graph is the JAX package's: ``adj [N, Λ] int32`` padded with -1 and
``deg [N] int32`` on the host, with the medoid as entry. What runs where:
  * ``greedy_search_batch`` and ``robust_prune_batch`` are batched over
    vertices on ``device``: one tensor op per hop (or per selection) for
    the whole batch, where the JAX package loops over rows in Python;
  * the NSG seed graph is ``distances.knn_graph``, the brute force of the
    ``l2_tile`` kernel;
  * the medoid and the connectivity fix's bookkeeping stay on the host.

The result equals the JAX package's whenever the distances do (they do
exactly on integer-valued vectors), because every order that decides a
tie is kept:
  * each distance site uses the JAX site's float form (norm expansion for
    the search's entry distance, explicit difference elsewhere);
  * the prune sorts stably by distance in the candidates' given order,
    keeps each id's first occurrence, and compares ``α·d <= d_u`` in f32;
  * the search's visited ids are kept in first-seen order (the insertion
    order of the JAX dict), with the entry first;
  * reverse edges reach each target in the order of the JAX ``pending``
    lists. Targets are independent of each other, so they are batched.
The one known difference: ``_ensure_reachable`` ranks hosts with a
stable sort where the JAX package uses numpy's unstable ``argsort``, so
on exact ties it may pick another host.

HNSW (``build_hnsw``) draws its levels with the JAX package's generator
and formula and builds each layer with ``build_vamana`` or ``build_nsg``
at the JAX package's degree caps, so its layers equal JAX's whenever
those builds do.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import distances as D
from repro_torch.core.params import GraphParams

_INF = float("inf")
_PRUNE_ELEMS = 2 ** 28      # floats of candidate vectors one prune step holds


@dataclasses.dataclass
class Graph:
    adj: np.ndarray          # [N, Λ] int32, -1 padded
    deg: np.ndarray          # [N] int32
    entry: int               # medoid / entry vertex id
    metric: str = "l2"

    @property
    def num_vertices(self) -> int:
        return self.adj.shape[0]

    @property
    def max_degree(self) -> int:
        return self.adj.shape[1]

    def neighbors(self, u: int) -> np.ndarray:
        return self.adj[u, : self.deg[u]]

    def avg_degree(self) -> float:
        return float(self.deg.mean())

    def edges(self) -> np.ndarray:
        """[(u, v)] edge list, [E, 2] int32 (slots past deg[u] ignored)."""
        mask = (np.arange(self.max_degree)[None, :] < self.deg[:, None])
        mask &= self.adj >= 0
        u = np.repeat(np.arange(self.num_vertices, dtype=np.int32),
                      mask.sum(axis=1))
        v = self.adj[mask]
        return np.stack([u, v.astype(np.int32)], axis=1)


def medoid(x: np.ndarray, metric: str = "l2") -> int:
    """The vertex nearest the mean (numpy on the host, as in JAX)."""
    mean = x.mean(axis=0)
    return int(np.argmin(D.point_to_points(mean, x, metric)))


# ------------------------------------------------------------- the prune

def robust_prune_batch(u: torch.Tensor, cand_ids: torch.Tensor,
                       cand_dist: torch.Tensor, x: torch.Tensor,
                       max_degree: int, alpha: float, metric: str = "l2"
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """DiskANN RobustPrune for B vertices at once: keep v only if no
    kept w has α·dist(w, v) <= dist(u, v).

    u [B]; cand_ids [B, C] (-1 = none); cand_dist [B, C] (ignored where
    the id is -1); x [N, D] on the same device. Returns (sel [B, Λ] i32,
    -1 padded, in selection order; cnt [B] i32). Each row equals
    ``repro.core.graph.robust_prune`` on that row's valid candidates in
    their order. The selection runs in rounds, one kept vertex per row
    per round, so it takes at most Λ + 1 rounds."""
    bsz, c = cand_ids.shape
    dev = x.device
    ids = cand_ids.long()
    du = torch.where(ids >= 0, cand_dist.to(torch.float32),
                     torch.full_like(cand_dist, _INF, dtype=torch.float32))
    # stable sort by distance; drop u itself and -1
    order = torch.sort(du, dim=1, stable=True).indices
    ids = torch.gather(ids, 1, order)
    du = torch.gather(du, 1, order)
    valid = (ids >= 0) & (ids != u.long()[:, None])
    # keep each id's first occurrence in the sorted order
    col = torch.arange(c, device=dev)
    key = torch.where(valid, ids, ids.new_full((), -2) - col)
    so = torch.sort(key, dim=1, stable=True).indices
    ks = torch.gather(key, 1, so)
    first_sorted = torch.ones_like(valid)
    first_sorted[:, 1:] = ks[:, 1:] != ks[:, :-1]
    first = torch.zeros_like(valid)
    first.scatter_(1, so, first_sorted)
    alive = valid & first
    # compact the survivors to the front, in order
    keep = torch.sort((~alive).to(torch.int8), dim=1, stable=True).indices
    width = max(int(alive.sum(1).max()) if bsz else 0, 1)
    keep = keep[:, :width]
    ids = torch.gather(ids, 1, keep)
    du = torch.gather(du, 1, keep)
    alive = torch.gather(alive, 1, keep)
    cols = torch.arange(width, device=dev)

    xc = x[ids.clamp_min(0)]                             # [B, C', D]
    alpha_t = torch.tensor(alpha, dtype=torch.float32, device=dev)
    sel = torch.full((bsz, max_degree), -1, dtype=torch.int32, device=dev)
    cnt = torch.zeros(bsz, dtype=torch.long, device=dev)
    for _ in range(max_degree):
        rows = torch.nonzero(alive.any(1)).squeeze(1)
        if rows.numel() == 0:
            break
        i = torch.where(alive[rows], cols, width).min(1).values  # first
        v = ids[rows, i]
        sel[rows, cnt[rows]] = v.to(torch.int32)
        cnt[rows] += 1
        alive[rows, i] = False
        more = cnt[rows] < max_degree
        rows, i = rows[more], i[more]
        if rows.numel() == 0:
            break
        xr = xc[rows]
        xv = xr[torch.arange(rows.numel(), device=dev), i]
        dv = D.point_to_points(xv, xr, metric)
        alive[rows] &= ~(alpha_t * dv <= du[rows])
    return sel, cnt.to(torch.int32)


def robust_prune(u: int, cand_ids: np.ndarray, cand_dist: np.ndarray,
                 x, max_degree: int, alpha: float, metric: str = "l2",
                 device="cuda") -> np.ndarray:
    """RobustPrune of one vertex (``repro.core.graph.robust_prune``).
    Returns the selected ids (<= Λ), int32."""
    dev = torch.device(device)
    xt = D.as_tensor(x, dev)
    sel, cnt = robust_prune_batch(
        torch.tensor([u], device=dev),
        torch.as_tensor(np.asarray(cand_ids, np.int64)[None], device=dev),
        torch.as_tensor(np.asarray(cand_dist, np.float32)[None], device=dev),
        xt, max_degree, alpha, metric)
    return sel[0, : int(cnt[0])].cpu().numpy()


def _prune_rows(x: torch.Tensor, u: torch.Tensor, cand: torch.Tensor,
                max_degree: int, alpha: float, metric: str):
    """Prune rows u against candidates cand [B, C] (-1 = none), with
    explicit-difference distances to u, in chunks that fit the device."""
    bsz, c = cand.shape
    step = max(1, _PRUNE_ELEMS // max(c * x.shape[1], 1))
    sels, cnts = [], []
    for s in range(0, bsz, step):
        uu, cc = u[s:s + step], cand[s:s + step]
        cd = D.point_to_points(x[uu.long()], x[cc.long().clamp_min(0)],
                               metric)
        sel, cnt = robust_prune_batch(uu, cc, cd, x, max_degree, alpha,
                                      metric)
        sels.append(sel)
        cnts.append(cnt)
    return torch.cat(sels), torch.cat(cnts)


# ------------------------------------------------------- the beam search

class Visited(NamedTuple):
    """The visited ids of each query in first-seen order (the insertion
    order of the JAX dict) with their distances: ids [B, V] (-1 past
    ``count``), dists [B, V], count [B]."""
    ids: torch.Tensor
    dists: torch.Tensor
    count: torch.Tensor


def greedy_search_batch(x: torch.Tensor, adj: torch.Tensor, deg,
                        entry: int, queries: torch.Tensor, beam: int,
                        metric: str = "l2", max_hops: int = 512,
                        visited: bool = True,
                        ) -> Tuple[torch.Tensor, torch.Tensor, Visited]:
    """Batched best-first (beam) search on the current graph, on the
    device of ``x`` (``adj`` [N, Λ] there too; ``deg`` is unused, as in
    JAX: -1 marks an empty slot).

    Returns (ids [B, beam] i64, dists [B, beam] f32, Visited). Each hop
    expands, for every query that has one, its first unexpanded
    candidate; new neighbours (not yet visited) are merged into the
    candidate list by a stable sort on distance, after the current
    candidates and in neighbour order, as in the JAX merge. With
    ``visited=False`` only ``Visited.count`` is kept (ids and dists are
    None): the callers that read no visited list (the hot tier, the
    navigation graph's entries) skip its bookkeeping and its host syncs;
    the search is the same."""
    dev = x.device
    bsz = queries.shape[0]
    n, lam = adj.shape
    cand_ids = torch.full((bsz, beam), -1, dtype=torch.long, device=dev)
    cand_d = torch.full((bsz, beam), _INF, dtype=torch.float32, device=dev)
    expanded = torch.zeros((bsz, beam), dtype=torch.bool, device=dev)
    d0 = D.pairwise(queries, x[entry][None, :], metric, device=dev)[:, 0]
    cand_ids[:, 0] = entry
    cand_d[:, 0] = d0
    seen = torch.zeros((bsz, n + 1), dtype=torch.bool, device=dev)
    seen[:, entry] = True
    seen[:, n] = True                      # the column of the empty slots
    cap = 1 + 16 * lam if visited else 0
    vis_ids = torch.full((bsz, cap), -1, dtype=torch.long, device=dev)
    vis_d = torch.full((bsz, cap), _INF, dtype=torch.float32, device=dev)
    if visited:
        vis_ids[:, 0] = entry
        vis_d[:, 0] = d0
    vis_n = torch.ones(bsz, dtype=torch.long, device=dev)
    cols = torch.arange(beam, device=dev)

    for hop in range(max_hops):
        open_mask = (~expanded) & (cand_ids >= 0)
        has_open = open_mask.any(1)
        rows = torch.nonzero(has_open).squeeze(1)
        if rows.numel() == 0:
            break
        if visited and 1 + (hop + 1) * lam > cap:       # room for this hop
            grow = cap
            vis_ids = torch.cat([vis_ids, torch.full_like(vis_ids[:, :grow],
                                                          -1)], 1)
            vis_d = torch.cat([vis_d, torch.full_like(vis_d[:, :grow],
                                                      _INF)], 1)
            cap += grow
        pick = torch.where(open_mask[rows], cols, beam).min(1).values
        expanded[rows, pick] = True
        cur = cand_ids[rows, pick]
        nbr = adj[cur].long()                              # [R, Λ]
        valid = nbr >= 0
        nb = nbr.clamp_min(0)
        qr = queries[rows]
        dists = D.point_to_points(qr, x[nb], metric)       # [R, Λ]
        rr = rows[:, None].expand_as(nb)
        col = torch.where(valid, nbr, n)
        new = ~seen[rr, col]
        seen[rr, col] = True
        if visited:
            pos = vis_n[rows][:, None] + torch.cumsum(new, 1) - 1
            vis_ids[rr[new], pos[new]] = nb[new]
            vis_d[rr[new], pos[new]] = dists[new]
        vis_n[rows] += new.sum(1)
        m_ids = torch.cat([cand_ids[rows], torch.where(new, nb, -1)], 1)
        m_d = torch.cat([cand_d[rows], torch.where(
            new, dists, torch.full_like(dists, _INF))], 1)
        m_e = torch.cat([expanded[rows], torch.zeros_like(new)], 1)
        o = torch.sort(m_d, dim=1, stable=True).indices[:, :beam]
        cand_ids[rows] = torch.gather(m_ids, 1, o)
        cand_d[rows] = torch.gather(m_d, 1, o)
        expanded[rows] = torch.gather(m_e, 1, o)
    if not visited:
        return cand_ids, cand_d, Visited(None, None, vis_n)
    return cand_ids, cand_d, Visited(vis_ids, vis_d, vis_n)


# ------------------------------------------------------------- Vamana

def _add_reverse_edges(x: torch.Tensor, adj: torch.Tensor, deg: torch.Tensor,
                       batch_ids: torch.Tensor, max_degree: int,
                       alpha: float, metric: str) -> None:
    """For each edge u -> v of the batch vertices, add v -> u: appended
    where v has room, else v's old and new neighbours are re-pruned
    (DiskANN insert step 3). In place on ``adj``/``deg``. Targets are
    independent, so all are handled at once; each target takes its new
    in-edges in the order of the JAX ``pending`` list, duplicates and
    existing edges dropped."""
    dev = adj.device
    n, lam = adj.shape
    slots = torch.arange(lam, device=dev)
    b = batch_ids.long()
    rows = adj[b].long()
    m = slots[None, :] < deg[b].long()[:, None]
    v = rows[m]                                           # pending order
    u = b[:, None].expand_as(rows)[m]
    if v.numel() == 0:
        return
    key = v * n + u
    so = torch.sort(key, stable=True).indices
    ks = key[so]
    first_s = torch.ones_like(ks, dtype=torch.bool)
    first_s[1:] = ks[1:] != ks[:-1]
    first = torch.zeros_like(first_s)
    first[so] = first_s
    have = ((adj[v].long() == u[:, None])
            & (slots[None, :] < deg[v].long()[:, None])).any(1)
    keep = first & ~have
    v, u = v[keep], u[keep]
    if v.numel() == 0:
        return
    g = torch.sort(v, stable=True).indices
    v, u = v[g], u[g]
    tv, counts = torch.unique_consecutive(v, return_counts=True)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(v.numel(), device=dev) - torch.repeat_interleave(
        starts, counts)
    d_old = deg[tv].long()
    fits = counts <= max_degree - d_old
    fe = torch.repeat_interleave(fits, counts)
    adj[v[fe], (torch.repeat_interleave(d_old, counts) + rank)[fe]] = \
        u[fe].to(adj.dtype)
    deg[tv[fits]] += counts[fits].to(deg.dtype)
    over = torch.nonzero(~fits).squeeze(1)
    if over.numel() == 0:
        return
    ov = tv[over]
    width = lam + int(counts[over].max())
    cand = torch.full((ov.numel(), width), -1, dtype=torch.long, device=dev)
    cand[:, :lam] = torch.where(slots[None, :] < d_old[over][:, None],
                                adj[ov].long(), -1)
    oe = ~fe
    row_of = torch.repeat_interleave(
        torch.arange(ov.numel(), device=dev), counts[over])
    cand[row_of, lam + rank[oe]] = u[oe]
    sel, cnt = _prune_rows(x, ov, cand, max_degree, alpha, metric)
    adj[ov] = sel.to(adj.dtype)
    deg[ov] = cnt.to(deg.dtype)


def build_vamana(x: np.ndarray, p: GraphParams, metric: str = "l2",
                 device="cuda", stats: Optional[dict] = None) -> Graph:
    """Batched-insertion Vamana (DiskANN Algorithm 1-3), the JAX
    package's schedule: a pruned bootstrap clique of Λ+1 vertices, then
    batches of ``insert_batch`` in a seeded random order, each searched
    on the graph as it stands, pruned, and reverse-linked."""
    dev = torch.device(device)
    n = x.shape[0]
    L, R, alpha = p.build_beam, p.max_degree, p.alpha
    rng = np.random.default_rng(p.seed)
    xt = D.as_tensor(x, dev)
    adj = torch.full((n, R), -1, dtype=torch.int32, device=dev)
    deg = torch.zeros(n, dtype=torch.int32, device=dev)
    ep = medoid(x, metric)

    order = rng.permutation(n)
    boot = order[: min(R + 1, n)]
    others = np.stack([np.delete(boot, i)[:R] for i in range(boot.size)])
    bt = torch.as_tensor(boot, device=dev)
    sel, cnt = _prune_rows(xt, bt, torch.as_tensor(others, device=dev),
                           R, alpha, metric)
    adj[bt] = sel
    deg[bt] = cnt

    todo = torch.as_tensor(order[boot.size:], device=dev)
    slots = torch.arange(R, device=dev)
    t_search = 0.0
    for s in range(0, todo.numel(), p.insert_batch):
        batch = todo[s: s + p.insert_batch]
        t0 = time.perf_counter()
        _, _, vis = greedy_search_batch(xt, adj, deg, ep, xt[batch],
                                        beam=L, metric=metric)
        t_search += time.perf_counter() - t0
        # fold in reverse edges already attached to u, after the visited
        prev = torch.where(slots[None, :] < deg[batch].long()[:, None],
                           adj[batch].long(), -1)
        cand = torch.cat([vis.ids, prev], 1)
        cd = torch.cat([vis.dists, D.point_to_points(
            xt[batch], xt[prev.clamp_min(0)], metric)], 1)
        sel, cnt = robust_prune_batch(batch, cand, cd, xt, R, alpha, metric)
        adj[batch] = sel
        deg[batch] = cnt
        _add_reverse_edges(xt, adj, deg, batch, R, alpha, metric)
    g = Graph(adj=adj.cpu().numpy(), deg=deg.cpu().numpy(), entry=ep,
              metric=metric)
    attached = _ensure_reachable(x, g, device=dev, xt=xt)
    if stats is not None:
        stats.update(search_s=t_search, attached=attached)
    return g


# ---------------------------------------------------------------- NSG

def build_nsg(x: np.ndarray, p: GraphParams, metric: str = "l2",
              device="cuda", stats: Optional[dict] = None) -> Graph:
    """NSG-flavour: exact kNN seed (the ``l2_tile`` brute force), α = 1
    prune of every vertex, medoid entry, connectivity fix."""
    dev = torch.device(device)
    n = x.shape[0]
    R = p.max_degree
    k = min(max(2 * R, p.build_beam), n - 1)
    t0 = time.perf_counter()
    knn = D.knn_graph(x, k, metric, device=dev)
    t_knn = time.perf_counter() - t0
    xt = D.as_tensor(x, dev)
    t0 = time.perf_counter()
    sel, cnt = _prune_rows(xt, torch.arange(n, device=dev),
                           torch.as_tensor(knn, device=dev), R, 1.0, metric)
    adj = sel.cpu().numpy()
    deg = cnt.cpu().numpy()
    t_prune = time.perf_counter() - t0
    g = Graph(adj=adj, deg=deg, entry=medoid(x, metric), metric=metric)
    attached = _ensure_reachable(x, g, device=dev, xt=xt)
    if stats is not None:
        stats.update(knn_s=t_knn, prune_s=t_prune, attached=attached)
    return g


# ------------------------------------------------------- connectivity

def _reachable(g: Graph) -> np.ndarray:
    """Vertices reachable from the entry (breadth-first, level by level)."""
    seen = np.zeros(g.num_vertices, bool)
    seen[g.entry] = True
    live = np.arange(g.max_degree)[None, :] < g.deg[:, None]
    frontier = np.array([g.entry])
    while frontier.size:
        nb = g.adj[frontier][live[frontier]]
        nb = np.unique(nb[~seen[nb]])
        seen[nb] = True
        frontier = nb
    return seen


def _ensure_reachable(x: np.ndarray, g: Graph, max_rounds: int = 16,
                      device="cuda", xt: Optional[torch.Tensor] = None,
                      shortlist: int = 64, chunk: int = 256) -> int:
    """Attach unreachable vertices to their nearest reachable vertex
    (NSG spanning-tree fix), in place; returns how many attachments it
    made. As in JAX, per round, for each unreachable vertex in id order:
    the first of its 8 nearest reachable hosts with room gets a new edge,
    else the nearest reachable host with room, else the nearest full
    host whose last slot this round has not overwritten yet gives up
    that slot; reachability is re-checked each round.

    The ranking runs on the device: each vertex's ``shortlist`` nearest
    hosts by the brute force, re-ranked by the explicit difference, ties
    by id (JAX: numpy's unstable argsort). "Nearest host with room" is
    computed for ``chunk`` vertices at once and kept while its host still
    has room — the set of hosts with room only shrinks, so the kept host
    is still the nearest."""
    dev = torch.device(device)
    xt = D.as_tensor(x, dev) if xt is None else xt
    R = g.max_degree
    attached = 0
    for _ in range(max_rounds):
        seen = _reachable(g)
        missing = np.flatnonzero(~seen)
        if missing.size == 0:
            return attached
        reach = np.flatnonzero(seen)
        reach_t = torch.as_tensor(reach, device=dev)
        near = _nearest_hosts(xt, missing, reach_t,
                              min(shortlist, reach.size), g.metric)
        deg = g.deg.tolist()               # fast scalar reads; g.deg mirrors
        with_room = int((g.deg[reach] < R).sum())
        room_host: dict = {}
        used: set = set()                  # full hosts whose slot R-1 went
        for j, u in enumerate(missing.tolist()):
            h = next((h for h in near[j][:8].tolist() if deg[h] < R), None)
            if h is None and with_room:
                h = room_host.get(u)
                if h is None or deg[h] >= R:
                    room = reach[g.deg[reach] < R]
                    batch = missing[j: j + chunk]
                    room_host.update(zip(batch.tolist(), _nearest_hosts(
                        xt, batch, torch.as_tensor(room, device=dev),
                        min(8, room.size), g.metric)[:, 0].tolist()))
                    h = room_host[u]
            if h is not None:
                g.adj[h, deg[h]] = u
                deg[h] += 1
                g.deg[h] = deg[h]
                with_room -= deg[h] == R
                attached += 1
                continue
            if len(used) >= reach.size:    # every last slot is taken
                continue
            order = near[j]
            if all(h in used for h in order.tolist()):
                order = _nearest_hosts(xt, np.array([u]), reach_t,
                                       reach.size, g.metric)[0]
            h = next(h for h in order.tolist() if h not in used)
            g.adj[h, R - 1] = u
            used.add(h)
            attached += 1
    if not _reachable(g).all():
        raise RuntimeError("connectivity fix did not converge")
    return attached


def _nearest_hosts(xt: torch.Tensor, us: np.ndarray, hosts: torch.Tensor,
                   k: int, metric: str) -> np.ndarray:
    """[len(us), k] ids of ``hosts`` (ascending) nearest each u: the k
    nearest by the brute force, ordered by the explicit difference, ties
    by id."""
    out = []
    xh = xt[hosts]
    step = max(1, 2 ** 26 // max(hosts.numel(), 1))
    for s in range(0, us.size, step):
        ut = torch.as_tensor(us[s:s + step], device=xt.device)
        d = D.pairwise(xt[ut], xh, metric, device=xt.device)
        top = torch.sort(D.topk_smallest(d, k), dim=1).values
        cand = hosts[top]                                  # ids ascending
        dd = D.point_to_points(xt[ut], xt[cand], metric)
        o = torch.sort(dd, dim=1, stable=True).indices
        out.append(torch.gather(cand, 1, o).cpu().numpy())
    return np.concatenate(out)


# ---------------------------------------------------------------- entry

@dataclasses.dataclass
class HNSWGraph:
    """Multi-layer structure; ``layers[0]`` is the (disk) base graph and
    ``layers[1:]`` + ``level_ids`` form the in-memory upper layers."""
    layers: List[Graph]
    level_ids: List[np.ndarray]   # global ids of vertices on each level
    metric: str = "l2"

    @property
    def base(self) -> Graph:
        return self.layers[0]


def build_hnsw(x: np.ndarray, p: GraphParams, metric: str = "l2",
               level_mult: Optional[float] = None, device="cuda",
               stats: Optional[dict] = None) -> HNSWGraph:
    """HNSW's layers: vertex levels drawn as ``floor(-ln U · m_L)``
    (m_L = 1/ln Λ, capped at 6) from the seeded generator; level ``lv``
    holds every vertex of level >= lv, and its graph is Vamana at degree
    Λ (level 0 above 512 vertices) or NSG (degree max(Λ/2, 4) above
    level 0), built on ``device``. ``stats`` receives the base layer's
    build counters."""
    n = x.shape[0]
    rng = np.random.default_rng(p.seed)
    m = p.max_degree
    level_mult = level_mult or 1.0 / np.log(max(m, 2))
    levels = np.minimum(
        (-np.log(rng.uniform(size=n) + 1e-12) * level_mult).astype(np.int32),
        6)
    layers: List[Graph] = []
    level_ids: List[np.ndarray] = []
    for lv in range(int(levels.max()) + 1):
        ids = np.where(levels >= lv)[0].astype(np.int32)
        if ids.size < 2:
            break
        sub = x[ids]
        deg_cap = m if lv == 0 else max(m // 2, 4)
        gp = dataclasses.replace(p, max_degree=deg_cap,
                                 build_beam=max(p.build_beam, deg_cap))
        st = stats if lv == 0 else None
        g = (build_vamana(sub, gp, metric, device=device, stats=st)
             if lv == 0 and ids.size > 512
             else build_nsg(sub, gp, metric, device=device, stats=st))
        layers.append(g)
        level_ids.append(ids)
    return HNSWGraph(layers=layers, level_ids=level_ids, metric=metric)


def build_graph(x: np.ndarray, p: GraphParams, metric: str = "l2",
                device="cuda", stats: Optional[dict] = None) -> Graph:
    if p.algo == "vamana":
        return build_vamana(x, p, metric, device=device, stats=stats)
    if p.algo == "nsg":
        return build_nsg(x, p, metric, device=device, stats=stats)
    if p.algo == "hnsw":
        return build_hnsw(x, p, metric, device=device, stats=stats).base
    raise ValueError(p.algo)
