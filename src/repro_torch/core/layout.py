"""Block-level graph layout and block shuffling, §4.1 (port of ``repro.
core.layout``).

A layout assigns |V| vertices to ρ blocks of ε slots, to maximise the
overlap ratio

    OR(u) = |B(u) ∩ N(u)| / (|B(u)| − 1)        (Eq. 5)
    OR(G) = mean_u OR(u).

The schemes: the ID-contiguous baseline (``none``), BNP (one pass), BNF
(Algorithm 1) and its GP3 prioritized-restreaming order (``gp3``), BNS
(Algorithm 3, seeded by BNF) and the k-means packer of §7 / App. G
(``kmeans``).

All but the k-means packer are integer work on the host, as in the JAX
package, and give the JAX package's layouts exactly. The k-means
packer's assignment runs on ``device`` through ``distances.pairwise``
(the ``l2_tile`` kernel on the card); its centroid means stay numpy.
What differs is the cost of BNF's per-vertex step: the JAX code runs
``np.bincount`` and ``np.argsort`` over all ρ block ids for every vertex
(O(ρ) each, hours per round at 1M vertices); here each round counts
(vertex, block) pairs once for all vertices with one sort, so a vertex's
candidate blocks come from its own neighbours only (O(deg)), in the same
order — count descending, then block id ascending — and the streaming
loop walks that short list.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import distances as D
from repro_torch.core.graph import Graph

# floats of one k-means distance block (rows x centroids) on each device
_KMEANS_ELEMS = {"cuda": 2 ** 28, "cpu": 2 ** 24}


@dataclasses.dataclass
class BlockLayout:
    """blocks[b] lists vertex ids in block b (-1 padded);
    block_of[u] / slot_of[u] invert the map (the C_mapping of Eq. 10)."""
    blocks: np.ndarray        # [ρ, ε] int32, -1 padded
    block_of: np.ndarray      # [N] int32
    slot_of: np.ndarray       # [N] int32

    @property
    def num_blocks(self) -> int:
        return self.blocks.shape[0]

    @property
    def verts_per_block(self) -> int:
        return self.blocks.shape[1]

    def validate(self) -> None:
        """Raise unless the layout is a bijection V -> (block, slot)."""
        n = self.block_of.shape[0]
        flat = self.blocks[self.blocks >= 0]
        if flat.shape[0] != n:
            raise ValueError("a vertex is not assigned exactly once")
        if not np.array_equal(np.sort(flat), np.arange(n)):
            raise ValueError("the blocks do not hold a permutation")
        if not np.all(self.blocks[self.block_of, self.slot_of]
                      == np.arange(n)):
            raise ValueError("block_of / slot_of do not invert blocks")

    def mapping_bytes(self) -> int:
        """C_mapping memory charge (Eq. 10): block id + slot per vertex."""
        return self.block_of.nbytes + self.slot_of.nbytes


def _from_block_of(block_of: np.ndarray, rho: int, eps: int) -> BlockLayout:
    """Invert vertex -> block into block slots, vertices in id order
    within a block."""
    block_of = np.asarray(block_of, np.int32)
    n = block_of.shape[0]
    order = np.argsort(block_of, kind="stable")
    starts = np.concatenate([[0], np.cumsum(np.bincount(
        block_of, minlength=rho))[:-1]])
    slot_of = np.empty(n, np.int32)
    slot_of[order] = np.arange(n) - starts[block_of[order]]
    blocks = np.full((rho, eps), -1, np.int32)
    blocks[block_of[order], slot_of[order]] = order
    return BlockLayout(blocks=blocks, block_of=block_of, slot_of=slot_of)


def _neighbor_keys(g: Graph) -> np.ndarray:
    """Sorted u*N+v keys of all directed edges, for O(log E) membership."""
    e = g.edges().astype(np.int64)
    return np.sort(e[:, 0] * g.num_vertices + e[:, 1])


def overlap_ratio(g: Graph, layout: BlockLayout,
                  keys: Optional[np.ndarray] = None) -> float:
    """OR(G) (Eq. 5)."""
    return float(per_vertex_overlap(g, layout, keys).mean())


def per_vertex_overlap(g: Graph, layout: BlockLayout,
                       keys: Optional[np.ndarray] = None) -> np.ndarray:
    n = g.num_vertices
    keys = _neighbor_keys(g) if keys is None else keys
    members = layout.blocks[layout.block_of]          # [N, ε]
    valid = (members >= 0) & (members != np.arange(n)[:, None])
    pair = np.arange(n, dtype=np.int64)[:, None] * n + members
    idx = np.searchsorted(keys, pair.ravel())
    idx = np.minimum(idx, keys.shape[0] - 1)
    hit = (keys[idx] == pair.ravel()).reshape(n, -1) & valid
    sizes = (members >= 0).sum(axis=1)
    denom = np.maximum(sizes - 1, 1)
    orr = hit.sum(axis=1) / denom
    orr[sizes <= 1] = 0.0
    return orr.astype(np.float32)


def layout_sequential(g: Graph, eps: int) -> BlockLayout:
    """DiskANN baseline: ID-contiguous vertices per block (Fig. 2(a))."""
    n = g.num_vertices
    rho = -(-n // eps)
    return _from_block_of((np.arange(n) // eps).astype(np.int32), rho, eps)


def layout_bnp(g: Graph, eps: int) -> BlockLayout:
    """Block Neighbor Padding: scan ids ascending; place each unassigned
    vertex, then pad its block with its unassigned neighbours."""
    n = g.num_vertices
    rho = -(-n // eps)
    block_of = [-1] * n
    rows = g.adj.tolist()
    degs = g.deg.tolist()
    cur, fill = 0, 0
    for u in range(n):
        if block_of[u] >= 0:
            continue
        if fill >= eps:
            cur, fill = cur + 1, 0
        block_of[u] = cur
        fill += 1
        for v in rows[u][: degs[u]]:
            if fill >= eps:
                break
            if block_of[v] < 0:
                block_of[v] = cur
                fill += 1
        if fill >= eps:
            cur, fill = cur + 1, 0
    return _from_block_of(np.asarray(block_of, np.int32), rho, eps)


def _symmetric_csr(g: Graph) -> Tuple[np.ndarray, np.ndarray]:
    """(src, dst) of every edge in both directions, sorted by src with
    the out-edges before the in-edges of each vertex (the JAX order)."""
    e = g.edges().astype(np.int64)
    sym = np.concatenate([e, e[:, ::-1]], axis=0)
    sym = sym[np.argsort(sym[:, 0], kind="stable")]
    return sym[:, 0], sym[:, 1]


def _block_candidates(src: np.ndarray, dst_block: np.ndarray, n: int,
                      rho: int):
    """Each vertex's neighbour blocks, ordered by neighbour count
    descending then block id ascending (``np.argsort(-np.bincount(row),
    kind="stable")`` cut at the first zero count), as a CSR: (starts
    [N+1], blocks, counts)."""
    key = src * rho + dst_block
    uk, cnt = np.unique(key, return_counts=True)      # sorted (u, block)
    cu = uk // rho
    top = int(cnt.max()) + 1 if cnt.size else 1
    o = np.argsort(cu * top + (top - 1 - cnt), kind="stable")
    starts = np.searchsorted(cu[o], np.arange(n + 1))
    return starts, (uk % rho)[o].astype(np.int64), cnt[o]


def layout_bnf(g: Graph, eps: int, iters: int = 8, tau: float = 0.01,
               init: Optional[BlockLayout] = None,
               gain_order: bool = False) -> Tuple[BlockLayout, List[float]]:
    """Block Neighbor Frequency (Algorithm 1).

    Each round: snapshot D = vertex -> block; re-stream the vertices,
    assigning each to the non-full block that holds most of its
    neighbours under D (in- and out-edges both count); a vertex with no
    such block spills to the first non-full block. Stops when the OR(G)
    gain of a round falls below τ, or after β rounds. Vertices stream
    grouped by their previous block, or, with ``gain_order`` (GP3), by
    their best block's neighbour count descending.

    Returns (best_layout, [OR(G) before the first round and after each])."""
    n = g.num_vertices
    rho = -(-n // eps)
    layout = init if init is not None else layout_bnp(g, eps)
    keys = _neighbor_keys(g)
    history = [overlap_ratio(g, layout, keys)]
    best, best_or = layout, history[0]
    prev = layout.block_of.copy()
    src, dst = _symmetric_csr(g)

    for _ in range(iters):
        starts, cblk, ccnt = _block_candidates(src, prev[dst].astype(
            np.int64), n, rho)
        has = starts[1:] > starts[:-1]
        if gain_order:
            gains = np.zeros(n, np.int64)
            gains[has] = ccnt[starts[:-1][has]]
            order = np.argsort(-gains, kind="stable")
        else:
            order = np.argsort(prev, kind="stable")
        first = np.full(n, -1, np.int64)
        first[has] = cblk[starts[:-1][has]]
        first = first.tolist()
        st = starts.tolist()
        new = [0] * n
        fill = [0] * rho
        spill = 0
        for u in order.tolist():
            b = first[u]
            if b >= 0:
                if fill[b] < eps:
                    new[u] = b
                    fill[b] += 1
                    continue
                placed = False
                for b in cblk[st[u] + 1: st[u + 1]].tolist():
                    if fill[b] < eps:
                        new[u] = b
                        fill[b] += 1
                        placed = True
                        break
                if placed:
                    continue
            while fill[spill] >= eps:                # lines 13-14: spill
                spill += 1
            new[u] = spill
            fill[spill] += 1
        new_arr = np.asarray(new, np.int32)
        layout = _from_block_of(new_arr, rho, eps)
        cur = overlap_ratio(g, layout, keys)
        gain = cur - history[-1]
        history.append(cur)
        prev = new_arr
        if cur > best_or:
            best, best_or = layout, cur
        if gain < tau:
            break
    return best, history


# --------------------------------------------------------------------- BNS

def layout_bns(g: Graph, eps: int, iters: int = 2, tau: float = 0.01,
               init: Optional[BlockLayout] = None,
               rng_seed: int = 0) -> Tuple[BlockLayout, list]:
    """Block Neighbor Swap (Algorithm 3).

    For each vertex u and each pair (a, e) of its neighbours living in
    different blocks, swap the min-OR vertices of B(a) and B(e) iff the
    summed OR of the two blocks strictly increases, so OR(G) never falls
    across the rounds (Lemma 4.2). Returns (layout, [OR(G) of ``init``
    and after each round]).

    Sequential greedy swapping on the host, the JAX package's loop over
    the same lists and sets: each decision depends on the ones before
    it, so the blocks and the history equal JAX's. It costs
    O(β·Λ²·ε²·N) Python steps, which is why the paper runs it only at
    small sizes (App. F: 1,200 vectors). ``rng_seed`` is the JAX
    signature's; neither package reads it."""
    n = g.num_vertices
    rho = -(-n // eps)
    layout = init if init is not None else layout_bnp(g, eps)
    keys = _neighbor_keys(g)
    block_of = layout.block_of.tolist()
    blocks = [layout.blocks[b][layout.blocks[b] >= 0].tolist()
              for b in range(rho)]
    rows = [g.adj[u, : g.deg[u]].tolist() for u in range(n)]
    nbr_sets = [set(r) for r in rows]

    def or_of_vertex(u: int, members) -> float:
        others = [m for m in members if m != u]
        if not others:
            return 0.0
        return sum(1 for m in others if m in nbr_sets[u]) / len(others)

    def or_of_block(members) -> float:
        if not members:
            return 0.0
        return sum(or_of_vertex(u, members) for u in members) / len(members)

    history = [overlap_ratio(g, layout, keys)]
    for _ in range(iters):
        for u in range(n):
            nb = rows[u]
            for i in range(len(nb)):
                for j in range(i + 1, len(nb)):
                    a, e = nb[i], nb[j]
                    ba, be = block_of[a], block_of[e]
                    if ba == be:
                        continue
                    ma, me = blocks[ba], blocks[be]
                    x = min(ma, key=lambda v: or_of_vertex(v, ma))
                    y = min(me, key=lambda v: or_of_vertex(v, me))
                    old = or_of_block(ma) + or_of_block(me)
                    ma2 = [v for v in ma if v != x] + [y]
                    me2 = [v for v in me if v != y] + [x]
                    new = or_of_block(ma2) + or_of_block(me2)
                    if new > old + 1e-12:
                        blocks[ba], blocks[be] = ma2, me2
                        block_of[x], block_of[y] = be, ba
        cur = overlap_ratio(g, _pack(blocks, rho, eps, n), keys)
        history.append(cur)
        if cur - history[-2] < tau:
            break
    return _pack(blocks, rho, eps, n), history


def _pack(block_lists, rho: int, eps: int, n: int) -> BlockLayout:
    """Block lists -> a layout, each block's vertices in list order."""
    blocks = np.full((rho, eps), -1, np.int32)
    block_of = np.empty(n, np.int32)
    slot_of = np.empty(n, np.int32)
    for b, mem in enumerate(block_lists):
        blocks[b, : len(mem)] = mem
        block_of[mem] = b
        slot_of[mem] = np.arange(len(mem), dtype=np.int32)
    return BlockLayout(blocks=blocks, block_of=block_of, slot_of=slot_of)


# ------------------------------------------------------ the k-means packer

def kmeans_assign(xt: torch.Tensor, cent: np.ndarray) -> np.ndarray:
    """[N] int64 nearest centroid of each row of ``xt`` [N, D] (on its
    device): ``argmin(distances.pairwise(x, cent), axis=1)``, the lower
    index first on ties, in row chunks of ``_KMEANS_ELEMS`` distances so
    that [N, k] is never held whole. Each distance is the ``l2_tile``
    element of its (row, centroid) pair, whatever the chunk."""
    dev = xt.device
    ct = D.as_tensor(cent, dev)
    cap = _KMEANS_ELEMS.get(dev.type, _KMEANS_ELEMS["cpu"])
    chunk = max(1, cap // max(ct.shape[0], 1))
    out = np.empty(xt.shape[0], np.int64)
    for s in range(0, xt.shape[0], chunk):
        d = D.pairwise(xt[s:s + chunk], ct, device=dev)
        out[s:s + chunk] = torch.argmin(d, dim=1).cpu().numpy()
    return out


def cluster_means(x: np.ndarray, assign: np.ndarray,
                  cent: np.ndarray) -> None:
    """``cent[c] = x[assign == c].mean(axis=0)`` for every non-empty
    cluster c, from one stable sort of ``assign``: each cluster is a
    contiguous slice holding its rows in id order, the rows the mask
    would pick, so numpy's mean gives the mask form's bits."""
    order = np.argsort(assign, kind="stable")
    xs = x[order]
    counts = np.bincount(assign, minlength=cent.shape[0])
    ends = np.cumsum(counts)
    for c in np.flatnonzero(counts).tolist():
        cent[c] = xs[ends[c] - counts[c]: ends[c]].mean(axis=0)


def layout_kmeans(x: np.ndarray, g: Graph, eps: int, iters: int = 8,
                  seed: int = 0, device="cuda") -> BlockLayout:
    """§7's 'naive strategy that assigns vertices to blocks by k-means':
    k = ρ/4 centroids drawn by the seeded generator, ``iters`` Lloyd
    steps, then blocks filled from the vertices in cluster order. The
    assignment runs on ``device`` (``kmeans_assign``), the centroid
    update on the host (``cluster_means``)."""
    n = x.shape[0]
    rho = -(-n // eps)
    rng = np.random.default_rng(seed)
    k = max(rho // 4, 1)
    cent = x[rng.choice(n, size=k, replace=False)].astype(np.float32)
    xt = D.as_tensor(x, torch.device(device))
    for _ in range(iters):
        assign = kmeans_assign(xt, cent)
        cluster_means(x, assign, cent)
    order = np.argsort(assign, kind="stable")
    block_of = np.empty(n, np.int32)
    block_of[order] = (np.arange(n) // eps).astype(np.int32)
    return _from_block_of(block_of, rho, eps)


def make_layout(g: Graph, eps: int, scheme: str,
                x: Optional[np.ndarray] = None, bnf_iters: int = 8,
                bns_iters: int = 2, tau: float = 0.01,
                history: Optional[list] = None,
                device="cuda") -> BlockLayout:
    """The layout of ``scheme`` (none | bnp | bnf | gp3 | bns | kmeans).
    ``bns`` starts from BNF's layout; ``kmeans`` needs the vectors ``x``
    and runs its assignment on ``device``. ``history``, when given,
    receives OR(G) of the initial layout and of each shuffling round
    (for ``bns``: BNF's history, then BNS's rounds)."""
    if scheme == "none":
        lay, hist = layout_sequential(g, eps), None
    elif scheme == "bnp":
        lay, hist = layout_bnp(g, eps), None
    elif scheme in ("bnf", "gp3"):
        lay, hist = layout_bnf(g, eps, iters=bnf_iters, tau=tau,
                               gain_order=scheme == "gp3")
    elif scheme == "bns":
        init, hist = layout_bnf(g, eps, iters=bnf_iters, tau=tau)
        lay, bns_hist = layout_bns(g, eps, iters=bns_iters, tau=tau,
                                   init=init)
        hist = hist + bns_hist[1:]
    elif scheme == "kmeans":
        if x is None:
            raise ValueError("the k-means layout needs the vectors x")
        lay, hist = layout_kmeans(x, g, eps, device=device), None
    else:
        raise ValueError(scheme)
    if history is not None:
        history.extend(hist if hist is not None else [overlap_ratio(g, lay)])
    return lay
