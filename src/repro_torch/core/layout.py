"""Block-level graph layout and block shuffling, §4.1 (port of ``repro.
core.layout``).

A layout assigns |V| vertices to ρ blocks of ε slots, to maximise the
overlap ratio

    OR(u) = |B(u) ∩ N(u)| / (|B(u)| − 1)        (Eq. 5)
    OR(G) = mean_u OR(u).

Ported: the ID-contiguous baseline (``none``), BNP (one pass), BNF
(Algorithm 1) and its GP3 prioritized-restreaming order (``gp3``). BNS
and the k-means packer are not ported yet (``make_layout`` raises).

All of it is integer work on the host, as in the JAX package, and gives
the JAX package's layouts exactly. What differs is the cost of BNF's
per-vertex step: the JAX code runs ``np.bincount`` and ``np.argsort``
over all ρ block ids for every vertex (O(ρ) each, hours per round at 1M
vertices); here each round counts (vertex, block) pairs once for all
vertices with one sort, so a vertex's candidate blocks come from its own
neighbours only (O(deg)), in the same order — count descending, then
block id ascending — and the streaming loop walks that short list.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.graph import Graph


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


def make_layout(g: Graph, eps: int, scheme: str,
                x: Optional[np.ndarray] = None, bnf_iters: int = 8,
                bns_iters: int = 2, tau: float = 0.01,
                history: Optional[list] = None) -> BlockLayout:
    """The layout of ``scheme`` (none | bnp | bnf | gp3). ``history``,
    when given, receives OR(G) of the initial layout and of each
    shuffling round."""
    if scheme == "none":
        lay, hist = layout_sequential(g, eps), None
    elif scheme == "bnp":
        lay, hist = layout_bnp(g, eps), None
    elif scheme in ("bnf", "gp3"):
        lay, hist = layout_bnf(g, eps, iters=bnf_iters, tau=tau,
                               gain_order=scheme == "gp3")
    elif scheme in ("bns", "kmeans"):
        raise NotImplementedError(f"layout {scheme!r} is not ported yet "
                                  "(ROADMAP A1)")
    else:
        raise ValueError(scheme)
    if history is not None:
        history.extend(hist if hist is not None else [overlap_ratio(g, lay)])
    return lay
