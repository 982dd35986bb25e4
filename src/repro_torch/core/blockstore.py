"""Block-resident storage of the graph index (port of ``repro.core.
blockstore``): the block file's arrays, its byte accounting and the
block read the host search goes through (``read_block``: one I/O, one
block; the arrays stand in for the disk, so a read lands in host
memory).

Byte accounting follows Example 2: γ = D·b + 4 + Λ·4 bytes per vertex,
ε = ⌊η/γ⌋ vertices per η-KB block. Arrays:
  vid  [ρ, ε]        int32  vertex id per slot (-1 pad)
  vecs [ρ, ε, D]     f32    full-precision vectors
  meta [ρ, ε, 1+Λ]   int32  degree ‖ neighbour ids (-1 pad)

``packed()`` returns them as one fused [ρ, ε·(D+1+Λ)] f32 array (ids
bit-cast), as the JAX package's does.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from repro_torch.core.graph import Graph
from repro_torch.core.layout import BlockLayout


@dataclasses.dataclass
class BlockStore:
    vid: np.ndarray
    vecs: np.ndarray
    meta: np.ndarray
    block_kb: float
    dtype_bytes: int = 4

    @property
    def num_blocks(self) -> int:
        return self.vid.shape[0]

    @property
    def verts_per_block(self) -> int:
        return self.vid.shape[1]

    @property
    def dim(self) -> int:
        return self.vecs.shape[2]

    @property
    def max_degree(self) -> int:
        return self.meta.shape[2] - 1

    def vertex_bytes(self) -> int:
        """γ in bytes (Example 2)."""
        return self.dim * self.dtype_bytes + 4 + self.max_degree * 4

    def disk_bytes(self) -> int:
        """Total 'disk' footprint: ρ blocks of η KB."""
        return int(self.num_blocks * self.block_kb * 1024)

    def read_block(self, b: int) -> Tuple[np.ndarray, np.ndarray,
                                          np.ndarray, np.ndarray]:
        """One I/O: (ids [ε], vecs [ε, D], deg [ε], nbrs [ε, Λ])."""
        return (self.vid[b], self.vecs[b],
                self.meta[b, :, 0], self.meta[b, :, 1:])

    def packed(self) -> np.ndarray:
        """[ρ, ε·(D+1+Λ)] f32 fused tile (ids bit-cast to f32)."""
        rho, eps, d = self.vecs.shape
        meta_f = self.meta.view(np.float32).reshape(rho, eps, -1)
        return np.concatenate([self.vecs, meta_f], axis=2).reshape(rho, -1)


def build_store(x: np.ndarray, g: Graph, layout: BlockLayout,
                block_kb: float, dtype_bytes: int = 4) -> BlockStore:
    """Lay the vectors and adjacency out in block order."""
    rho, eps = layout.blocks.shape
    vid = layout.blocks.copy()
    vecs = np.zeros((rho, eps, x.shape[1]), np.float32)
    meta = np.full((rho, eps, 1 + g.max_degree), -1, np.int32)
    meta[:, :, 0] = 0
    valid = vid >= 0
    ids = vid[valid].astype(np.int64)
    vecs[valid] = x[ids]
    meta[valid, 0] = g.deg[ids]
    meta[valid, 1:] = g.adj[ids]
    return BlockStore(vid=vid, vecs=vecs, meta=meta, block_kb=block_kb,
                      dtype_bytes=dtype_bytes)
