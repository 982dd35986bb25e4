"""Dispatch wrappers around the kernels (the port's ``repro.kernels.
ops``): ``pairwise_l2``, ``pq_adc_batch``, ``tier0_rank`` and
``block_rank`` at any shape (the CUDA kernels take any Q, N by bounds
checks, so nothing is padded), and the round stage, padded to the rank
pass's query tile with the padding stripped from the outputs
(``round_tile`` / ``fused_round``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import block_topk as _bt
from repro_torch.kernels import l2_tile as _l2
from repro_torch.kernels import pq_adc as _adc
from repro_torch.kernels import tier0_fetch as _t0


def pairwise_l2(q: torch.Tensor, x: torch.Tensor,
                metric: str = "l2") -> torch.Tensor:
    """[Q, D] x [N, D] -> [Q, N] distances via the l2_tile kernel."""
    return _l2.l2_tile(q.contiguous(), x.contiguous(), metric=metric)


def pq_adc_batch(codes: torch.Tensor, luts: torch.Tensor) -> torch.Tensor:
    """codes [N, M] u8 x luts [B, M, K] -> [B, N] ADC distances."""
    return _adc.pq_adc(codes.contiguous(),
                       luts.to(torch.float32).contiguous())


def block_rank(queries: torch.Tensor, tiles: torch.Tensor, top_m: int,
               metric: str = "l2"):
    """queries [Q, D] x gathered tiles [Q, eps, D] -> (dists [Q, eps],
    top_idx [Q, top_m]) via the block_topk kernel (norm-expansion
    distances; slots past eps hold 0)."""
    return _bt.block_topk(queries.to(torch.float32).contiguous(),
                          tiles.to(torch.float32).contiguous(), top_m,
                          metric=metric)


def tier0_rank(queries: torch.Tensor, blocks: torch.Tensor,
               hot_slot_of: torch.Tensor, hot_vecs: torch.Tensor,
               cold_vecs: torch.Tensor, metric: str = "l2"):
    """Tier-0 probe + gather + rank: queries [Q, D] x target blocks
    [Q, F] -> (dists [Q, F*eps], hit [Q, F] i32) via the
    tier0_fetch_rank kernel."""
    return _t0.tier0_fetch_rank(
        queries.to(torch.float32).contiguous(), blocks.contiguous(),
        hot_slot_of.contiguous(), hot_vecs.contiguous(),
        cold_vecs.contiguous(), metric=metric)


def round_tile(qn: int, cap: int = 0) -> int:
    """The query-tile size of the rank pass for a batch of ``qn``
    (``cap`` > 0 overrides the ``BQ`` ceiling). Dedup is batch-scope;
    the tile is the idle-skip / compaction granularity and the intra-
    vs cross-tile boundary of the ``dedup_saved`` accounting."""
    lim = cap if cap > 0 else _t0.BQ
    return min(lim, max(8, qn))


def fused_round(queries: torch.Tensor, u: torch.Tensor,
                block_of: torch.Tensor, hot_slot_of: torch.Tensor,
                hot_vecs: torch.Tensor, hot_vid: torch.Tensor,
                hot_nbrs: torch.Tensor, vecs: torch.Tensor,
                vid: torch.Tensor, nbrs: torch.Tensor, n_expand: int,
                metric: str = "l2", bq: int = None,
                fuse_union: bool = False):
    """The round stage at any batch size: padded query rows carry
    ``u = -1`` (converged), so all-pad tiles take the rank kernel's
    skip path; their outputs are sliced off."""
    qn = queries.shape[0]
    bq = bq or round_tile(qn)
    pad = (-qn) % bq
    qp = F.pad(queries, (0, 0, 0, pad)) if pad else queries
    up = F.pad(u, (0, 0, 0, pad), value=-1) if pad else u
    outs = _t0.fused_round(qp.contiguous(), up.contiguous(), block_of,
                           hot_slot_of, hot_vecs, hot_vid, hot_nbrs, vecs,
                           vid, nbrs, n_expand, metric=metric, bq=bq,
                           fuse_union=fuse_union)
    return tuple(o[:qn] for o in outs)
