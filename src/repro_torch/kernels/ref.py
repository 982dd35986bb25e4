"""Plain PyTorch versions of the kernels.

``fused_round_ref`` is the straight-gather oracle of the whole round
stage (``repro.kernels.ref.fused_round_ref``); the search loop runs it
under ``fetch_impl="ref"``. The other three round functions are the
plain versions of the CUDA kernels in ``kernels.tier0_fetch``;
``pairwise_l2_ref`` and ``pq_adc_ref`` those of ``kernels.l2_tile`` and
``kernels.pq_adc``. The wrappers run them for CPU tensors, and
``chip_smoke.py`` holds each kernel against its plain version on the
card. ``tier0_fetch_rank_ref`` is the plain version of ``kernels.
tier0_fetch.tier0_fetch_rank``; ``block_topk_ref`` that of ``kernels.
block_topk`` (the kernel's own norm-expansion form), and
``block_rank_ref`` the twin of the JAX oracle ``repro.kernels.ref.
block_rank_ref`` (the explicit difference). Every index that the JAX
package clamps is clamped here too (JAX clamps out-of-range gathers;
torch would raise).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import dedup


def pairwise_l2_ref(q: torch.Tensor, x: torch.Tensor,
                    metric: str = "l2") -> torch.Tensor:
    """[Q, D] x [N, D] -> [Q, N] f32; squared L2 by the norm expansion
    ``max(|q|^2 + |x|^2 - 2 q.x, 0)``, or the negated inner product."""
    q32, x32 = q.to(torch.float32), x.to(torch.float32)
    dot = q32 @ x32.T
    if metric == "ip":
        return -dot
    qq = torch.sum(q32 * q32, dim=1, keepdim=True)
    xx = torch.sum(x32 * x32, dim=1)
    return torch.clamp_min(qq + xx[None, :] - 2.0 * dot, 0.0)


def pairwise_sum(terms) -> torch.Tensor:
    """Sum a list of equal-shape tensors in numpy's pairwise order (the
    order of ``np.sum`` along a contiguous axis of up to 128 terms):
    in order below 8 terms; else 8 running partial sums, strided by 8,
    reduced as ((r0+r1)+(r2+r3))+((r4+r5)+(r6+r7)), then the remainder
    added in order."""
    n = len(terms)
    if n < 8:
        acc = terms[0]
        for t in terms[1:]:
            acc = acc + t
        return acc
    r = list(terms[:8])
    i = 8
    while i < n - n % 8:
        for j in range(8):
            r[j] = r[j] + terms[i + j]
        i += 8
    acc = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]))
    for t in terms[i:]:
        acc = acc + t
    return acc


def pq_adc_ref(luts: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """luts [B, M, K] f32, codes [N, M] int -> [B, N] ADC distances,
    the M lookups summed in numpy's pairwise order (``pairwise_sum``:
    the order of the JAX host search's ``adc_distance``); codes past K
    clamp, as JAX gathers do."""
    c = codes.long().clamp(0, luts.shape[2] - 1)
    return pairwise_sum([luts[:, j, :][:, c[:, j]]
                         for j in range(luts.shape[1])])


def sq_dists(q: torch.Tensor, t: torch.Tensor, metric: str) -> torch.Tensor:
    """q [Q, D] vs t [Q, E, D] -> [Q, E] f32: sum of squared
    differences, or the negated inner product for ``ip``."""
    q32, t32 = q.to(torch.float32), t.to(torch.float32)
    if metric == "ip":
        return -torch.sum(t32 * q32[:, None, :], dim=-1)
    return torch.sum(torch.square(t32 - q32[:, None, :]), dim=-1)


def selection_order(dd: torch.Tensor, vid: torch.Tensor, u: torch.Tensor,
                    n_expand: int):
    """The masked selection key of a round and its stable top-``n_expand``
    order: targets (a slot holding a picked id) first at -inf, then the
    valid residents by distance, invalid slots at +inf."""
    eps = vid.shape[1] // u.shape[1]
    f_valid = torch.repeat_interleave(u >= 0, eps, dim=1)
    slot_valid = (vid >= 0) & f_valid
    dd_m = torch.where(slot_valid, dd, torch.full_like(dd, float("inf")))
    is_target = (vid[:, :, None] == u[:, None, :]).any(-1) & (vid >= 0)
    sel_key = torch.where(is_target, torch.full_like(dd, float("-inf")),
                          dd_m)
    order = torch.argsort(sel_key, dim=1, stable=True)[:, :n_expand]
    return sel_key, order.to(torch.int32)


def gather_unique_ref(uniq: torch.Tensor, vecs: torch.Tensor,
                      vid: torch.Tensor, nbrs: torch.Tensor):
    """Copy each listed block's payload: uniq [R] ->
    (tiles [R, eps, D], vid [R, eps], nbrs [R, eps, Lam])."""
    idx = uniq.long().clamp(0, vecs.shape[0] - 1)
    return vecs[idx], vid[idx], nbrs[idx]


def gather_union_ref(b: torch.Tensor, vecs: torch.Tensor,
                     vid: torch.Tensor, nbrs: torch.Tensor):
    """Whole-batch union of the target blocks b [Q, F], then one copy
    of each distinct block: -> (uniq [R], rank2d [Q, F] i32, tiles,
    vid, nbrs) with R = Q*F; rows past the distinct count hold
    block 0."""
    uniq, rank = dedup.sorted_unique_ranks(b.reshape(-1))
    tv, ti, tn = gather_unique_ref(uniq, vecs, vid, nbrs)
    return uniq, rank.reshape(b.shape), tv, ti, tn


def fused_round_rank_ref(queries, u, rank2d, uniq, hot_slot_of, hot_vecs,
                         hot_vid, hot_nbrs, tv, ti, tn, n_expand: int,
                         metric: str = "l2", bq: int = 128):
    """Pass 2b of the round (``repro.kernels.tier0_fetch._rank_kernel``):
    probe the tier-0 map for the union, take each distinct block's hot
    or cold tile, broadcast it through ``rank2d``, rank it, and order
    the expansions. A query tile of ``bq`` rows whose ``u`` are all -1
    gets the sentinels dd=0, vid=nbrs=-1, hit=0, order=0."""
    qn, f = u.shape
    eps = tv.shape[1]
    s = hot_slot_of[uniq.long().clamp(0, hot_slot_of.shape[0] - 1)]
    hot_u = s >= 0
    ss = s.long().clamp(0, hot_vecs.shape[0] - 1)
    tiles_u = torch.where(hot_u[:, None, None], hot_vecs[ss], tv)
    vid_u = torch.where(hot_u[:, None], hot_vid[ss], ti)
    nbrs_u = torch.where(hot_u[:, None, None], hot_nbrs[ss], tn)
    rk = rank2d.reshape(-1).long().clamp(0, uniq.shape[0] - 1)
    tiles = tiles_u[rk].reshape(qn, f * eps, -1)
    vid = vid_u[rk].reshape(qn, f * eps)
    nbrs = nbrs_u[rk].reshape(qn, f * eps, -1)
    hit = hot_u[rk].reshape(qn, f).to(torch.int32)
    dd = sq_dists(queries, tiles, metric)
    _, order = selection_order(dd, vid, u, n_expand)
    live = torch.repeat_interleave(
        (u >= 0).reshape(qn // bq, bq * f).any(1), bq)      # [Q]
    return (torch.where(live[:, None], dd, torch.zeros_like(dd)),
            torch.where(live[:, None], vid, torch.full_like(vid, -1)),
            torch.where(live[:, None, None], nbrs,
                        torch.full_like(nbrs, -1)),
            torch.where(live[:, None], hit, torch.zeros_like(hit)),
            torch.where(live[:, None], order, torch.zeros_like(order)))


def fused_round_ref(queries, u, block_of, hot_slot_of, hot_vecs, hot_vid,
                    hot_nbrs, vecs, vid, nbrs, n_expand: int,
                    metric: str = "l2"):
    """Oracle of the whole round stage: straight per-request gathers, no
    dedup (dedup only changes which gather produced a tile, never its
    payload). u [Q, F] picked ids (-1 = converged/empty) ->
    (dists [Q, F*eps], vid [Q, F*eps], nbrs [Q, F*eps, Lam],
    hit [Q, F] i32, order [Q, n_expand] i32)."""
    qn, f = u.shape
    eps = vecs.shape[1]
    b = block_of[u.long().clamp_min(0)].long()               # [Q, F]
    slot = hot_slot_of[b]
    hit = slot >= 0
    s_safe = slot.long().clamp_min(0)
    tiles = torch.where(hit[:, :, None, None], hot_vecs[s_safe], vecs[b])
    vid_g = torch.where(hit[:, :, None], hot_vid[s_safe],
                        vid[b]).reshape(qn, f * eps)
    nbrs_g = torch.where(hit[:, :, None, None], hot_nbrs[s_safe],
                         nbrs[b]).reshape(qn, f * eps, -1)
    dd = sq_dists(queries, tiles.reshape(qn, f * eps, -1), metric)
    _, order = selection_order(dd, vid_g, u, n_expand)
    return dd, vid_g, nbrs_g, hit.to(torch.int32), order


def tier0_fetch_rank_ref(queries, blocks, hot_slot_of, hot_vecs, cold_vecs,
                         metric: str = "l2"):
    """The tier-0 probe, the hot or cold tile and exact distances:
    queries [Q, D]; blocks [Q, F]; hot_slot_of [rho] (-1 = cold);
    hot_vecs [H, eps, D]; cold_vecs [rho, eps, D] ->
    (dists [Q, F*eps] f32, hit [Q, F] i32)."""
    b = blocks.long().clamp(0, cold_vecs.shape[0] - 1)
    slot = hot_slot_of[b]
    hit = slot >= 0
    tiles = torch.where(hit[:, :, None, None],
                        hot_vecs[slot.long().clamp(0, hot_vecs.shape[0] - 1)],
                        cold_vecs[b])
    qn, f, eps, d = tiles.shape
    return (sq_dists(queries, tiles.reshape(qn, f * eps, d), metric),
            hit.to(torch.int32))


def block_rank_ref(queries, tiles, top_m: int, metric: str = "l2"):
    """Twin of the JAX oracle: queries [Q, D]; tiles [Q, eps, D] ->
    (dists [Q, eps] by the explicit difference, top_idx [Q, min(top_m,
    eps)] i32, the stable ascending order)."""
    d = sq_dists(queries, tiles, metric)
    idx = torch.argsort(d, dim=1, stable=True)[:, :top_m]
    return d, idx.to(torch.int32)


def block_topk_ref(queries, tiles, top_m: int, metric: str = "l2"):
    """Plain version of the ``block_topk`` kernel: queries [Q, D]; tiles
    [Q, eps, D] -> (dists [Q, eps] f32 by the norm expansion
    ``max(|t|^2 + |q|^2 - 2 q.t, 0)`` or ``-q.t``, top_idx [Q, top_m]
    i32). The stable ascending order is the kernel's masked argmin for
    every distance below its 3e38 mask; slots past eps are 0."""
    q32, t32 = queries.to(torch.float32), tiles.to(torch.float32)
    dot = torch.einsum("qd,qed->qe", q32, t32)
    if metric == "ip":
        d = -dot
    else:
        tt = torch.sum(t32 * t32, dim=-1)
        qq = torch.sum(q32 * q32, dim=-1, keepdim=True)
        d = torch.clamp_min(tt + qq - 2.0 * dot, 0.0)
    idx = torch.argsort(d, dim=1, stable=True)[:, :top_m].to(torch.int32)
    pad = top_m - idx.shape[1]
    if pad > 0:
        idx = torch.nn.functional.pad(idx, (0, pad))
    return d, idx
