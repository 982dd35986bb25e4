"""The round kernels of the batched device search (CUDA, ``csrc/
tier0_fetch.cu``) and their wrappers.

One search round, for the F candidates each query picked:

  * ``gather_union`` — the whole-batch sorted-unique union of the
    target blocks plus the slot -> unique-rank map, and one copy of each
    distinct block's vectors, ids and neighbour rows, in one launch: every
    CTA derives the union from a presence bitmap over the blocks, so any
    batch size is served. Replaces ``repro.kernels.tier0_fetch.
    gather_union``.
  * ``gather_unique`` — the copy alone, for a union computed by plain
    ops (the two-pass path, ``fuse_union=False``). Replaces
    ``gather_unique``.
  * ``fused_round_rank`` — pass 2b: tier-0 probe, hot/cold tile pick,
    broadcast through the rank map, exact distances and the stable
    top-``n_expand`` expansion order, one warp per query; an all-idle
    query tile writes sentinels. Replaces ``fused_round``'s
    ``_rank_kernel``.

``fused_round`` chains them as the JAX ``fused_round`` does.

  * ``tier0_fetch_rank`` — the probe and the distances alone, one warp
    per (query, block), four a CTA: the fetch stage of the kernel API
    (``ops.tier0_rank``), off the served path. Replaces
    ``tier0_fetch_rank`` (``_probe_kernel``) and shares the rank pass's
    distance function, so its distances are the rank pass's bits.

Every
wrapper runs its plain version (``kernels.ref``) when its tensors lie on
the CPU; for CUDA tensors it launches its kernel, or raises. Each
launch adds one to ``LAUNCHES[<wrapper name>]``; nothing else does.
The kernels are bound by the bytes they move (block payloads), see the
note at the top of the CUDA source.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, dedup, ref

BQ = 128          # query-tile size of the rank pass

LAUNCHES = {"gather_union": 0, "fused_round_rank": 0, "gather_unique": 0,
            "tier0_fetch_rank": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def _store_operands(vecs, vid, nbrs):
    return {"vecs": (vecs, torch.float32), "vid": (vid, torch.int32),
            "nbrs": (nbrs, torch.int32)}


def _launch_gather(uniq, vecs, vid, nbrs):
    rho, eps, d = vecs.shape
    lam = nbrs.shape[2]
    r = uniq.shape[0]
    tv = torch.empty((r, eps, d), dtype=torch.float32, device=vecs.device)
    ti = torch.empty((r, eps), dtype=torch.int32, device=vecs.device)
    tn = torch.empty((r, eps, lam), dtype=torch.int32, device=vecs.device)
    lib = _build.load("tier0_fetch")
    _build.check(lib.t0_gather(
        _ptr(uniq), r, _ptr(vecs), _ptr(vid), _ptr(nbrs), rho, eps, d, lam,
        _ptr(tv), _ptr(ti), _ptr(tn), _build.stream()), "t0_gather")
    return tv, ti, tn


def gather_unique(uniq: torch.Tensor, vecs: torch.Tensor,
                  vid: torch.Tensor, nbrs: torch.Tensor):
    """uniq [R] i32 block ids -> (tiles [R, eps, D] f32, vid [R, eps]
    i32, nbrs [R, eps, Lam] i32): one copy of each listed block."""
    if uniq.device.type == "cpu":
        return ref.gather_unique_ref(uniq, vecs, vid, nbrs)
    _build.require("gather_unique", uniq=(uniq, torch.int32),
                   **_store_operands(vecs, vid, nbrs))
    out = _launch_gather(uniq, vecs, vid, nbrs)
    LAUNCHES["gather_unique"] += 1
    return out


def gather_union(b: torch.Tensor, vecs: torch.Tensor, vid: torch.Tensor,
                 nbrs: torch.Tensor):
    """b [Q, F] i32 target blocks -> (uniq [R] i32, rank2d [Q, F] i32,
    tiles [R, eps, D], vid [R, eps], nbrs [R, eps, Lam]) with R = Q*F:
    the ascending distinct blocks (0 past the distinct count), each
    slot's rank among them, and one copy of each union row's block. Any
    R. Block ids must lie in [0, rho), as the serving path's do; the
    kernel clamps any other into range so that it reads nothing outside
    the store, so there its outputs may differ from the plain version's."""
    if b.device.type == "cpu":
        return ref.gather_union_ref(b, vecs, vid, nbrs)
    _build.require("gather_union", b=(b, torch.int32),
                   **_store_operands(vecs, vid, nbrs))
    qn, f = b.shape
    rho, eps, d = vecs.shape
    lam = nbrs.shape[2]
    r = qn * f
    dev = b.device
    uniq = torch.empty(r, dtype=torch.int32, device=dev)
    rank2d = torch.empty((qn, f), dtype=torch.int32, device=dev)
    tv = torch.empty((r, eps, d), dtype=torch.float32, device=dev)
    ti = torch.empty((r, eps), dtype=torch.int32, device=dev)
    tn = torch.empty((r, eps, lam), dtype=torch.int32, device=dev)
    lib = _build.load("tier0_fetch")
    in_smem = lib.t0_union_in_smem(rho)
    if in_smem < 0:
        raise RuntimeError(f"t0_union_in_smem: CUDA error {-in_smem}")
    # past a CTA's shared memory the bitmap lies in device memory, zeroed
    bm = (None if in_smem else
          torch.zeros((rho + 31) // 32, dtype=torch.int32, device=dev))
    _build.check(lib.t0_gather_union(
        _ptr(b), r, None if bm is None else _ptr(bm), _ptr(vecs), _ptr(vid),
        _ptr(nbrs), rho, eps, d, lam, _ptr(uniq), _ptr(rank2d), _ptr(tv),
        _ptr(ti), _ptr(tn), _build.stream()), "t0_gather_union")
    LAUNCHES["gather_union"] += 1
    return uniq, rank2d, tv, ti, tn


def fused_round_rank(queries, u, rank2d, uniq, hot_slot_of, hot_vecs,
                     hot_vid, hot_nbrs, tv, ti, tn, n_expand: int,
                     metric: str = "l2", bq: int = BQ):
    """Pass 2b of the round -> (dd [Q, F*eps] f32, vid [Q, F*eps] i32,
    nbrs [Q, F*eps, Lam] i32, hit [Q, F] i32, order [Q, n_expand] i32).
    Q must be a multiple of ``bq``."""
    qn, f = u.shape
    if qn % bq:
        raise ValueError(f"fused_round_rank: {qn} rows is not a multiple "
                         f"of the tile {bq}")
    if queries.device.type == "cpu":
        return ref.fused_round_rank_ref(
            queries, u, rank2d, uniq, hot_slot_of, hot_vecs, hot_vid,
            hot_nbrs, tv, ti, tn, n_expand, metric=metric, bq=bq)
    _build.require(
        "fused_round_rank", queries=(queries, torch.float32),
        u=(u, torch.int32), rank2d=(rank2d, torch.int32),
        uniq=(uniq, torch.int32), hot_slot_of=(hot_slot_of, torch.int32),
        hot_vecs=(hot_vecs, torch.float32), hot_vid=(hot_vid, torch.int32),
        hot_nbrs=(hot_nbrs, torch.int32), **_store_operands(tv, ti, tn))
    r, eps, d = tv.shape
    lam = tn.shape[2]
    if n_expand > f * eps:
        raise ValueError(f"fused_round_rank: n_expand {n_expand} exceeds "
                         f"the round's {f * eps} slots")
    dev = queries.device
    dd = torch.empty((qn, f * eps), dtype=torch.float32, device=dev)
    vid = torch.empty((qn, f * eps), dtype=torch.int32, device=dev)
    nbrs = torch.empty((qn, f * eps, lam), dtype=torch.int32, device=dev)
    hit = torch.empty((qn, f), dtype=torch.int32, device=dev)
    order = torch.empty((qn, n_expand), dtype=torch.int32, device=dev)
    lib = _build.load("tier0_fetch")
    _build.check(lib.t0_rank(
        _ptr(queries), _ptr(u), _ptr(rank2d), _ptr(uniq), r,
        _ptr(hot_slot_of), hot_slot_of.shape[0], _ptr(hot_vecs),
        _ptr(hot_vid), _ptr(hot_nbrs), hot_vecs.shape[0], _ptr(tv),
        _ptr(ti), _ptr(tn), qn, f, eps, d, lam, n_expand, bq,
        1 if metric == "ip" else 0, _ptr(dd), _ptr(vid), _ptr(nbrs),
        _ptr(hit), _ptr(order), _build.stream()), "t0_rank")
    LAUNCHES["fused_round_rank"] += 1
    return dd, vid, nbrs, hit, order


def fused_round(queries, u, block_of, hot_slot_of, hot_vecs, hot_vid,
                hot_nbrs, vecs, vid, nbrs, n_expand: int,
                metric: str = "l2", bq: int = BQ,
                fuse_union: bool = False):
    """One search round's fetch pipeline, batch-scope.

    queries [Q, D] f32; u [Q, F] i32 picked ids (-1 = converged/empty);
    block_of [N]; hot_slot_of [rho]; hot pack [H, eps, ...]; cold store
    [rho, eps, ...] -> (dists [Q, F*eps], vid [Q, F*eps], nbrs
    [Q, F*eps, Lam], hit [Q, F] i32, order [Q, n_expand] i32). Idle
    slots fold onto block 0's rank; their outputs are masked or skipped
    downstream. ``fuse_union`` runs the union inside ``gather_union``;
    otherwise it is plain ops followed by ``gather_unique`` (the
    two-pass twin). Both give the same outputs."""
    qn, f = u.shape
    b = block_of[u.long().clamp_min(0)]           # [Q, F] target blocks
    if fuse_union:
        uniq, rank2d, tv, ti, tn = gather_union(b, vecs, vid, nbrs)
    else:
        uniq, rank = dedup.sorted_unique_ranks(b.reshape(-1))
        rank2d = rank.reshape(qn, f)
        tv, ti, tn = gather_unique(uniq, vecs, vid, nbrs)
    return fused_round_rank(queries, u, rank2d, uniq, hot_slot_of,
                            hot_vecs, hot_vid, hot_nbrs, tv, ti, tn,
                            n_expand, metric=metric, bq=bq)


def tier0_fetch_rank(queries: torch.Tensor, blocks: torch.Tensor,
                     hot_slot_of: torch.Tensor, hot_vecs: torch.Tensor,
                     cold_vecs: torch.Tensor, metric: str = "l2"):
    """queries [Q, D] f32; blocks [Q, F] i32; hot_slot_of [rho] i32 (-1 =
    not packed); hot_vecs [H, eps, D] f32; cold_vecs [rho, eps, D] f32 ->
    (dists [Q, F*eps] f32, hit [Q, F] i32): each named block's tile from
    the hot pack where it is packed, else from the cold store, ranked
    exactly (sum of squared differences, or -q.t for ``ip``). Any Q;
    block ids and hot slots are clamped into range, as JAX gathers
    clamp."""
    if metric not in ("l2", "ip"):
        raise ValueError(f"unknown metric {metric!r} (l2 | ip)")
    if (queries.dim() != 2 or blocks.dim() != 2 or cold_vecs.dim() != 3
            or hot_vecs.shape[1:] != cold_vecs.shape[1:]
            or blocks.shape[0] != queries.shape[0]
            or cold_vecs.shape[2] != queries.shape[1]
            or hot_slot_of.shape != cold_vecs.shape[:1]
            or min(hot_vecs.shape[0], cold_vecs.shape[0]) < 1):
        raise ValueError(
            f"tier0_fetch_rank: shapes {tuple(queries.shape)}, "
            f"{tuple(blocks.shape)}, {tuple(hot_slot_of.shape)}, "
            f"{tuple(hot_vecs.shape)}, {tuple(cold_vecs.shape)} do not pair")
    if queries.device.type == "cpu":
        return ref.tier0_fetch_rank_ref(queries, blocks, hot_slot_of,
                                        hot_vecs, cold_vecs, metric)
    _build.require("tier0_fetch_rank", queries=(queries, torch.float32),
                   blocks=(blocks, torch.int32),
                   hot_slot_of=(hot_slot_of, torch.int32),
                   hot_vecs=(hot_vecs, torch.float32),
                   cold_vecs=(cold_vecs, torch.float32))
    qn, f = blocks.shape
    rho, eps, d = cold_vecs.shape
    dev = queries.device
    dd = torch.empty((qn, f * eps), dtype=torch.float32, device=dev)
    hit = torch.empty((qn, f), dtype=torch.int32, device=dev)
    lib = _build.load("tier0_fetch")
    _build.check(lib.t0_fetch_rank(
        _ptr(queries), _ptr(blocks), qn, f, _ptr(hot_slot_of), rho,
        _ptr(hot_vecs), hot_vecs.shape[0], _ptr(cold_vecs), eps, d,
        1 if metric == "ip" else 0, _ptr(dd), _ptr(hit), _build.stream()),
        "t0_fetch_rank")
    LAUNCHES["tier0_fetch_rank"] += 1
    return dd, hit
