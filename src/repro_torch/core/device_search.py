"""Batched Starling search on the card (PyTorch port of
``repro.core.device_search``: ``from_segment``, ``device_anns``,
``device_range_search``, the online tier-0 ``repack_tier0``, and the
multi-rank ``make_search_step`` over ``torch.distributed``).

One loop over rounds for a whole query batch. Each round every live
query picks its F best open candidates; the round stage
(``kernels.fused_round``) probes the tier-0 hot-tile pack, gathers each
distinct cold block once for the whole batch, ranks the residents
exactly and orders the σ-pruned expansions; new neighbours are routed
by PQ-ADC. Converged queries request nothing (the -1 sentinel) and are
left out of every counter; ``compact_frac`` > 0 stably repacks live
queries to the front so converged ones fill whole idle tiles.

Differences from the JAX loop, none of which changes a result:
  * ``lax.while_loop`` is a Python loop whose condition reads one flag
    from the card per round; ``lax.cond`` is a Python branch;
  * ``lax.top_k`` and ``lexsort`` are stable sorts (``top_k`` puts the
    lower index first on ties, ``torch.topk`` does not);
  * the visited bitmask holds int32 words (torch's uint32 lacks shifts
    on the CPU); bits are set in place, query by query as in JAX;
  * indices are int64 where torch needs them, and every index JAX
    clamps is clamped.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.params import DeviceSearchParams
from repro_torch.distributed.sharding import ArgSpec  # noqa: F401 (re-export)
from repro_torch.io import hotset
from repro_torch import kernels as K
from repro_torch.kernels import dedup, ref
from repro_torch.pq.pq import lut_batch

# per-round trace columns: the import-free twin of obs.roundlog.ROUND_LOG_COLS
# (the tests hold both equal to the JAX package's)
_ROUND_LOG_COLS = ("live", "cold", "tier0", "joins", "joins_x",
                   "compacted", "spec_hits", "spec_wasted")

_INF = float("inf")


@dataclasses.dataclass
class DeviceSegment:
    """One segment, resident on one device. ``hot_*`` is the tier-0
    pack (exact copies of the hottest blocks), ``hot_slot_of[b]`` maps
    block -> hot slot (-1 = cold); H >= 1 always (a disabled tier 0 is
    one zeroed slot the map never points at)."""
    vecs: torch.Tensor          # [rho, eps, D] f32
    vid: torch.Tensor           # [rho, eps] i32 (-1 pad)
    deg: torch.Tensor           # [rho, eps] i32
    nbrs: torch.Tensor          # [rho, eps, Lam] i32 (-1 pad)
    block_of: torch.Tensor      # [N] i32
    pq_codes: torch.Tensor      # [N, M] u8
    pq_cent: torch.Tensor       # [M, K, dsub] f32
    nav_vecs: torch.Tensor      # [n', D] f32
    nav_adj: torch.Tensor       # [n', deg'] i32 (-1 pad)
    nav_ids: torch.Tensor       # [n'] i32 global ids
    nav_entry: torch.Tensor     # scalar i32 (nav-local)
    hot_vecs: torch.Tensor      # [H, eps, D]
    hot_vid: torch.Tensor       # [H, eps] i32
    hot_nbrs: torch.Tensor      # [H, eps, Lam] i32
    hot_slot_of: torch.Tensor   # [rho] i32

    @property
    def device(self) -> torch.device:
        return self.vecs.device

    def to(self, device) -> "DeviceSegment":
        return DeviceSegment(**{f.name: getattr(self, f.name).to(device)
                                for f in dataclasses.fields(self)})

    def nbytes(self) -> dict:
        """Device bytes per array."""
        return {f.name: getattr(self, f.name).numel()
                * getattr(self, f.name).element_size()
                for f in dataclasses.fields(self)}


class DeviceSearchResult(NamedTuple):
    """Per-query outputs of ``device_anns`` (see the JAX twin)."""
    ids: torch.Tensor           # [Q, k]
    dists: torch.Tensor         # [Q, k]
    io: torch.Tensor            # [Q] cold block touches (pre-dedup)
    hops: torch.Tensor          # [Q] round trips
    tier0_hits: torch.Tensor    # [Q] touches served by the hot pack
    dedup_saved: torch.Tensor   # [Q] cold touches that joined a gather
    dedup_cross: torch.Tensor   # [Q] the cross-tile subset
    spec_hits: torch.Tensor     # [Q] (speculate) predicted paying gathers
    spec_wasted: torch.Tensor   # [Q] (speculate) unconsumed predictions
    rounds: int                 # loop rounds the batch ran
    round_log: Optional[torch.Tensor] = None   # [max_hops, 8] i32


class DeviceRangeResult(NamedTuple):
    """Per-query outputs of ``device_range_search`` (counters summed
    over all its rounds)."""
    ids: torch.Tensor           # [Q, k_cap]
    dists: torch.Tensor         # [Q, k_cap]
    in_range: torch.Tensor      # [Q, k_cap] bool
    io: torch.Tensor            # [Q] cold block touches
    tier0_hits: torch.Tensor    # [Q]
    dedup_saved: torch.Tensor   # [Q]
    dedup_cross: torch.Tensor   # [Q]
    spec_hits: torch.Tensor     # [Q]
    spec_wasted: torch.Tensor   # [Q]
    rounds: int                 # loop rounds of all range rounds


def _tier0_pack(seg, num_blocks: int, observed=None, plan=None):
    """Select and pack the tier-0 hot set (host side, build time)
    through ``hotset.plan_tier0``, exactly as the JAX ``_tier0_pack``."""
    vecs, vid, meta = seg.vecs, seg.vid, seg.meta
    rho, eps = vid.shape
    hot: list = []
    if num_blocks > 0:
        if plan is not None:
            if len(plan) != min(num_blocks, rho):
                raise ValueError(
                    f"tier-0 plan selects {len(plan)} blocks for a "
                    f"{min(num_blocks, rho)}-slot budget")
            hot = [int(b) for b in plan]
        else:
            ranking = hotset.hot_block_ranking(
                seg.block_of, seg.adj, seg.deg, hotset.view_seed_ids(seg.view))
            hot = hotset.plan_tier0(ranking, observed or {}, num_blocks,
                                    rho)
    slot_of = np.full(rho, -1, np.int32)
    if hot:
        hb = np.asarray(hot, np.int64)
        slot_of[hb] = np.arange(len(hot), dtype=np.int32)
        return (vecs[hb], vid[hb], meta[hb, :, 1:], slot_of)
    return (np.zeros((1,) + vecs.shape[1:], vecs.dtype),
            np.full((1, eps), -1, vid.dtype),
            np.full((1, eps, meta.shape[2] - 1), -1, meta.dtype),
            slot_of)


def from_segment(seg, tier0_blocks: Optional[int] = None,
                 tier0_frac: Optional[float] = None, observed=None,
                 device="cuda") -> DeviceSegment:
    """Host ``Segment`` -> ``DeviceSegment`` on ``device``.

    The tier-0 budget comes from ``tier0_blocks``, else ``tier0_frac``
    of the block file, else ``seg.params.cache``. ``observed`` (block ->
    demand count) re-ranks the pack. The pack holds exact copies, so
    the budget never changes (ids, dists)."""
    if tier0_blocks is None:
        block_bytes = max(int(seg.block_kb * 1024), 1)
        if tier0_frac is not None:
            tier0_blocks = int(tier0_frac * seg.num_blocks)
        else:
            tier0_blocks = (seg.params.cache.resolve_tier0_budget(
                seg.disk_bytes()) // block_bytes)
    hot_vecs, hot_vid, hot_nbrs, slot_of = _tier0_pack(
        seg, tier0_blocks, observed=observed)

    def put(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    i32, f32 = torch.int32, torch.float32
    return DeviceSegment(
        vecs=put(seg.vecs, f32), vid=put(seg.vid, i32),
        deg=put(seg.meta[:, :, 0], i32), nbrs=put(seg.meta[:, :, 1:], i32),
        block_of=put(seg.block_of, i32),
        pq_codes=put(seg.pq_codes, torch.uint8),
        pq_cent=put(seg.pq_cent, f32), nav_vecs=put(seg.nav_vecs, f32),
        nav_adj=put(seg.nav_adj, i32), nav_ids=put(seg.nav_ids, i32),
        nav_entry=torch.tensor(int(seg.nav_entry), dtype=i32,
                               device=device),
        hot_vecs=put(hot_vecs, f32), hot_vid=put(hot_vid, i32),
        hot_nbrs=put(hot_nbrs, i32), hot_slot_of=put(slot_of, i32))


def hot_pack_blocks(ds: DeviceSegment) -> set:
    """The block ids in the tier-0 pack (empty when tier 0 is off)."""
    return set(np.flatnonzero(ds.hot_slot_of.cpu().numpy() >= 0).tolist())


def repack_tier0(ds: DeviceSegment, seg, observed, plan=None):
    """Rebuild only the tier-0 pack of ``ds`` at its current budget,
    re-ranked by ``observed`` per-block demand counts (or the given
    ``plan``), from the host ``Segment`` it was packed from. Every other
    array is reused. Returns ``(new_ds, changed)``, ``changed`` the
    number of packed blocks that were not packed before. The pack holds
    exact copies either way, so results are the same before and after;
    only the io / tier0_hits split moves."""
    old = hot_pack_blocks(ds)
    hot_vecs, hot_vid, hot_nbrs, slot_of = _tier0_pack(
        seg, len(old), observed=observed, plan=plan)
    new = set(np.flatnonzero(slot_of >= 0).tolist())

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=ds.device)

    out = dataclasses.replace(
        ds, hot_vecs=put(hot_vecs).to(ds.hot_vecs.dtype),
        hot_vid=put(hot_vid).to(torch.int32),
        hot_nbrs=put(hot_nbrs).to(torch.int32),
        hot_slot_of=put(slot_of).to(torch.int32))
    return out, len(new - old)


def tier0_bytes(ds: DeviceSegment) -> int:
    """Bytes the hot-tile pack reserves on the device (0 when off)."""
    packed = int((ds.hot_slot_of >= 0).sum())
    if packed == 0:
        return 0
    nb = ds.nbytes()
    per_block = ((nb["hot_vecs"] + nb["hot_vid"] + nb["hot_nbrs"])
                 // ds.hot_vecs.shape[0])
    return packed * int(per_block)


# ------------------------------------------------------------- utilities

def _dists(q: torch.Tensor, x: torch.Tensor, metric: str) -> torch.Tensor:
    """q [Q, D] vs x [Q, E, D] -> [Q, E] (f32)."""
    return ref.sq_dists(q, x, metric)


_adc_lut = lut_batch          # q [Q, D], cent [M, K, dsub] -> [Q, M, K]


def _adc(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """lut [Q, M, K], codes [Q, I, M] -> [Q, I]. The M lookups are added
    in order m = 0, 1, ..., the order of JAX's ``_adc`` on the CPU, so the
    keys equal its bits (``torch.sum`` adds in another order)."""
    idx = codes.long().transpose(1, 2)                       # [Q, M, I]
    got = torch.gather(lut, 2, idx)
    acc = got[:, 0]
    for j in range(1, got.shape[1]):
        acc = acc + got[:, j]
    return acc


def _merge_top(keys, ids, new_keys, new_ids, size: int, extra=None,
               new_extra=None):
    """Merge, dedupe by id (keeping the smallest key), keep the ``size``
    smallest keys. keys/ids [Q, A], new_* [Q, B] -> [Q, size]. Invalid
    slots: id < 0, key = +inf. ``extra`` rides along."""
    k = torch.cat([keys, new_keys], dim=1)
    i = torch.cat([ids, new_ids], dim=1)
    e = torch.cat([extra, new_extra], dim=1) if extra is not None else None
    # lexsort((k, i)): by id, then key, then position — two stable sorts
    o1 = torch.argsort(k, dim=1, stable=True)
    o2 = torch.argsort(torch.gather(i, 1, o1), dim=1, stable=True)
    order = torch.gather(o1, 1, o2)
    k = torch.gather(k, 1, order)
    i = torch.gather(i, 1, order)
    if e is not None:
        e = torch.gather(e, 1, order)
    dup = torch.zeros_like(i, dtype=torch.bool)
    dup[:, 1:] = i[:, 1:] == i[:, :-1]
    dup |= i < 0
    k = k.masked_fill(dup, _INF)
    i = i.masked_fill(dup, -1)
    order2 = torch.argsort(k, dim=1, stable=True)[:, :size]
    k = torch.gather(k, 1, order2)
    i = torch.gather(i, 1, order2)
    if e is not None:
        e = torch.gather(e.masked_fill(dup, 0), 1, order2)
        return k, i, e
    return k, i


def _bit_get(mask: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """mask [Q, NB] int32 words, ids [Q, I] (>= 0) -> [Q, I] bool."""
    ids = ids.long()
    word = torch.gather(mask, 1, ids >> 5)
    return ((word >> (ids & 31).to(torch.int32)) & 1).to(torch.bool)


def _bit_set(mask: torch.Tensor, ids: torch.Tensor,
             on: torch.Tensor) -> torch.Tensor:
    """Set bits for ids [Q] where on [Q] (ids >= 0), in place."""
    ids = ids.long()
    rows = torch.arange(mask.shape[0], device=mask.device)
    widx = ids >> 5
    bit = torch.where(on, torch.ones_like(ids) << (ids & 31),
                      torch.zeros_like(ids))
    word = mask[rows, widx].long() | bit
    # back to a signed 32-bit word (bit 31 is the sign)
    mask[rows, widx] = torch.where(word >= 2 ** 31, word - 2 ** 32,
                                   word).to(torch.int32)
    return mask


# -------------------------------------------------- navigation graph beam

def nav_entry_points(ds: DeviceSegment, queries: torch.Tensor,
                     beam: int = 8, hops: int = 12, num: int = 4,
                     metric: str = "l2") -> torch.Tensor:
    """Batched beam search on the in-memory navigation graph.
    Returns [Q, num] global entry ids."""
    qn = queries.shape[0]
    dev = queries.device
    entry = ds.nav_entry.long().reshape(1)
    d0 = _dists(queries, ds.nav_vecs[entry][None].expand(qn, 1, -1),
                metric)[:, 0]
    ids = torch.full((qn, beam), -1, dtype=torch.int32, device=dev)
    ids[:, 0] = ds.nav_entry
    keys = torch.full((qn, beam), _INF, device=dev)
    keys[:, 0] = d0
    expanded = torch.zeros((qn, beam), dtype=torch.bool, device=dev)
    rows = torch.arange(qn, device=dev)
    for _ in range(hops):
        open_key = keys.masked_fill(expanded | (ids < 0), _INF)
        pick = torch.argmin(open_key, dim=1)                 # [Q]
        has_open = torch.isfinite(open_key[rows, pick])
        u = ids[rows, pick]
        expanded[rows, pick] = expanded[rows, pick] | has_open
        nb = ds.nav_adj[u.long().clamp_min(0)]               # [Q, deg']
        valid = (nb >= 0) & has_open[:, None]
        nd = _dists(queries, ds.nav_vecs[nb.long().clamp_min(0)], metric)
        nd = nd.masked_fill(~valid, _INF)
        nb_m = nb.masked_fill(~valid, -1)
        keys, ids, ex = _merge_top(
            keys, ids, nd, nb_m, beam, extra=expanded.to(torch.int32),
            new_extra=torch.zeros(nb.shape, dtype=torch.int32, device=dev))
        expanded = ex.to(torch.bool)
    top = ids[:, :num]
    gid = ds.nav_ids[top.long().clamp_min(0)]
    return torch.where(top >= 0, gid, torch.full_like(gid, -1))


# ------------------------------------------------------ main block search

def _round_stage(ds: DeviceSegment, queries: torch.Tensor, u: torch.Tensor,
                 metric: str, impl: str, n_expand: int, tile: int,
                 pipeline_dma: bool, fuse_union: bool = False):
    """The per-round fetch pipeline: u [Q, F] picked ids (-1 = empty)
    -> (vid [Q, F*eps], nbrs [Q, F*eps, Lam], dists [Q, F*eps],
    hit [Q, F] i32, order [Q, n_expand]). ``impl='fused'`` runs the
    CUDA round kernels (their plain versions on the CPU); ``'ref'`` is
    the straight-gather oracle. ``pipeline_dma`` changes no payload
    and is accounting only on this card."""
    del pipeline_dma
    if impl == "fused":
        dd, vid, nbrs, hit, order = K.fused_round(
            queries, u, ds.block_of, ds.hot_slot_of, ds.hot_vecs,
            ds.hot_vid, ds.hot_nbrs, ds.vecs, ds.vid, ds.nbrs, n_expand,
            metric=metric, bq=tile, fuse_union=fuse_union)
    else:
        dd, vid, nbrs, hit, order = ref.fused_round_ref(
            queries, u, ds.block_of, ds.hot_slot_of, ds.hot_vecs,
            ds.hot_vid, ds.hot_nbrs, ds.vecs, ds.vid, ds.nbrs, n_expand,
            metric=metric)
    return vid, nbrs, dd, hit, order


def _open_keys(cand_id: torch.Tensor, cand_key: torch.Tensor,
               visited: torch.Tensor) -> torch.Tensor:
    """Candidate keys with visited/invalid entries masked to +inf; a
    query is active iff any entry is finite."""
    vis = _bit_get(visited, cand_id.clamp_min(0)) | (cand_id < 0)
    return cand_key.masked_fill(vis, _INF)


def _dedup_joins(b: torch.Tensor, cold: torch.Tensor, tile: int):
    """Cold requests that join an earlier request's gather, batch-wide
    (``joined``) and the subset whose paying request sits in another
    query tile (``joined_x``). b, cold [Q, F] -> two [Q, F] bool."""
    qn, fw = b.shape
    pad = (-qn) % tile
    bp = torch.nn.functional.pad(b, (0, 0, 0, pad))
    cp = torch.nn.functional.pad(cold, (0, 0, 0, pad))
    t = bp.shape[0] // tile
    r = tile * fw
    # non-cold slots get unique negative sentinels: they never join
    flat = torch.where(cp.reshape(-1), bp.reshape(-1).to(torch.int32),
                       -1 - torch.arange(t * r, dtype=torch.int32,
                                         device=b.device))
    intra = dedup.join_mask(flat.reshape(t, r)).reshape(-1)
    batch = dedup.join_mask(flat.reshape(1, t * r)).reshape(-1)
    cross = batch & ~intra
    return (batch[: qn * fw].reshape(qn, fw),
            cross[: qn * fw].reshape(qn, fw))


def _i32sum(x: torch.Tensor, dim=None) -> torch.Tensor:
    return (x.sum() if dim is None else x.sum(dim=dim)).to(torch.int32)


def expansions(eps: int, fw: int, sigma: float) -> int:
    """Slots expanded per round: each target plus the σ-pruned share of
    the other ε-1 residents of its block."""
    return fw * (1 + max(int(math.ceil((eps - 1) * sigma)), 0))


def pick_candidates(cand_id: torch.Tensor, open_key: torch.Tensor,
                    fw: int):
    """The ``fw`` best open candidates per query -> (u [Q, F] ids, -1
    where a query has no open candidate left; f_active [Q, F] bool).
    A stable sort, so ties go to the lower index as in ``lax.top_k``."""
    top_key, picks = torch.sort(open_key, dim=1, stable=True)
    f_active = torch.isfinite(top_key[:, :fw])
    u = torch.gather(cand_id, 1, picks[:, :fw]).masked_fill(~f_active, -1)
    return u, f_active


def _block_search_loop(ds: DeviceSegment, queries: torch.Tensor, lut,
                       state, *, res_size: int, candidates: int,
                       sigma: float, max_hops: int, metric: str,
                       fetch_width: int, fetch_impl: str,
                       compact_frac: float = 0.0, trace: bool = False,
                       pipeline_dma: bool = False, round_tile_cap: int = 0,
                       speculate: bool = False, fuse_union: bool = False):
    """The batched best-first block search from a carried state.

    ``state`` = dict with cand_id, cand_key, open_key, visited, res_id,
    res_key, io, t0, hops, saved, saved_x (per query) and t. Returns
    ``(state, round_log)``; see ``repro.core.device_search.
    _block_search_loop`` for the meaning of every knob. The round log
    is None when ``trace`` is off; results and counters are the same
    for every setting of ``compact_frac``, ``trace``, ``speculate``,
    ``pipeline_dma`` and ``fuse_union``."""
    qn = queries.shape[0]
    dev = queries.device
    eps = ds.vid.shape[1]
    fw = max(fetch_width, 1)
    n_expand = expansions(eps, fw, sigma)
    tile = K.round_tile(qn, round_tile_cap)
    compact = compact_frac > 0.0
    st = dict(state)
    per_query = ["cand_id", "cand_key", "open_key", "visited", "res_id",
                 "res_key", "io", "t0", "hops", "saved", "saved_x"]
    if speculate:
        st["spec_h"] = torch.zeros(qn, dtype=torch.int32, device=dev)
        st["spec_w"] = torch.zeros(qn, dtype=torch.int32, device=dev)
        st["spec_blk"] = torch.full((qn, fw), -1, dtype=torch.int32,
                                    device=dev)
        per_query += ["spec_h", "spec_w", "spec_blk"]
    if compact:
        st["perm"] = torch.arange(qn, dtype=torch.int32, device=dev)
        st["q_r"], st["lut_r"] = queries, lut
        per_query += ["perm", "q_r", "lut_r"]
    rlog = (torch.zeros((max_hops, len(_ROUND_LOG_COLS)), dtype=torch.int32,
                        device=dev) if trace else None)
    ar_fw = torch.arange(fw, device=dev)

    while st["t"] < max_hops and bool(torch.isfinite(st["open_key"]).any()):
        t = st["t"]
        # --- active mask + optional live-query compaction
        live = torch.isfinite(st["open_key"]).any(dim=1)     # [Q]
        fired = False
        if compact:
            frac = float(live.to(torch.float32).mean())
            unpacked = (qn > 1
                        and bool((~live[:-1] & live[1:]).any()))
            fired = frac < compact_frac and unpacked
            if fired:
                # stable: live first, original order within each group
                ordr = torch.argsort((~live).to(torch.int8), stable=True)
                for name in per_query:
                    st[name] = st[name][ordr]
            q_r, lut_r = st["q_r"], st["lut_r"]
        else:
            q_r, lut_r = queries, lut
        cand_id, open_key = st["cand_id"], st["open_key"]
        visited = st["visited"]

        # --- pick the F best open candidates per query
        u, f_active = pick_candidates(cand_id, open_key, fw)
        active = f_active[:, 0]
        b = ds.block_of[u.long().clamp_min(0)]               # [Q, F]

        # --- round stage: tier-0 probe, batch union + gather, rank
        vid, nbrs, dd, hit, order = _round_stage(
            ds, q_r, u, metric, fetch_impl, n_expand, tile, pipeline_dma,
            fuse_union)
        hot = hit.to(torch.bool) & f_active
        cold = f_active & ~hot
        joined, joined_x = _dedup_joins(b, cold, tile)       # [Q, F]
        st["io"] = st["io"] + _i32sum(cold, 1)
        st["t0"] = st["t0"] + _i32sum(hot, 1)
        st["saved"] = st["saved"] + _i32sum(joined, 1)
        st["saved_x"] = st["saved_x"] + _i32sum(joined_x, 1)
        st["hops"] = st["hops"] + active.to(torch.int32)

        if speculate:
            # consume the prediction the previous round staged
            spec_blk = st["spec_blk"]
            pred_match = (b[:, :, None] == spec_blk[:, None, :]).any(-1)
            hit_spec = cold & ~joined & pred_match
            cold_b = torch.where(cold, b, torch.full_like(b, -1))
            used = ((spec_blk[:, :, None] == cold_b[:, None, :]).any(-1)
                    & (spec_blk >= 0))
            sh_r = _i32sum(hit_spec, 1)
            sw_r = _i32sum((spec_blk >= 0) & ~used, 1)
            st["spec_h"] = st["spec_h"] + sh_r
            st["spec_w"] = st["spec_w"] + sw_r

        if trace:
            zero = torch.zeros((), dtype=torch.int32, device=dev)
            spec_cols = ((_i32sum(sh_r), _i32sum(sw_r)) if speculate
                         else (zero, zero))
            rlog[t] = torch.stack([
                _i32sum(active), _i32sum(cold), _i32sum(hot),
                _i32sum(joined), _i32sum(joined_x),
                torch.tensor(int(fired), dtype=torch.int32, device=dev),
                *spec_cols])

        # --- fold the exact-ranked residents into the results
        f_valid = torch.repeat_interleave(f_active, eps, dim=1)
        slot_valid = (vid >= 0) & f_valid
        dd_m = dd.masked_fill(~slot_valid, _INF)
        st["res_key"], st["res_id"] = _merge_top(
            st["res_key"], st["res_id"], dd_m,
            vid.masked_fill(~slot_valid, -1), res_size)

        # --- block pruning: targets + top-((eps-1)*sigma), in the
        # expansion order the round stage ranked
        is_target = (vid[:, :, None] == u[:, None, :]).any(-1) & (vid >= 0)
        sel_key = dd_m.masked_fill(is_target, -_INF)
        order_l = order.long()
        ex_id = torch.gather(vid, 1, order_l)
        ex_valid = ((torch.gather(sel_key, 1, order_l) < _INF)
                    & active[:, None] & (ex_id >= 0))
        ex_new = ex_valid & ~_bit_get(visited, ex_id.clamp_min(0))
        for j in range(n_expand):                            # mark expanded
            _bit_set(visited, ex_id[:, j].clamp_min(0), ex_new[:, j])

        # --- collect neighbours of expanded slots, route by PQ
        ex_nbrs = torch.gather(
            nbrs, 1, order_l[:, :, None].expand(-1, -1, nbrs.shape[2]))
        flat = ex_nbrs.reshape(qn, -1)
        f_ok = ((flat >= 0)
                & torch.repeat_interleave(ex_new, ex_nbrs.shape[2], dim=1)
                & active[:, None])
        f_safe = flat.clamp_min(0)
        f_ok &= ~_bit_get(visited, f_safe)                   # skip expanded
        f_codes = ds.pq_codes[f_safe.long()]                 # [Q, X, M]
        f_key = _adc(lut_r, f_codes).masked_fill(~f_ok, _INF)
        f_id = flat.masked_fill(~f_ok, -1)
        if speculate:
            # stage the next round's prediction from the neighbours this
            # round just routed (hot-pack blocks and duplicates dropped)
            p_key, p_pick = torch.sort(f_key, dim=1, stable=True)
            p_key, p_pick = p_key[:, :fw], p_pick[:, :fw]
            p_id = torch.gather(f_id, 1, p_pick)
            p_ok = torch.isfinite(p_key) & (p_id >= 0) & active[:, None]
            p_blk = torch.where(p_ok, ds.block_of[p_id.long().clamp_min(0)],
                                torch.full_like(p_id, -1))
            p_hot = ds.hot_slot_of[p_blk.long().clamp_min(0)] >= 0
            p_blk = p_blk.masked_fill(p_hot & (p_blk >= 0), -1)
            dup = ((p_blk[:, :, None] == p_blk[:, None, :])
                   & (ar_fw[None, :, None] > ar_fw[None, None, :])).any(-1)
            st["spec_blk"] = p_blk.masked_fill(dup & (p_blk >= 0),
                                               -1).to(torch.int32)

        st["cand_key"], st["cand_id"] = _merge_top(
            st["cand_key"], cand_id, f_key, f_id, candidates)
        st["open_key"] = _open_keys(st["cand_id"], st["cand_key"], visited)
        st["t"] = t + 1

    if compact:
        inv = torch.argsort(st["perm"].long())   # undo the compaction
        for name in per_query:
            st[name] = st[name][inv]
    return st, rlog


DEFAULT_DEVICE_SEARCH = DeviceSearchParams()


def initial_state(ds: DeviceSegment, queries: torch.Tensor,
                  p: DeviceSearchParams, metric: str = "l2",
                  seeds: Optional[torch.Tensor] = None):
    """The PQ lookup tables and the loop state before the first round:
    candidates seeded from the navigation-graph entries (or ``seeds``)
    by PQ-ADC, nothing visited, empty results, zero counters.
    Returns ``(queries f32, lut [Q, M, K], state)``."""
    qn = queries.shape[0]
    dev = ds.device
    if queries.device != dev:
        raise ValueError(f"queries on {queries.device}, segment on {dev}")
    eps = ds.vid.shape[1]
    nb_words = -(-ds.block_of.shape[0] // 32)
    res_size = p.k + 2 * eps * max(p.fetch_width, 1)
    queries = queries.to(torch.float32).contiguous()

    lut = _adc_lut(queries, ds.pq_cent, metric)              # [Q, M, K]
    if seeds is not None:
        entry = seeds.to(device=dev, dtype=torch.int32)
    else:
        entry = nav_entry_points(ds, queries, beam=p.nav_beam,
                                 hops=p.nav_hops, num=p.entry_points,
                                 metric=metric)
    e_codes = ds.pq_codes[entry.long().clamp_min(0)]
    e_key = _adc(lut, e_codes).masked_fill(entry < 0, _INF)

    cand_id = torch.full((qn, p.candidates), -1, dtype=torch.int32,
                         device=dev)
    cand_key = torch.full((qn, p.candidates), _INF, device=dev)
    cand_key, cand_id = _merge_top(cand_key, cand_id, e_key, entry,
                                   p.candidates)
    visited = torch.zeros((qn, nb_words), dtype=torch.int32, device=dev)

    def zeros():
        return torch.zeros(qn, dtype=torch.int32, device=dev)

    state = {"cand_id": cand_id, "cand_key": cand_key,
             "open_key": _open_keys(cand_id, cand_key, visited),
             "visited": visited,
             "res_id": torch.full((qn, res_size), -1, dtype=torch.int32,
                                  device=dev),
             "res_key": torch.full((qn, res_size), _INF, device=dev),
             "io": zeros(), "t0": zeros(), "hops": zeros(),
             "saved": zeros(), "saved_x": zeros(), "t": 0}
    return queries, lut, state


def device_anns(ds: DeviceSegment, queries: torch.Tensor,
                p: DeviceSearchParams = DEFAULT_DEVICE_SEARCH,
                metric: str = "l2",
                seeds: Optional[torch.Tensor] = None) -> DeviceSearchResult:
    """Batched Starling ANNS on one segment.

    ``seeds`` [Q, S] int32 (-1 padded) replaces the navigation-graph
    entry pick (the hybrid path hands its exit frontier here).
    ``queries`` must lie on the segment's device. Returns per-query
    ids/dists [Q, k] and counters (see ``DeviceSearchResult``)."""
    queries, lut, state = initial_state(ds, queries, p, metric, seeds)
    res_size = state["res_id"].shape[1]
    fw = max(p.fetch_width, 1)
    st, rlog = _block_search_loop(
        ds, queries, lut, state, res_size=res_size,
        candidates=p.candidates, sigma=p.sigma, max_hops=p.max_hops,
        metric=metric, fetch_width=fw, fetch_impl=p.fetch_impl,
        compact_frac=p.compact_frac, trace=p.trace_rounds,
        pipeline_dma=p.pipeline_dma, round_tile_cap=p.round_tile_cap,
        speculate=p.speculate, fuse_union=p.fuse_union)
    zeros = torch.zeros_like(st["io"])
    spec_h = st["spec_h"] if p.speculate else zeros
    spec_w = st["spec_w"] if p.speculate else zeros
    return DeviceSearchResult(st["res_id"][:, : p.k], st["res_key"][:, : p.k],
                              st["io"], st["hops"], st["t0"], st["saved"],
                              st["saved_x"], spec_h, spec_w, st["t"], rlog)


# ---------------------------------------------------------- range search

def device_range_search(ds: DeviceSegment, queries: torch.Tensor,
                        radius: float, k_cap: int = 256,
                        p: DeviceSearchParams = DEFAULT_DEVICE_SEARCH,
                        metric: str = "l2",
                        rounds: int = 3) -> DeviceRangeResult:
    """Batched range search (§5.3, the device formulation): ANNS rounds
    with a candidate set Γ that doubles while ``2Γ <= k_cap``, at most
    ``rounds`` of them. (The JAX signature's ``ratio``, which it leaves
    to the serving layer and never reads, is not ported.)

    The ``visited`` bitmask, the results and the counters thread through
    the rounds: a later round re-seeds its candidates from the previous
    round's results but never re-expands a vertex an earlier round
    expanded, so never re-fetches or re-counts its block. With
    ``p.speculate`` the staged prediction drains at each re-entry while
    the hit and waste counters add up. ``in_range`` is ``dists <=
    radius``."""
    qn = queries.shape[0]
    dev = ds.device
    if queries.device != dev:
        raise ValueError(f"queries on {queries.device}, segment on {dev}")
    eps = ds.vid.shape[1]
    nb_words = -(-ds.block_of.shape[0] // 32)
    fw = max(p.fetch_width, 1)
    queries = queries.to(torch.float32).contiguous()
    lut = _adc_lut(queries, ds.pq_cent, metric)
    entry = nav_entry_points(ds, queries, beam=p.nav_beam, hops=p.nav_hops,
                             num=p.entry_points, metric=metric)
    e_key = _adc(lut, ds.pq_codes[entry.long().clamp_min(0)]).masked_fill(
        entry < 0, _INF)

    def zeros():
        return torch.zeros(qn, dtype=torch.int32, device=dev)

    visited = torch.zeros((qn, nb_words), dtype=torch.int32, device=dev)
    res_id = torch.zeros((qn, 0), dtype=torch.int32, device=dev)
    res_key = torch.zeros((qn, 0), dtype=torch.float32, device=dev)
    io, t0, hops, saved, saved_x = zeros(), zeros(), zeros(), zeros(), zeros()
    spec_h, spec_w = zeros(), zeros()
    total_rounds = 0
    seed_id, seed_key = entry, e_key
    c = p.candidates
    for _ in range(rounds):
        res_size = min(k_cap, c) + 2 * eps * fw
        cand_key, cand_id = _merge_top(
            torch.full((qn, c), _INF, device=dev),
            torch.full((qn, c), -1, dtype=torch.int32, device=dev),
            seed_key, seed_id, c)
        r_id = torch.full((qn, res_size), -1, dtype=torch.int32, device=dev)
        r_key = torch.full((qn, res_size), _INF, device=dev)
        if res_id.shape[1]:
            r_key, r_id = _merge_top(r_key, r_id, res_key, res_id, res_size)
        state = {"cand_id": cand_id, "cand_key": cand_key,
                 "open_key": _open_keys(cand_id, cand_key, visited),
                 "visited": visited, "res_id": r_id, "res_key": r_key,
                 "io": io, "t0": t0, "hops": hops, "saved": saved,
                 "saved_x": saved_x, "t": 0}
        # the round log stays off: the loop re-enters each round
        st, _ = _block_search_loop(
            ds, queries, lut, state, res_size=res_size, candidates=c,
            sigma=p.sigma, max_hops=p.max_hops, metric=metric,
            fetch_width=fw, fetch_impl=p.fetch_impl,
            compact_frac=p.compact_frac, trace=False,
            pipeline_dma=p.pipeline_dma, round_tile_cap=p.round_tile_cap,
            speculate=p.speculate, fuse_union=p.fuse_union)
        visited, res_id, res_key = st["visited"], st["res_id"], st["res_key"]
        io, t0, hops = st["io"], st["t0"], st["hops"]
        saved, saved_x = st["saved"], st["saved_x"]
        if p.speculate:
            spec_h = spec_h + st["spec_h"]
            spec_w = spec_w + st["spec_w"]
        total_rounds += st["t"]
        if c * 2 > k_cap:
            break
        c *= 2
        # the next round resumes from this round's frontier: results that
        # were ranked but never expanded are open under ``visited``
        seed_id, seed_key = res_id, res_key

    ids, dists = res_id[:, :k_cap], res_key[:, :k_cap]
    pad = k_cap - ids.shape[1]
    if pad > 0:
        ids = torch.nn.functional.pad(ids, (0, pad), value=-1)
        dists = torch.nn.functional.pad(dists, (0, pad), value=_INF)
    return DeviceRangeResult(ids, dists, dists <= radius, io, t0, saved,
                             saved_x, spec_h, spec_w, total_rounds)


# ------------------------------------------------------ mesh merge, stack

def merge_shard_topk(gids: torch.Tensor, gd: torch.Tensor,
                     k: int) -> tuple:
    """Merge stacked per-shard results: ``gids``/``gd`` [S, Q, kk]
    (global ids, -1 = invalid; dists, inf on invalid) -> ([Q, k],
    [Q, k]) global top-k.

    Ordering is (dist, global id) with invalid ids keyed past every
    real id, the same total order ``serving.coordinator.merge_topk``
    sorts by, so a merged fan-out and a host-merged concat over the same
    shards are bit-identical whatever the shard order or placement. A
    stable sort by id, then a stable sort by distance, is JAX's
    ``jnp.lexsort((key_id, flat_d))``."""
    s, q, kk = gids.shape
    flat_i = gids.movedim(0, 1).reshape(q, s * kk)
    flat_d = gd.movedim(0, 1).reshape(q, s * kk)
    valid = flat_i >= 0
    flat_d = torch.where(valid, flat_d, torch.full_like(flat_d, _INF))
    key_id = torch.where(valid, flat_i, torch.full_like(
        flat_i, torch.iinfo(flat_i.dtype).max))
    by_id = torch.sort(key_id, dim=1, stable=True).indices
    by_d = torch.sort(torch.gather(flat_d, 1, by_id), dim=1,
                      stable=True).indices
    order = torch.gather(by_id, 1, by_d)[:, :k]
    return (torch.gather(flat_i, 1, order),
            torch.gather(flat_d, 1, order))


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def check_stackable(segments) -> None:
    """Raise ``ValueError`` unless every shard agrees with shard 0 on
    every array's shape and dtype (``stack_segments``' check)."""
    if not segments:
        raise ValueError("stack_segments needs at least one shard")
    first = segments[0]
    for idx, seg in enumerate(segments[1:], 1):
        for f in dataclasses.fields(DeviceSegment):
            a, b = getattr(first, f.name), getattr(seg, f.name)
            if a.shape != b.shape or a.dtype != b.dtype:
                raise ValueError(
                    f"segment shard {idx} field {f.name!r} is "
                    f"{tuple(b.shape)}/{_dtype_name(b.dtype)}, shard 0 "
                    f"has {tuple(a.shape)}/{_dtype_name(a.dtype)} — mesh "
                    "shards must be shape-identical (pad segments to a "
                    "common size)")


def stack_segments(segments) -> DeviceSegment:
    """Stack same-shape segment shards along a new leading axis: the
    [W, ...] tree of one shard per rank (replicas are repeated entries).
    All shards must agree on every array's shape and dtype. The one-card
    router keeps references to its members' segments instead of a
    stacked copy (replicas share memory); this is the stacked form."""
    check_stackable(segments)
    return DeviceSegment(**{
        f.name: torch.stack([getattr(s, f.name) for s in segments])
        for f in dataclasses.fields(DeviceSegment)})


# ------------------------------------------------- the multi-rank step

def make_search_step(mesh, rules, *,
                     n_local: int = 1 << 21, dim: int = 128,
                     eps: int = 16, lam: int = 31, q_global: int = 4096,
                     pq_m: int = 16, pq_k: int = 256,
                     nav_frac: int = 64, nav_deg: int = 12,
                     search: Optional[DeviceSearchParams] = None):
    """Build ``(fn, (seg_specs, q_specs))``: the segment search over the
    ranks of ``mesh`` (a ``torch.distributed`` ``DeviceMesh`` with a
    ``model`` axis) and the specs of its arguments.

    Layout: every ``model`` rank owns an independent sub-segment of
    ``n_local`` vectors (16 ranks x 2M = 33M vectors per pod row, the
    paper's segment scale); queries are split over the other axes
    (``data``, and ``pod``) and replicated over ``model``. ``rules`` is
    taken for JAX's signature and not read.

    ``fn(seg_local, q_local)`` is what JAX's ``local_search`` is under
    ``shard_map``: every rank calls it with its own ``[1, ...]`` shard
    of a ``stack_segments`` tree and its own rows of the batch, on the
    mesh's device. It searches its segment with ``device_anns``,
    all-gathers the k results over the ``model`` group (global id =
    ``model`` coordinate x ``n_local`` + local id) and merges them in
    the shared (dist, global id) order (``merge_shard_topk``). It
    returns (gid, dists, io, hops, tier0_hits, dedup_saved,
    dedup_cross, spec_hits, spec_wasted): the merged [Q_local, k] and
    each rank's [Q_local, 1] columns. The specs size the production
    arguments (``vecs`` and ``hot_vecs`` in bf16; ``search``'s tier-0
    budget sizes the hot pack) without allocating them; ``fn`` casts
    both to f32."""
    from repro_torch.distributed.sharding import (PartitionSpec, arg_spec,
                                                  axis_names, axis_sizes)

    if search is None:
        search = DeviceSearchParams(candidates=64, max_hops=128)
    sizes = axis_sizes(mesh)
    model_n = sizes["model"]
    data_axes = tuple(a for a in axis_names(mesh) if a != "model")
    rho = n_local // eps
    hot_n = max(int(search.tier0_frac * rho), 1)
    nav_n = n_local // nav_frac
    dsub = dim // pq_m

    def sds(shape, dtype, spec):
        return arg_spec(shape, dtype, spec, mesh)

    seg_spec = PartitionSpec("model")
    i32 = torch.int32
    seg_specs = DeviceSegment(
        vecs=sds((model_n, rho, eps, dim), torch.bfloat16, seg_spec),
        vid=sds((model_n, rho, eps), i32, seg_spec),
        deg=sds((model_n, rho, eps), i32, seg_spec),
        nbrs=sds((model_n, rho, eps, lam), i32, seg_spec),
        block_of=sds((model_n, n_local), i32, seg_spec),
        pq_codes=sds((model_n, n_local, pq_m), torch.uint8, seg_spec),
        pq_cent=sds((model_n, pq_m, pq_k, dsub), torch.float32, seg_spec),
        nav_vecs=sds((model_n, nav_n, dim), torch.float32, seg_spec),
        nav_adj=sds((model_n, nav_n, nav_deg), i32, seg_spec),
        nav_ids=sds((model_n, nav_n), i32, seg_spec),
        nav_entry=sds((model_n,), i32, seg_spec),
        hot_vecs=sds((model_n, hot_n, eps, dim), torch.bfloat16, seg_spec),
        hot_vid=sds((model_n, hot_n, eps), i32, seg_spec),
        hot_nbrs=sds((model_n, hot_n, eps, lam), i32, seg_spec),
        hot_slot_of=sds((model_n, rho), i32, seg_spec),
    )
    q_specs = sds((q_global, dim), torch.float32, PartitionSpec(data_axes))

    def fn(seg: DeviceSegment, queries: torch.Tensor):
        import torch.distributed as dist
        if seg.vecs.device.type != mesh.device_type:
            raise ValueError(f"segment shard on {seg.vecs.device}, mesh on "
                             f"{mesh.device_type}")
        seg = DeviceSegment(**{f.name: getattr(seg, f.name)[0]
                               for f in dataclasses.fields(DeviceSegment)})
        seg = dataclasses.replace(
            seg, vecs=seg.vecs.to(torch.float32),
            hot_vecs=seg.hot_vecs.to(torch.float32))
        r = device_anns(seg, queries, search)
        # hierarchical top-k merge over segment ranks: all-gather k
        # results per rank (O(k) bytes cross-rank, not O(Gamma)), merged
        # in the shared (dist, global id) order, so the result is
        # placement-invariant and bit-identical to the host
        # ``serving.merge_topk`` concat over the same shards
        group = mesh.get_group("model")
        s = dist.get_world_size(group)
        base = mesh.get_local_rank("model") * n_local
        glob = torch.where(r.ids >= 0, r.ids + base,
                           torch.full_like(r.ids, -1)).contiguous()
        gids = [torch.empty_like(glob) for _ in range(s)]
        gd = [torch.empty_like(r.dists) for _ in range(s)]
        dist.all_gather(gids, glob, group=group)
        dist.all_gather(gd, r.dists.contiguous(), group=group)
        gid, out_d = merge_shard_topk(torch.stack(gids), torch.stack(gd),
                                      glob.shape[1])
        return (gid, out_d) + tuple(
            c[:, None] for c in (r.io, r.hops, r.tier0_hits,
                                 r.dedup_saved, r.dedup_cross,
                                 r.spec_hits, r.spec_wasted))

    return fn, (seg_specs, q_specs)
