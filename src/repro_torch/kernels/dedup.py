"""Sorted-unique block-dedup primitives (torch copy of
``repro.kernels.dedup``).

The round kernel's batch union (``kernels.tier0_fetch``) and the search
loop's accounting mirror (``core.device_search._dedup_joins``) must
group duplicate block requests identically; both go through this
module. Outputs are exactly equal to the JAX functions: every sort is
stable, so among slots sharing a key the earliest flat-order slot
defines the group.
"""
from __future__ import annotations

import torch


def sorted_unique_ranks(flat: torch.Tensor):
    """Sorted-unique union of ``flat`` [R] int keys, plus the slot map.

    Returns ``(uniq [R], rank [R] i32)``: ``uniq[j]`` is the j-th
    distinct key in ascending order, with 0 placeholders past the
    distinct count; ``rank[i]`` maps slot ``i`` to its key's unique
    rank, so ``uniq[rank[i]] == flat[i]``."""
    r = flat.shape[0]
    sb, sort_idx = torch.sort(flat, stable=True)
    first = torch.ones(r, dtype=torch.bool, device=flat.device)
    first[1:] = sb[1:] != sb[:-1]
    rank = torch.cumsum(first, 0) - 1             # sorted pos -> rank
    # duplicates write equal values, so the scatter is deterministic
    uniq = torch.zeros(r, dtype=flat.dtype, device=flat.device)
    uniq[rank] = sb
    req_rank = torch.empty(r, dtype=torch.int32, device=flat.device)
    req_rank[sort_idx] = rank.to(torch.int32)
    return uniq, req_rank


def union_slot_map(flat: torch.Tensor):
    """The sort-free O(R^2) twin of :func:`sorted_unique_ranks`
    (``repro.kernels.dedup.union_slot_map``), equal to it for
    non-negative keys. Kept for the equality tests; the CUDA union
    kernel sorts instead."""
    r = flat.shape[0]
    ar = torch.arange(r, device=flat.device)
    ii, jj = ar[:, None], ar[None, :]
    eq = flat[:, None] == flat[None, :]           # eq[i, j]
    first = ~torch.any(eq & (ii < jj), dim=0)     # no earlier equal
    smaller = flat[:, None] < flat[None, :]       # flat[i] < flat[j]
    rank = torch.sum((first[:, None] & smaller).to(torch.int32), dim=0)
    sel = first[None, :] & (rank[None, :] == ii)  # sel[r, j]
    uniq = torch.sum(torch.where(sel, flat[None, :],
                                 torch.zeros_like(flat[None, :])),
                     dim=1).to(flat.dtype)
    return uniq, rank.to(torch.int32)


def join_mask(keys: torch.Tensor) -> torch.Tensor:
    """keys [T, R] int -> joined [T, R] bool: True where an earlier
    (flat-order) slot of the same row carries the same key. Rows are
    independent dedup scopes; slots that must never join carry unique
    negative sentinel keys."""
    t, r = keys.shape
    sk, order = torch.sort(keys, dim=1, stable=True)
    dup = torch.zeros((t, r), dtype=torch.bool, device=keys.device)
    dup[:, 1:] = sk[:, 1:] == sk[:, :-1]
    out = torch.zeros((t, r), dtype=torch.bool, device=keys.device)
    return out.scatter_(1, order, dup)
