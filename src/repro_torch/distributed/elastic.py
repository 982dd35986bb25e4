"""Elastic re-mesh and segment-placement planning (port of ``repro.
distributed.elastic``, pure Python).

Re-mesh (``plan_remesh``): map surviving node counts to a new mesh.
Policy: the ``model`` (TP) degree is pinned (weights are laid out for
it); elasticity comes from shrinking the ``data`` axis to the largest
power of two supported by the survivors, rescaling per-device batch to
keep the global batch constant, and raising grad-accum when the
per-device batch would not divide. Restart = restore latest checkpoint
with the new mesh (checkpoints are mesh-agnostic npz trees).

Placement (``plan_placement`` / ``plan_rebalance``): the serving-plane
analogue — assign segment replicas to mesh ranks in proportion to
observed per-segment load, so the ``MeshQueryRouter`` can move
segments between ranks when the windowed per-rank ``IOStats`` fold
shows sustained skew (DESIGN.md §7). Planning is deterministic and
move-minimizing: ranks whose segment keeps quota under the new
proportions stay put, so a settled load re-plans to the identical
placement (zero moves — the rebalance-idempotence invariant)."""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class RemeshPlan:
    data: int
    model: int
    pods: int
    per_device_batch: int
    grad_accum: int
    dropped_chips: int

    @property
    def chips(self) -> int:
        return self.pods * self.data * self.model


def plan_remesh(surviving_chips: int, model: int, global_batch: int,
                pods: int = 1, min_data: int = 1,
                base_grad_accum: int = 1) -> Optional[RemeshPlan]:
    """Largest (pod, data, model) mesh fitting the survivors; None if
    even the minimum mesh does not fit."""
    if surviving_chips < model * min_data * pods:
        if pods > 1:
            return plan_remesh(surviving_chips, model, global_batch,
                               pods=pods - 1, min_data=min_data,
                               base_grad_accum=base_grad_accum)
        return None
    data = 1
    while data * 2 * model * pods <= surviving_chips:
        data *= 2
    chips = data * model * pods
    dp_ways = data * pods
    accum = base_grad_accum
    while global_batch % (dp_ways * accum) and accum < global_batch:
        accum += 1
    per_dev = max(global_batch // (dp_ways * accum), 1)
    return RemeshPlan(data=data, model=model, pods=pods,
                      per_device_batch=per_dev, grad_accum=accum,
                      dropped_chips=surviving_chips - chips)


# --------------------------------------------- serving segment placement

@dataclasses.dataclass(frozen=True)
class PlacementPlan:
    """A rank -> segment assignment plus the evidence it was planned
    from (returned by ``plan_rebalance``)."""
    placement: Tuple[int, ...]    # placement[rank] = segment index
    moves: Tuple[Tuple[int, int, int], ...]  # (rank, old_seg, new_seg)
    skew: float                   # max/mean rank load the plan saw
    seg_loads: Tuple[float, ...]  # per-segment load the quotas priced

    @property
    def fired(self) -> bool:
        return len(self.moves) > 0


def plan_placement(seg_loads: Sequence[float], ranks: int,
                   current: Optional[Sequence[int]] = None
                   ) -> List[int]:
    """Replica counts proportional to per-segment load, every segment
    on >= 1 rank (largest-remainder apportionment), materialized as a
    rank -> segment list.

    ``current`` makes the plan move-minimizing: every rank whose
    current segment still has quota under the new proportions keeps
    it; only surplus ranks are reassigned (in rank order, to the
    lowest-index segment short of quota). Deterministic, so planning
    twice from the same loads yields the identical placement — the
    idempotence the router's settled-stream invariant rests on."""
    s = len(seg_loads)
    if s == 0:
        raise ValueError("plan_placement needs at least one segment")
    if ranks < s:
        raise ValueError(
            f"{ranks} ranks cannot hold {s} segments at >= 1 replica "
            "each — shrink the segment set or grow the mesh")
    loads = [max(float(x), 0.0) for x in seg_loads]
    total = sum(loads)
    if total <= 0.0:
        loads = [1.0] * s                  # no signal: uniform replicas
        total = float(s)
    # every segment gets 1 guaranteed rank; the remaining ranks go by
    # largest remainder of the load-proportional quota
    extra = ranks - s
    quota = [ld / total * extra for ld in loads]
    counts = [1 + int(q) for q in quota]
    rem = sorted(range(s), key=lambda i: (-(quota[i] - int(quota[i])), i))
    short = ranks - sum(counts)
    for i in rem[:short]:
        counts[i] += 1
    if current is None:
        out: List[int] = []
        for i, c in enumerate(counts):
            out.extend([i] * c)
        return out
    # move-minimizing: keep ranks whose segment still has quota
    left = list(counts)
    keep = [-1] * ranks
    for r, seg in enumerate(current):
        if 0 <= seg < s and left[seg] > 0:
            keep[r] = seg
            left[seg] -= 1
    fill = [i for i, c in enumerate(left) for _ in range(c)]
    out = []
    j = 0
    for r in range(ranks):
        if keep[r] >= 0:
            out.append(keep[r])
        else:
            out.append(fill[j])
            j += 1
    return out


def plan_rebalance(current: Sequence[int], seg_loads: Sequence[float],
                   rank_loads: Sequence[float],
                   skew_threshold: float = 1.5) -> PlacementPlan:
    """One rebalance evaluation: re-plan placement from the windowed
    per-segment loads, gated on observed rank-load skew.

    Fires (non-empty ``moves``) only when max/mean ``rank_loads``
    reaches ``skew_threshold`` AND the move-minimizing re-plan differs
    from ``current`` — a balanced or already-proportional mesh plans
    zero moves, so applying the plan is idempotent."""
    ranks = len(current)
    active = [max(float(x), 0.0) for x in rank_loads]
    mean = sum(active) / max(len(active), 1)
    skew = (max(active) / mean) if mean > 0 else 0.0
    if skew < skew_threshold:
        return PlacementPlan(placement=tuple(current), moves=(),
                             skew=skew, seg_loads=tuple(seg_loads))
    new = plan_placement(seg_loads, ranks, current=current)
    moves = tuple((r, int(current[r]), int(new[r]))
                  for r in range(ranks) if new[r] != current[r])
    return PlacementPlan(placement=tuple(new), moves=moves, skew=skew,
                         seg_loads=tuple(seg_loads))
