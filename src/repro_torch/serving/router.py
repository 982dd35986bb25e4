"""Mesh serving on one card: the fan-out router (port of ``repro.
serving.router``).

``MeshQueryRouter`` turns a set of single-segment device servers into
ONE ``SegmentTarget``: a query batch fans out over the ranks of a
layout (``launch.mesh.make_debug_mesh``: one segment per rank on the
``model`` axis, the Fig. 1(b) segments <-> ranks layout), each rank runs
the batched block search on its segment, and the per-rank top-k merge
through ``core.device_search.merge_shard_topk``: the same (dist, global
id) total order the host ``merge_topk`` sorts by, so a routed batch is
bit-identical to the concatenated single-target path over the same
segments.

On one card the JAX step (``shard_map`` + ``all_gather``) is a loop over
the W ranks: each rank takes ``device_anns`` of its segment over the
whole batch, masks the rows it does not own to the -1/inf sentinels,
and the masked results are stacked and merged. Replicas of a segment
search the same batch on the same ``DeviceSegment`` and would compute
the same result, so the search runs once per distinct segment and each
replica masks that one result: the ids, dists and per-rank folds of a
search per rank, with one search a segment. A rank holds a reference
to its member's ``DeviceSegment``, not a stacked copy, so replicas share
memory and a restack re-indexes references (``stack_segments`` is the
stacked form; the router still enforces its shape check, and that every
member lies on one device).

Replica groups: with more ranks than segments, hot segments get extra
replicas (``distributed.elastic.plan_placement``: load-proportional,
largest remainder, every segment >= 1 rank). Each replica group
partitions the batch into contiguous slices sized inversely to the
windowed per-rank load, so a lagging replica is handed fewer rows next
batch. Every (query, segment) pair is owned by exactly one rank, which
keeps accounting exact and the merge bit-identical: a replica runs the
same batched search its siblings run, so its owned rows equal the
single-target rows however the slices are drawn.

Elastic rebalance: the router keeps a sliding window of per-rank
``IOStats`` folds (``IOStats.fold_rank_batches``). When the windowed
rank-load skew sustains past ``RouterParams.skew_threshold``,
``elastic.plan_rebalance`` re-plans placement and the router restacks.
A settled or balanced stream plans zero moves.

Observability: ``router.route`` spans per batch, ``coord.shard`` spans
per rank, ``router.rebalance`` spans on firing evaluations, and
``(name, target="rank<r>")`` metrics through ``obs``.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.device_search import (check_stackable, device_anns,
                                            merge_shard_topk)
from repro_torch.core.iostats import IOStats, TPU_HBM_SEGMENT, CostModel
from repro_torch.core.params import DeviceSearchParams, RouterParams
from repro_torch.distributed import elastic
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.obs.calibrate import load_calibrated


class MeshQueryRouter:
    """Fan a query batch over the ranks' segments; one ``SegmentTarget``
    whose id space is the union of its members'.

    ``servers``: single-segment device targets (``SegmentServer``-like:
    ``segment``/``offset``/``num_vectors``; ``host`` optional, needed
    only to repack). All member segments must be shape-identical and
    share search params + metric, and lie on one device, where the
    router runs. Member ``offset``s are global bases; the router's own
    ``offset`` is 0 because its results already carry global ids.
    ``mesh`` defaults to one rank per segment."""

    def __init__(self, servers: Sequence, *, mesh=None,
                 params: RouterParams = RouterParams(),
                 cost_model: Optional[CostModel] = None,
                 tracer=None, metrics=None):
        if not servers:
            raise ValueError("MeshQueryRouter needs at least one "
                             "segment server")
        self.servers = list(servers)
        p0 = self.servers[0].params
        m0 = getattr(self.servers[0], "metric", "l2")
        for s in self.servers[1:]:
            if s.params != p0 or getattr(s, "metric", "l2") != m0:
                raise ValueError(
                    "mesh members must share DeviceSearchParams and "
                    "metric — one step serves every rank")
        self.params = params
        self.search_params: DeviceSearchParams = p0
        self.metric = m0
        self.k_default = getattr(self.servers[0], "k_default", 10)
        self.offset = 0
        self.num_vectors = sum(s.num_vectors for s in self.servers)
        if cost_model is None:
            cost_model = load_calibrated(TPU_HBM_SEGMENT)
        self.cost_model = cost_model
        self.tracer = tracer
        self.metrics = metrics

        self.mesh = mesh if mesh is not None else make_debug_mesh(
            1, len(self.servers))
        self.world = int(self.mesh.shape["model"])
        for ax, n in self.mesh.shape.items():
            if ax != "model" and n != 1:
                raise ValueError(
                    f"router meshes shard segments over 'model' only; "
                    f"axis {ax!r} has size {n} (want 1)")
        if self.world < len(self.servers):
            raise ValueError(
                f"{self.world} mesh ranks cannot hold "
                f"{len(self.servers)} segments at >= 1 replica each")

        # initial placement: uniform loads -> round-robin-ish replicas
        self._placement: List[int] = elastic.plan_placement(
            [1.0] * len(self.servers), self.world)
        self._restack()
        # sliding window of (rank_loads [W], seg_loads [S], rank_queries
        # [W]): the rebalance evidence and the replica-slice weights
        self._window = deque(maxlen=params.window_batches)
        self._since_eval = 0
        self.batches = 0
        self.rebalances = 0
        self.last_per_rank: Dict[int, IOStats] = {}
        self.last_stats: Optional[IOStats] = None
        self.last_plan: Optional[elastic.PlacementPlan] = None

    # ------------------------------------------------------------ stacking
    def _restack(self) -> None:
        """(Re)index the per-rank segments and offsets from the current
        placement. A rank holds its member's segment by reference (on
        one card replicas share memory); shapes must agree as a stacked
        tree's would."""
        self._seg_stack = [self.servers[si].segment
                           for si in self._placement]
        check_stackable(self._seg_stack)
        devs = {str(seg.device) for seg in self._seg_stack}
        if len(devs) > 1:
            raise ValueError(f"mesh members lie on devices {sorted(devs)}; "
                             "the one-card router needs them on one")
        self._offsets = np.asarray(
            [self.servers[si].offset for si in self._placement],
            np.int32)

    @property
    def placement(self) -> Tuple[int, ...]:
        return tuple(self._placement)

    def _seg_ranks(self) -> Dict[int, List[int]]:
        """segment index -> its replica ranks (ascending)."""
        out: Dict[int, List[int]] = {}
        for r, si in enumerate(self._placement):
            out.setdefault(si, []).append(r)
        return out

    # ------------------------------------------------------------- the step
    def _step(self, queries: np.ndarray, meta: np.ndarray, k: int):
        """The JAX ``shard_map`` step as a loop over ranks: every rank
        takes its segment's search of the whole batch (run once per
        distinct segment; its replicas share it), masks the rows it
        does not own to the -1/inf sentinels, and the stacked results
        merge. Returns the JAX step's outputs as numpy: merged ids and
        dists [Q, k], the per-rank columns [Q, W] masked to owned rows,
        and each rank's rounds [W]."""
        p = dataclasses.replace(
            self.search_params, k=k,
            candidates=max(self.search_params.candidates, k))
        dev = self._seg_stack[0].device       # every rank's: one card
        q = torch.as_tensor(queries, device=dev)
        qidx = torch.arange(q.shape[0], device=dev)
        gids, gds, cols, rounds = [], [], [], []
        searched = {}                         # segment index -> result
        for r, (si, seg) in enumerate(zip(self._placement,
                                          self._seg_stack)):
            if si not in searched:
                searched[si] = device_anns(seg, q, p, metric=self.metric)
            res = searched[si]
            own = (qidx >= int(meta[r, 1])) & (qidx < int(meta[r, 2]))
            gid = torch.where((res.ids >= 0) & own[:, None],
                              res.ids + int(meta[r, 0]),
                              torch.full_like(res.ids, -1))
            gids.append(gid)
            gds.append(torch.where(gid >= 0, res.dists,
                                   torch.full_like(res.dists, np.inf)))
            owni = own.to(res.io.dtype)
            # per-rank device columns, masked to owned rows: the
            # fold_rank_batches inputs (rounds stays whole-batch: the
            # rank's loop really ran that many rounds)
            cols.append(torch.stack([
                c * owni for c in (res.io, res.hops, res.tier0_hits,
                                   res.dedup_saved, res.dedup_cross,
                                   res.spec_hits, res.spec_wasted)]))
            rounds.append(int(res.rounds))
        mi, md = merge_shard_topk(torch.stack(gids), torch.stack(gds), k)
        c = torch.stack(cols, dim=2).cpu().numpy()      # [7, Q, W]
        return (mi.cpu().numpy(), md.cpu().numpy(), *c,
                np.asarray(rounds, np.int32))

    # ------------------------------------------------------------- routing
    def _rank_weights(self) -> np.ndarray:
        """Inverse windowed per-rank load: the slice weights. Uniform
        until the window has data."""
        w = np.ones(self.world)
        if self._window:
            load = np.zeros(self.world)
            for rank_loads, _, _ in self._window:
                load += rank_loads
            w = 1.0 / (1.0 + load)
        return w

    def _rank_meta(self, q: int) -> np.ndarray:
        """[W, 3] int32 (offset, q_lo, q_hi) per rank: each segment's
        replica group partitions [0, q) into contiguous slices sized by
        the inverse-load weights (largest remainder, rank order)."""
        meta = np.zeros((self.world, 3), np.int32)
        meta[:, 0] = self._offsets
        weights = self._rank_weights()
        for si, ranks in self._seg_ranks().items():
            w = weights[ranks]
            quota = w / w.sum() * q
            sizes = np.floor(quota).astype(np.int64)
            short = q - int(sizes.sum())
            order = sorted(range(len(ranks)),
                           key=lambda i: (-(quota[i] - sizes[i]), i))
            for i in order[:short]:
                sizes[i] += 1
            lo = 0
            for r, size in zip(ranks, sizes):
                meta[r, 1], meta[r, 2] = lo, lo + size
                lo += int(size)
            assert lo == q, (lo, q)
        return meta

    def route(self, queries: np.ndarray, k: Optional[int] = None
              ) -> Tuple[np.ndarray, np.ndarray, Dict]:
        """Serve one batch across the ranks. Returns global ``(ids
        [Q, k], dists [Q, k], stats)``: stats carries the rank-keyed
        ``IOStats`` fold, their ``merge_ranks`` total, and (when due)
        the rebalance plan."""
        k = k or self.k_default
        q = np.asarray(queries, np.float32)
        meta = self._rank_meta(q.shape[0])
        if self.tracer is not None:
            with self.tracer.span("router.route", cat="serve",
                                  track="router",
                                  n_queries=int(q.shape[0]), k=int(k),
                                  ranks=self.world) as sp:
                out = self._step(q, meta, k)
                ids, dists, stats = self._account(out, meta)
                sp["block_reads"] = stats["total_block_reads"]
                sp["rounds_max"] = stats["rounds_max"]
        else:
            out = self._step(q, meta, k)
            ids, dists, stats = self._account(out, meta)
        plan = self.maybe_rebalance()
        if plan is not None:
            stats["rebalance"] = {
                "fired": plan.fired, "moves": len(plan.moves),
                "skew": plan.skew,
                "placement": list(plan.placement)}
        return ids, dists, stats

    def _account(self, out, meta) -> Tuple[np.ndarray, np.ndarray, Dict]:
        (ids, dists, io_c, hops_c, t0_c, sv_c, cx_c, sh_c, sw_c,
         rounds) = [np.asarray(x) for x in out]
        w = self.world
        # the shared mesh fold: per-rank IOStats from the masked device
        # columns; totals are defined only as the merge of the per-rank
        # folds (rounds_active_weight is not additive across ranks with
        # different round counts)
        pipelined = (self.search_params.pipeline_dma
                     and self.search_params.fetch_impl == "fused")
        speculative = self.search_params.speculate
        per_rank = IOStats.fold_rank_batches(
            {r: (io_c[:, r], t0_c[:, r], hops_c[:, r], sv_c[:, r],
                 int(rounds[r]), cx_c[:, r], pipelined,
                 sh_c[:, r], sw_c[:, r], speculative)
             for r in range(w)})
        total = IOStats.merge_ranks(per_rank)
        self.last_per_rank = per_rank
        self.last_stats = total
        self._last_cols = (io_c, t0_c, hops_c, sv_c, cx_c, sh_c, sw_c,
                           rounds)
        self.batches += 1
        self._since_eval += 1

        rank_loads = np.asarray(
            [per_rank[r].rounds_active_weight for r in range(w)])
        rank_queries = np.asarray(
            [int(meta[r, 2] - meta[r, 1]) for r in range(w)], float)
        seg_loads = np.zeros(len(self.servers))
        for r, si in enumerate(self._placement):
            seg_loads[si] += rank_loads[r]
        self._window.append((rank_loads, seg_loads, rank_queries))

        per_rank_us = {r: self.cost_model.latency_us(per_rank[r])
                       for r in range(w)}
        if self.tracer is not None or self.metrics is not None:
            for r in range(w):
                s = per_rank[r]
                if self.tracer is not None:
                    with self.tracer.span(
                            "coord.shard", cat="serve", track="router",
                            target=f"rank{r}",
                            segment=int(self._placement[r])) as sp:
                        sp["block_reads"] = s.block_reads
                        sp["rounds"] = s.batch_rounds
                        sp["occupancy"] = s.rounds_active_weight
                        sp["modeled_step_us"] = per_rank_us[r]
                if self.metrics is not None:
                    m = self.metrics
                    m.counter("router.block_reads", f"rank{r}").inc(
                        s.block_reads)
                    m.counter("router.tier0_hits", f"rank{r}").inc(
                        s.tier0_hits)
                    m.gauge("router.occupancy", f"rank{r}").set(
                        s.rounds_active_weight)
                    m.gauge("router.modeled_step_us", f"rank{r}").set(
                        per_rank_us[r])
            if self.metrics is not None:
                self.metrics.counter("router.batches").inc()

        stats = {
            "ranks": w,
            "segments": len(self.servers),
            "placement": list(self._placement),
            "per_rank": per_rank,
            "total": total,
            "total_block_reads": total.block_reads,
            "total_tier0_hits": total.tier0_hits,
            "total_dedup_saved": total.dedup_saved_fetches,
            "total_dedup_cross": total.dedup_cross_tile,
            "total_spec_hits": total.spec_hits,
            "total_spec_wasted": total.spec_wasted,
            "rounds_max": total.batch_rounds,
            # a CostModel figure per rank (TPU-HBM constants unless a
            # calibration says otherwise): a model, not a time
            "per_rank_modeled_us": per_rank_us,
            # the step is gated by its slowest rank
            "modeled_step_us": max(per_rank_us.values()),
        }
        return ids, dists, stats

    # ----------------------------------------------------------- rebalance
    def window_rank_loads(self) -> np.ndarray:
        load = np.zeros(self.world)
        for rank_loads, _, _ in self._window:
            load += rank_loads
        return load

    def window_seg_loads(self) -> np.ndarray:
        load = np.zeros(len(self.servers))
        for _, seg_loads, _ in self._window:
            load += seg_loads
        return load

    def maybe_rebalance(self, force: bool = False
                        ) -> Optional[elastic.PlacementPlan]:
        """Evaluate placement once per ``rebalance_interval`` routed
        batches (or on ``force``), with at least ``min_window`` steps
        of evidence. Returns the plan (fired or not), or None when not
        yet due. A firing plan restacks in place."""
        p = self.params
        if not force and (self._since_eval < p.rebalance_interval
                          or len(self._window) < p.min_window):
            return None
        self._since_eval = 0
        plan = elastic.plan_rebalance(
            self._placement, self.window_seg_loads().tolist(),
            self.window_rank_loads().tolist(),
            skew_threshold=p.skew_threshold)
        self.last_plan = plan
        if plan.fired:
            if self.tracer is not None:
                with self.tracer.span("router.rebalance", cat="serve",
                                      track="router",
                                      moves=len(plan.moves),
                                      skew=float(plan.skew)) as sp:
                    self._placement = list(plan.placement)
                    self._restack()
                    sp["placement"] = ",".join(
                        str(s) for s in plan.placement)
            else:
                self._placement = list(plan.placement)
                self._restack()
            self.rebalances += 1
            # moved segments invalidate the window's rank attribution
            self._window.clear()
            if self.metrics is not None:
                self.metrics.counter("router.rebalances").inc()
        return plan

    # ------------------------------------- SegmentTarget capability hooks
    def search(self, queries: np.ndarray, k: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``SegmentTarget`` surface: global ids (offset 0), merged
        dists, per-query cold block touches summed across ranks."""
        ids, dists, _ = self.route(queries, k)
        # per-query cold touches: the owned-row columns sum across
        # ranks to exactly one contribution per (query, segment)
        io = self._last_cols[0].sum(axis=1).astype(np.int64)
        return ids, dists, io

    def batch_stats(self) -> Dict[str, object]:
        """The last routed step's device columns summed across ranks,
        with the slowest rank's round count: the view a routed step
        presents to per-batch pricing (``RepackScheduler.note_batch``).
        Exact per-rank folds live in ``last_per_rank``; totals in
        ``last_stats`` (their ``merge_ranks``)."""
        if self._last_cols is None:
            return {}
        (io_c, t0_c, hops_c, sv_c, cx_c, sh_c, sw_c,
         rounds) = self._last_cols
        return {"io": io_c.sum(axis=1), "tier0_hits": t0_c.sum(axis=1),
                "hops": hops_c.sum(axis=1),
                "dedup_saved": sv_c.sum(axis=1),
                "dedup_cross": cx_c.sum(axis=1),
                "spec_hits": sh_c.sum(axis=1),
                "spec_wasted": sw_c.sum(axis=1),
                "rounds": int(rounds.max()),
                "dma_pipelined": (self.search_params.pipeline_dma
                                  and self.search_params.fetch_impl
                                  == "fused"),
                "dma_speculative": self.search_params.speculate}

    _last_cols = None

    def lifetime_stats(self) -> Dict[str, float]:
        out: Dict[str, float] = {"batches": float(self.batches),
                                 "rebalances": float(self.rebalances)}
        for r, load in enumerate(self.window_rank_loads()):
            out[f"rank{r}_window_load"] = float(load)
        return out

    def repack_source(self):
        return None          # member packs are repacked via repack()

    def repack(self, observed, plan=None) -> int:
        """Repack every member's tier-0 pack from ``observed`` demand
        and restack (same shapes). Members without a host ``Segment``
        are skipped."""
        changed = 0
        for s in self.servers:
            if getattr(s, "host", None) is not None:
                changed += s.repack(observed, plan=plan)
        self._restack()
        return changed

    def demand_feed(self):
        return None

    def attach_obs(self, tracer, metrics) -> None:
        if tracer is not None and self.tracer is None:
            self.tracer = tracer
        if metrics is not None and self.metrics is None:
            self.metrics = metrics
