"""The serving plane's tier-0 repack scheduler (port of
``repro.serving.scheduler``).

``RepackScheduler`` closes the loop between what the serving plane
observes and the device's tier-0 hot-tile pack:

  * demand feeds — every cache-fronted host store
    (``io.cached_store.CachedBlockStore``) registers its ``block_freq``;
    the scheduler folds the union of their windowed ``freq_delta``
    counters;
  * device telemetry — after each served batch the coordinator notes
    the device servers' columns; each batch folds through
    ``IOStats.from_device_batch`` and is priced by ``CostModel.
    latency_us`` (by default the TPU-HBM constants with any stored
    calibration, ``obs.calibrate.load_calibrated``: a modeled figure,
    not a time of the card), and the observed tier-0 hit rate is
    derived;
  * decision — every ``interval_batches`` batches it plans the pack each
    target would select under the union demand (``hotset.plan_tier0``)
    and compares it with the live pack (``hotset.pack_drift``); a
    repack fires only when the drift reaches ``hysteresis`` and the
    target's observed hit rate is below ``hit_rate_ceiling``, so a
    no-op repack builds nothing and the loop cannot oscillate;
  * repack — ``SegmentServer.repack`` swaps the pack's tiles at the same
    budget (``device_search.repack_tier0``). The pack holds exact
    copies, so a repack never changes ``(ids, dists)``; only the io /
    tier0_hits split moves.

With a tracer (``tracer=``, or the coordinator's), every evaluation,
repack and layout swap is an instant event: ``sched.eval``,
``sched.repack``, ``sched.layout_swap``.
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.device_search import hot_pack_blocks
from repro_torch.core.iostats import IOStats, TPU_HBM_SEGMENT, CostModel
from repro_torch.core.params import RepackParams
from repro_torch.io import hotset
from repro_torch.io.cached_store import CachedBlockStore
from repro_torch.obs.calibrate import load_calibrated
from repro_torch.serving import target as tgt


@dataclasses.dataclass
class RepackDecision:
    """One scheduler evaluation (returned by ``maybe_repack``)."""
    evaluated: int                # targets whose drift was priced
    repacked: int                 # targets actually repacked
    changed_slots: int            # pack slots moved across all repacks
    max_drift: float              # largest planned drift seen
    tier0_hit_rate: float         # observed device hit rate this window
    modeled_step_us: float        # round-granular modeled step time of
    #                               the window's device traffic (the
    #                               objective; 0 with no device batches)
    observed_blocks: int          # distinct blocks in the union window


class RepackScheduler:
    """Periodic, hysteresis-gated tier-0 repack from observed demand.

    Wire-up (the ``QueryCoordinator`` does all three per batch when
    constructed with ``scheduler=``):

        sched = RepackScheduler(RepackParams())
        sched.attach_feed(host_server.view.store)   # demand signal
        sched.attach_target(device_server)          # pack to steer
        ...
        sched.note_batch([device_server, ...])      # device columns
        decision = sched.maybe_repack()             # every interval
    """

    def __init__(self, params: RepackParams = RepackParams(),
                 cost_model: Optional[CostModel] = None,
                 tracer=None):
        self.params = params
        if cost_model is None:
            # default pricing: the TPU-HBM preset with any calibrated
            # constants from results/CALIB_*.json applied on top
            # (backend mismatch / missing file -> the hardcoded preset)
            cost_model = load_calibrated(TPU_HBM_SEGMENT)
        self.cost_model = cost_model
        self.tracer = tracer            # obs: sched.eval / sched.repack
        #                                 events, None-guarded
        self._feeds: List[CachedBlockStore] = []
        self._marks: List[Counter] = []     # per-feed freq watermarks
        self._targets: List = []            # SegmentServers with .host
        self._rankings: List[List[int]] = []  # build-time ranking/target
        self._window: Counter = Counter()   # union demand since the
        #                                     last full repack (or start)
        self._server_stats: Dict[int, IOStats] = {}  # id(server) ->
        #                                     device columns this window
        self._step_us_sum = 0.0             # Σ per-batch modeled step
        self._step_batches = 0              #   times (priced at note
        #                                     time, so the mean stays a
        #                                     per-batch figure)
        self.batches = 0                    # batches noted since last eval
        self.evals = 0
        self.repacks = 0                    # repacks fired (lifetime)
        self.skipped = 0                    # hysteresis/ceiling no-ops
        self.last_decision: Optional[RepackDecision] = None

    # ------------------------------------------------------------ wiring
    def attach_feed(self, store: CachedBlockStore) -> None:
        """Register a host store's ``block_freq`` as a demand feed."""
        if not isinstance(store, CachedBlockStore):
            raise TypeError("demand feeds must be CachedBlockStores "
                            f"(got {type(store).__name__})")
        if any(s is store for s in self._feeds):
            return
        self._feeds.append(store)
        self._marks.append(Counter(store.block_freq))

    def attach_target(self, server) -> None:
        """Register a serving target whose tier-0 pack this scheduler
        steers. The target's ``repack_source()`` must yield the host
        ``Segment`` the device pack is rebuilt from (``SegmentTarget``
        protocol; ``SegmentServer.host`` for the concrete server)."""
        seg = tgt.repack_source(server)
        if seg is None:
            raise ValueError(
                "repack targets need a repack_source() host Segment "
                "(SegmentServer.host for device servers) — the device "
                "pack is rebuilt from host arrays")
        if any(t is server for t in self._targets):
            return
        v = seg.view
        self._targets.append(server)
        self._rankings.append(hotset.hot_block_ranking(
            v.layout.block_of, seg.graph.adj, seg.graph.deg,
            hotset.view_seed_ids(v)))

    def note_layout_swap(self, server) -> None:
        """A compaction swapped a fresh ``Segment`` under ``server``
        (``core.delta.swap_into_host_server`` /
        ``swap_into_device_server``): re-derive the target's
        build-time ranking from the NEW layout and drop demand-window
        entries that index past the new block count — stale demand for
        since-compacted blocks must never reach a pack plan
        (``hotset.fill_to``'s range filter backstops feeds this
        scheduler never hears about). The window otherwise survives:
        still-valid demand keeps accumulating drift."""
        seg = tgt.repack_source(server)
        for i, t in enumerate(self._targets):
            if t is server and seg is not None:
                v = seg.view
                self._rankings[i] = hotset.hot_block_ranking(
                    v.layout.block_of, seg.graph.adj, seg.graph.deg,
                    hotset.view_seed_ids(v))
                break
        if seg is not None:
            total = int(seg.view.store.num_blocks)
            self._window = Counter(
                {b: c for b, c in self._window.items()
                 if 0 <= int(b) < total})
        # the swapped target's telemetry window restarts with its layout
        self._server_stats.pop(id(server), None)
        if self.tracer is not None:
            self.tracer.event(
                "sched.layout_swap", cat="sched", track="sched",
                target=str(getattr(server, "offset", -1)),
                window_blocks=len(self._window))

    # --------------------------------------------------------- telemetry
    def note_batch(self, servers: Sequence = ()) -> None:
        """Fold one served batch's device columns into the window:
        per-server merged counters (so the hit-rate gate judges each
        target on its own traffic) and the batch's modeled step time
        (priced immediately, so the objective stays a per-batch
        figure)."""
        self.batches += 1
        for s in servers:
            bs = tgt.batch_stats(s)
            if not bs:
                continue
            batch = IOStats.from_device_batch(
                np.asarray(bs["io"]), np.asarray(bs["tier0_hits"]),
                np.asarray(bs["hops"]), np.asarray(bs["dedup_saved"]),
                int(bs["rounds"]),
                np.asarray(bs["dedup_cross"]),
                bool(bs.get("dma_pipelined", False)),
                np.asarray(bs["spec_hits"]),
                np.asarray(bs["spec_wasted"]),
                bool(bs.get("dma_speculative", False)),
                np.asarray(bs["hot_tier_hits"]))
            self._server_stats.setdefault(id(s), IOStats()).merge(batch)
            self._step_us_sum += self.cost_model.latency_us(batch)
            self._step_batches += 1

    def demand_union(self) -> Counter:
        """The union windowed demand signal across every feed."""
        u = Counter()
        for store, mark in zip(self._feeds, self._marks):
            u.update(store.freq_delta(mark))
        # window survives across below-threshold evaluations, so drift
        # accumulates until it clears the hysteresis gate
        return self._window + u

    def _advance_marks(self) -> None:
        for i, store in enumerate(self._feeds):
            self._marks[i] = Counter(store.block_freq)

    @staticmethod
    def _hit_rate(s: Optional[IOStats]) -> float:
        """Tier-0 hit rate of one window's counters. 0.0 with no
        traffic: missing telemetry must never *suppress* a repack (the
        ceiling gate exists to protect a pack KNOWN to absorb the
        stream — an unobserved one gets no such pass)."""
        if s is None:
            return 0.0
        touched = s.tier0_hits + s.cache_misses
        if touched == 0:
            return 0.0
        return s.tier0_hits / touched

    @property
    def window_hit_rate(self) -> float:
        """Observed tier-0 hit rate across ALL device traffic this
        window (per-target rates gate the repack decision; this is the
        dashboard aggregate)."""
        agg = IOStats()
        for s in self._server_stats.values():
            agg.merge(s)
        return self._hit_rate(agg if self._server_stats else None)

    def modeled_step_us(self) -> float:
        """Mean modeled step time per served batch this window, priced
        batch-by-batch with the round-granular model
        (``IOStats.from_device_batch`` + ``CostModel.latency_us``) — the
        scheduler's objective. Modeled, not a time of the card."""
        if self._step_batches == 0:
            return 0.0
        return self._step_us_sum / self._step_batches

    # ---------------------------------------------------------- decision
    def due(self) -> bool:
        return self.batches >= self.params.interval_batches

    def maybe_repack(self, force: bool = False
                     ) -> Optional[RepackDecision]:
        """Evaluate once per ``interval_batches`` noted batches (or on
        ``force``); returns the decision, or None when not yet due."""
        if not force and not self.due():
            return None
        p = self.params
        union = self.demand_union()
        self._window = union
        self._advance_marks()
        # one noise-floored view for BOTH the drift plan and the repack
        # itself — they must select identically or hysteresis lies
        obs = Counter({b: c for b, c in union.items()
                       if c >= p.min_observed})
        hit_rate = self.window_hit_rate
        step_us = self.modeled_step_us()
        evaluated = repacked = changed = 0
        max_drift = 0.0
        for i, server in enumerate(self._targets):
            ds = getattr(server, "segment", None)
            if ds is None:
                continue                    # no device pack to steer
            current = hot_pack_blocks(ds)
            if not current:
                continue                    # tier 0 disabled: nothing to steer
            evaluated += 1
            plan = hotset.plan_tier0(
                self._rankings[i], obs, len(current),
                int(ds.hot_slot_of.shape[0]))
            drift = hotset.pack_drift(current, plan)
            max_drift = max(max_drift, drift)
            # each target is judged on ITS OWN observed hit rate — one
            # well-packed target must not shield a drifted sibling
            own_rate = self._hit_rate(self._server_stats.get(id(server)))
            if drift < p.hysteresis or own_rate >= p.hit_rate_ceiling:
                continue                    # no-op repack: free by design
            moved = server.repack(obs, plan=plan)
            changed += moved
            repacked += 1
            if self.tracer is not None:
                self.tracer.event(
                    "sched.repack", cat="sched", track="sched",
                    target=str(getattr(server, "offset", i)),
                    changed_slots=moved, drift=drift,
                    tier0_hit_rate=own_rate)
            # the repacked target's telemetry restarts; siblings keep
            # their window counters
            self._server_stats.pop(id(server), None)
        if repacked:
            self.repacks += repacked
        if repacked == evaluated and repacked > 0:
            # every target moved: a fresh pack starts a fresh window so
            # post-repack traffic alone drives the next decision. With
            # a below-threshold sibling still waiting, the window
            # SURVIVES — its drift must keep accumulating or hysteresis
            # would starve slow drifters (the documented invariant).
            self._window = Counter()
            self._step_us_sum, self._step_batches = 0.0, 0
        if repacked < evaluated:
            self.skipped += evaluated - repacked
        self.evals += 1
        self.batches = 0
        self.last_decision = RepackDecision(
            evaluated=evaluated, repacked=repacked, changed_slots=changed,
            max_drift=max_drift, tier0_hit_rate=hit_rate,
            modeled_step_us=step_us, observed_blocks=len(union))
        if self.tracer is not None:
            self.tracer.event(
                "sched.eval", cat="sched", track="sched",
                evaluated=evaluated, repacked=repacked,
                changed_slots=changed, max_drift=max_drift,
                tier0_hit_rate=hit_rate, modeled_step_us=step_us)
        return self.last_decision

    def stats(self) -> Dict[str, float]:
        """Lifetime control-loop counters (for serving dashboards)."""
        return {"evals": self.evals, "repacks": self.repacks,
                "skipped": self.skipped,
                "window_blocks": len(self._window),
                "window_hit_rate": self.window_hit_rate,
                "modeled_step_us": self.modeled_step_us()}
