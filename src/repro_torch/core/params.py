"""Parameter dataclasses of the segment, its host search and serving
plane, and the device search.

Copies of ``repro.core.params`` with the same field names, so one set of
values drives both packages (the presets built from them live in
``configs.starling_segment`` and ``serving.coordinator``, as in JAX).
Only the fields this package reads are kept (the build's graph, layout,
navigation-graph and budget knobs, the host search's, the block cache's
and the device tier-0 budget, the repack scheduler's, the device
search's, the hot tier's). ``fetch_impl`` takes
``"fused"`` (the CUDA round kernels) or ``"ref"`` (the plain PyTorch
round stage, the counterpart of the JAX ``"jnp"``).
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class GraphParams:
    """Graph-index construction (Vamana / NSG)."""
    max_degree: int = 32          # Λ
    build_beam: int = 64          # L (candidate list during construction)
    alpha: float = 1.2            # Vamana robust-prune slack
    algo: str = "vamana"          # vamana | nsg | hnsw
    insert_batch: int = 256       # batched-insert chunk during build
    seed: int = 0

    def __post_init__(self):
        if self.build_beam < self.max_degree:
            raise ValueError("L must be >= Λ (App. L)")
        if self.algo not in ("vamana", "nsg", "hnsw"):
            raise ValueError(f"unknown graph algo {self.algo!r}")


@dataclasses.dataclass(frozen=True)
class LayoutParams:
    block_kb: float = 4.0         # η
    shuffle: str = "bnf"          # none | bnp | bnf | bns | kmeans | gp3
    bnf_iters: int = 8            # β
    bns_iters: int = 2            # β for BNS
    gain_tau: float = 0.01        # τ

    def verts_per_block(self, dim: int, max_degree: int,
                        dtype_bytes: int = 4) -> int:
        """ε = ⌊η/γ⌋ with γ = D·b + 4 (λ) + Λ·4 bytes (Example 2)."""
        gamma = dim * dtype_bytes + 4 + max_degree * 4
        eps = int(self.block_kb * 1024) // gamma
        if eps < 1:
            raise ValueError(
                f"vertex ({gamma}B) does not fit a {self.block_kb}KB block")
        return eps

    def num_blocks(self, n: int, dim: int, max_degree: int,
                   dtype_bytes: int = 4) -> int:
        """ρ = ⌈n/ε⌉ blocks of n vertices."""
        eps = self.verts_per_block(dim, max_degree, dtype_bytes)
        return math.ceil(n / eps)


@dataclasses.dataclass(frozen=True)
class PQParams:
    num_subspaces: int = 8        # M
    num_centroids: int = 256      # K (uint8 codes)
    train_iters: int = 12
    train_sample: int = 16384
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class NavGraphParams:
    sample_ratio: float = 0.1     # μ
    max_degree: int = 20          # Λ'
    build_beam: int = 64
    search_beam: int = 16         # beam when finding entry points
    num_entry_points: int = 4     # entry points handed to the disk search
    seed: int = 1


@dataclasses.dataclass(frozen=True)
class HotTierParams:
    """The in-memory hot tier above the block hierarchy (``io.hottier``):
    a navigable graph over the hot-set vectors that answers first; the
    cold block search is seeded from its exit frontier. Also the home
    of a segment's inserts until a compaction."""
    budget_frac: float = 0.10     # share of segment vectors resident hot
    max_degree: int = 16          # hot-graph degree
    build_beam: int = 48
    search_beam: int = 16         # beam for the hot route (to convergence)
    exit_width: int = 4           # exit-frontier seeds handed to cold search
    cold_gamma_frac: float = 0.85  # the hybrid's cold Γ as a share of the
    #                                configured candidate size
    append_slack: float = 0.5     # append-region capacity / built size
    hops: int = 1                 # BFS depth of the hot-set ranking
    seed: int = 1

    def __post_init__(self):
        if not 0.0 < self.budget_frac <= 1.0:
            raise ValueError("budget_frac must be in (0, 1]")
        if not 0.0 < self.cold_gamma_frac <= 1.0:
            raise ValueError("cold_gamma_frac must be in (0, 1]")
        if self.exit_width < 1:
            raise ValueError("exit_width must be >= 1")
        if self.append_slack < 0.0:
            raise ValueError("append_slack must be >= 0")
        if self.search_beam < self.exit_width:
            raise ValueError("search_beam must cover exit_width")


@dataclasses.dataclass(frozen=True)
class SearchParams:
    """Host block-search knobs (§5; ``core.search``)."""
    candidate_size: int = 64      # Γ
    pruning_ratio: float = 0.3    # σ
    use_pq_routing: bool = True
    use_nav_graph: bool = True
    use_block_search: bool = True  # False → vertex-at-a-time
    pipeline: bool = True          # I/O–compute overlap (modeled)
    rs_ratio: float = 0.5          # φ
    rs_max_rounds: int = 6         # cap on candidate-set doublings
    max_hops: int = 4096           # safety valve


@dataclasses.dataclass(frozen=True)
class CacheParams:
    """The host block cache (``io.cached_store``) and the device tier-0
    budget.

    ``budget_bytes`` / ``budget_frac`` (of the block file) reserve the
    host cache, charged as C_cache into Eq. 10; both zero disables it.
    ``pin_fraction`` of tier 1 holds the build-time hot set;
    ``prefetch_width`` speculative blocks ride each demand read;
    ``tier2_frac`` of the budget becomes compressed PQ-space summaries
    at ``block_bytes // tier2_compression`` each; ``queue_depth`` > 0
    switches the fetch path to the event-clock ``AsyncFetchQueue``.
    ``tier0_bytes`` / ``tier0_frac`` budget the device hot-tile pack
    (``device_search.from_segment``), charged as C_tier0."""
    budget_bytes: int = 0         # absolute host block-cache budget
    budget_frac: float = 0.0      # fraction of disk_bytes (if bytes == 0)
    policy: str = "lru"           # lru | lfu
    pin_fraction: float = 0.25    # share of tier-1 capacity pinned
    prefetch_width: int = 4       # speculative blocks per demand read
    tier2_frac: float = 0.0       # share of the budget in the summary tier
    tier2_compression: int = 16   # full-block bytes per summary byte
    queue_depth: int = 0          # in-flight fetches (0 → synchronous)
    tier0_bytes: int = 0          # absolute device hot-tile budget
    tier0_frac: float = 0.0       # fraction of disk_bytes (if bytes == 0)

    def __post_init__(self):
        if self.policy not in ("lru", "lfu"):
            raise ValueError(
                f"unknown eviction policy {self.policy!r} (lru | lfu)")
        if not (0.0 <= self.pin_fraction <= 1.0
                and 0.0 <= self.budget_frac <= 1.0
                and self.budget_bytes >= 0 and self.prefetch_width >= 0):
            raise ValueError(
                "CacheParams out of range: pin_fraction/budget_frac in "
                "[0, 1], budget_bytes/prefetch_width >= 0")
        if not (0.0 <= self.tier2_frac < 1.0):
            raise ValueError("tier2_frac must be in [0, 1): tier 1 "
                             "needs a non-empty share of the budget")
        if self.tier2_compression < 1 or self.queue_depth < 0:
            raise ValueError(
                "tier2_compression must be >= 1 and queue_depth >= 0")
        if not (0.0 <= self.tier0_frac <= 1.0) or self.tier0_bytes < 0:
            raise ValueError(
                "tier0_frac must be in [0, 1] and tier0_bytes >= 0")

    @property
    def enabled(self) -> bool:
        """Whether the host block cache is asked for."""
        return self.budget_bytes > 0 or self.budget_frac > 0.0

    @property
    def tier0_enabled(self) -> bool:
        return self.tier0_bytes > 0 or self.tier0_frac > 0.0

    def resolve_budget(self, disk_bytes: int) -> int:
        """Host cache budget in bytes (Eq. 10's C_cache charge)."""
        if self.budget_bytes > 0:
            return self.budget_bytes
        return int(self.budget_frac * disk_bytes)

    def resolve_tier0_budget(self, disk_bytes: int) -> int:
        """Device hot-tile budget in bytes (Eq. 10's C_tier0 charge)."""
        if self.tier0_bytes > 0:
            return self.tier0_bytes
        return int(self.tier0_frac * disk_bytes)


@dataclasses.dataclass(frozen=True)
class RepackParams:
    """Knobs of the tier-0 repack scheduler (``serving.scheduler``): a
    repack is evaluated every ``interval_batches`` served batches and
    fires only when at least ``hysteresis`` of the pack's slots would
    change and the observed tier-0 hit rate is below
    ``hit_rate_ceiling``; blocks with fewer than ``min_observed``
    demand reads are ignored."""
    interval_batches: int = 8
    hysteresis: float = 0.25
    min_observed: int = 1
    hit_rate_ceiling: float = 0.95

    def __post_init__(self):
        if self.interval_batches < 1:
            raise ValueError("interval_batches must be >= 1")
        if not (0.0 <= self.hysteresis <= 1.0
                and 0.0 <= self.hit_rate_ceiling <= 1.0):
            raise ValueError(
                "hysteresis and hit_rate_ceiling must be in [0, 1]")
        if self.min_observed < 1:
            raise ValueError("min_observed must be >= 1")


@dataclasses.dataclass(frozen=True)
class RouterParams:
    """Knobs of the mesh serving router (``serving.router.
    MeshQueryRouter``).

    The router keeps a sliding window of per-rank load folds (the
    ``rounds_active_weight`` occupancy of each rank's served step) and
    every ``rebalance_interval`` routed batches compares the windowed
    per-segment loads against the current placement. A rebalance fires
    only when the window holds at least ``min_window`` steps AND the
    rank-load skew (max/mean) reaches ``skew_threshold`` AND the
    re-planned placement actually moves a segment, so a settled,
    balanced stream never restacks."""
    window_batches: int = 16      # per-rank load folds kept in the
    #                               sliding window (older steps age out)
    rebalance_interval: int = 8   # evaluate placement every N batches
    min_window: int = 4           # steps the window must hold before a
    #                               rebalance may fire (cold-start guard)
    skew_threshold: float = 1.5   # min max/mean windowed rank load for
    #                               a rebalance to fire (1.0 = any skew)

    def __post_init__(self):
        if self.window_batches < 1 or self.rebalance_interval < 1 \
                or self.min_window < 1:
            raise ValueError("window_batches, rebalance_interval and "
                             "min_window must be >= 1")
        if self.min_window > self.window_batches:
            raise ValueError("min_window cannot exceed window_batches")
        if self.skew_threshold < 1.0:
            raise ValueError("skew_threshold must be >= 1.0 "
                             "(max/mean load is never below 1)")


@dataclasses.dataclass(frozen=True)
class SegmentBudget:
    """Per-segment space budget (§2.2: <= 2 GB memory, <= 10 GB disk,
    plus the cap on the device tier-0 pack)."""
    memory_bytes: int = 2 << 30
    disk_bytes: int = 10 << 30
    tier0_vmem_bytes: int = 4 << 20


@dataclasses.dataclass(frozen=True)
class SegmentParams:
    graph: GraphParams = dataclasses.field(default_factory=GraphParams)
    layout: LayoutParams = dataclasses.field(default_factory=LayoutParams)
    pq: PQParams = dataclasses.field(default_factory=PQParams)
    nav: NavGraphParams = dataclasses.field(default_factory=NavGraphParams)
    search: SearchParams = dataclasses.field(default_factory=SearchParams)
    cache: CacheParams = dataclasses.field(default_factory=CacheParams)
    budget: SegmentBudget = dataclasses.field(default_factory=SegmentBudget)
    metric: str = "l2"            # l2 | ip

    def __post_init__(self):
        if self.metric not in ("l2", "ip"):
            raise ValueError(f"unknown metric {self.metric!r} (l2 | ip)")


@dataclasses.dataclass(frozen=True)
class DeviceSearchParams:
    """Batched device-search knobs (``device_search.device_anns``).

    ``fetch_width`` (F) fetches the F best unvisited candidates' blocks
    per round trip. ``compact_frac`` > 0 stably repacks live queries to
    the front once the live fraction drops below it. ``trace_rounds``
    returns the per-round log. ``pipeline_dma`` is kept for the
    accounting (``batch_stats()["dma_pipelined"]``): on the card the
    gather kernel's CTA parallelism takes the place of the TPU's
    two-slot DMA schedule. ``round_tile_cap`` caps the round kernel's
    query tile (the idle-skip and intra/cross-tile accounting unit).
    ``speculate`` adds the spec_hits/spec_wasted accounting.
    ``fuse_union`` runs the batch union inside the gather kernel
    (``gather_union``) instead of as plain ops + ``gather_unique``.
    Results are identical for every setting of the last five."""
    k: int = 10
    candidates: int = 64          # Γ
    sigma: float = 0.3            # σ
    max_hops: int = 128
    fetch_width: int = 1          # F
    nav_beam: int = 8
    nav_hops: int = 12
    entry_points: int = 4
    tier0_frac: float = 0.0
    fetch_impl: str = "fused"     # fused (CUDA kernels) | ref (plain)
    compact_frac: float = 0.0
    trace_rounds: bool = False
    pipeline_dma: bool = True
    round_tile_cap: int = 0
    speculate: bool = False
    fuse_union: bool = True

    def __post_init__(self):
        if self.k < 1 or self.candidates < self.k:
            raise ValueError("need candidates >= k >= 1")
        if not (0.0 <= self.sigma <= 1.0
                and 0.0 <= self.tier0_frac <= 1.0):
            raise ValueError("sigma and tier0_frac must be in [0, 1]")
        if self.fetch_width < 1 or self.max_hops < 1:
            raise ValueError("fetch_width and max_hops must be >= 1")
        if self.fetch_impl not in ("fused", "ref"):
            raise ValueError(
                f"unknown fetch_impl {self.fetch_impl!r} (fused | ref)")
        if not (0.0 <= self.compact_frac <= 1.0):
            raise ValueError("compact_frac must be in [0, 1]")
        if self.round_tile_cap < 0:
            raise ValueError("round_tile_cap must be >= 0 (0 = BQ)")
