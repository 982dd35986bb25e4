"""The paper's own workload (port of ``repro.configs.starling_segment``):
the segment configurations per dataset (Tab. 1, Tab. 16-18) at bench
scale, the device-search and repack presets, and the paper's full-size
per-dataset parameters used by the analytic cost accounting.

``SEGMENT_BENCH`` is the bench-scale segment (10^4-10^5 vectors on the
CPU; ``chip_smoke.py`` builds it at 1M on the card); ``PAPER_DATASETS``
holds the paper's per-dataset parameters (Λ, η, ε, ρ) for the
Example-2 style accounting tests. The values equal JAX's.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.params import (CacheParams, DeviceSearchParams,
                                     GraphParams, LayoutParams,
                                     NavGraphParams, PQParams, RepackParams,
                                     SearchParams, SegmentParams)

# the bench-scale segment: the same knob values as the paper's BIGANN
# column wherever scale-independent (σ=0.3, φ=0.5, β=8,
# τ=0.01, μ≈0.1, PQ codes in memory)
SEGMENT_BENCH = SegmentParams(
    graph=GraphParams(max_degree=24, build_beam=64, alpha=1.2,
                      algo="vamana"),
    layout=LayoutParams(block_kb=4.0, shuffle="bnf", bnf_iters=8,
                        gain_tau=0.001),
    pq=PQParams(num_subspaces=8, num_centroids=256, train_iters=12),
    nav=NavGraphParams(sample_ratio=0.1, max_degree=12, build_beam=32,
                       search_beam=16, num_entry_points=4),
    search=SearchParams(candidate_size=48, pruning_ratio=0.3,
                        rs_ratio=0.5),
    metric="l2",
)

# the same segment with the io block cache on: 10% of the block file as
# cache budget (a quarter pinned to the entry-neighborhood hot set), LRU
# dynamics, 4-wide batched prefetch. Segments built from this config get
# a cache-fronted view, and a HostSegmentServer over such a segment
# shares the cache across queries.
SEGMENT_BENCH_CACHED = dataclasses.replace(
    SEGMENT_BENCH,
    cache=CacheParams(budget_frac=0.10, policy="lru", pin_fraction=0.25,
                      prefetch_width=4),
)

# the async + tiered deployment at the SAME 10% memory budget: a quarter
# of the budget becomes a compressed PQ-space summary tier (~16x more
# blocks per byte; a tier-2 hit re-ranks without a disk trip), and
# fetches go through an 8-deep event-clock AsyncFetchQueue — speculative
# reads stay in flight while the current block is ranked, complete out
# of submission order, and concurrent queries dedup in-flight fetches of
# the same block.
SEGMENT_BENCH_ASYNC = dataclasses.replace(
    SEGMENT_BENCH,
    cache=CacheParams(budget_frac=0.10, policy="lru", pin_fraction=0.25,
                      prefetch_width=4, tier2_frac=0.25,
                      tier2_compression=16, queue_depth=8),
)

# the device deployment: the SAME segment with the tier-0 hot-tile pack
# budgeted at 10% of the block file (selected from the shared
# io.hotset ranking; exact copies, so results stay bit-identical to the
# uncached device path) and charged into Eq. 10 as C_tier0.
SEGMENT_BENCH_DEVICE = dataclasses.replace(
    SEGMENT_BENCH,
    cache=CacheParams(tier0_frac=0.10),
)

# the batched device-search knobs: the bench segment's Γ, paper σ, deep
# safety valve. DEVICE_SEARCH_WIDE adds the 2-wide fetch (fewer round
# trips, same recall). DEVICE_SEARCH_BATCH is the divergence-aware
# serving point: wide fetch + active-query compaction once the live
# fraction of the batch falls under 25% — cross-query block dedup is
# always on (it only moves DMAs into the dedup_saved counter).
DEVICE_SEARCH_BENCH = DeviceSearchParams(candidates=48, max_hops=256)
DEVICE_SEARCH_WIDE = dataclasses.replace(DEVICE_SEARCH_BENCH,
                                         fetch_width=2)
DEVICE_SEARCH_BATCH = dataclasses.replace(DEVICE_SEARCH_WIDE,
                                          compact_frac=0.25)

# the adaptive serving plane's repack control loop: evaluate
# every 4 served batches, fire only when >= 25% of the tier-0 pack
# would change (the hysteresis damper — below that a repack moves too
# few tiles to matter and the loop would churn), and leave a pack alone
# while it already absorbs >= 95% of block touches.
SERVE_REPACK = RepackParams(interval_batches=4, hysteresis=0.25,
                            min_observed=1, hit_rate_ceiling=0.95)

# the paper's full-size per-dataset index parameters (Tab. 16): used by
# the byte-accounting tests (γ, ε, ρ must reproduce Example 2 exactly)
PAPER_DATASETS = {
    # name: (n_vectors, dim, dtype_bytes, Λ, η_kb, ε, ρ)
    "bigann": (33_000_000, 128, 1, 31, 4, 16, 2_062_500),
    "deep": (11_000_000, 96, 4, 48, 4, 7, 1_571_429),
    "ssnpp": (16_000_000, 256, 1, 48, 4, 9, 1_777_778),
    "text2image": (5_000_000, 200, 4, 54, 4, 4, 1_250_000),
}
