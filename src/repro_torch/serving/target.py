"""The ``SegmentTarget`` protocol (port of ``repro.serving.target``):
one abstraction for everything the serving plane can point a query
batch at.

Host segments (``HostSegmentServer``), device segments
(``SegmentServer``) and mesh-routed segment groups
(``router.MeshQueryRouter``) are interchangeable behind this surface:
the ``QueryCoordinator`` scatters/merges over it, the
``RepackScheduler`` registers feeds/targets through it, and
``attach_shared_fetch_queue`` discovers cache-fronted stores with it —
none of them reach into concrete server attributes anymore.

The protocol has a small REQUIRED core and optional capability hooks:

  required   ``offset``, ``num_vectors``, ``search(queries, k)``
  stats      ``batch_stats()`` — the last served batch's device
             columns (``io``/``tier0_hits``/``hops``/``dedup_saved``/
             ``dedup_cross``/``spec_hits``/``spec_wasted`` arrays +
             scalar ``rounds``; the speculation columns are
             zero-filled by the adapter for targets that do not emit
             them), empty for targets without
             device telemetry; ``lifetime_stats()`` — lifetime
             counters (cache tiers, router ranks)
  range      ``range_search(queries, radius, k_cap)``
  repack     ``repack(observed, plan=None)`` + ``repack_source()``
             (the host ``Segment`` a tier-0 repack selects from; None
             means the target cannot be a repack target)
  io plane   ``demand_feed()`` — the ``CachedBlockStore`` whose
             ``block_freq`` feeds the repack scheduler (None if
             uncached/deviceless)
  obs        ``attach_obs(tracer, metrics)`` — wire the target (and
             whatever it owns) into the observability plane

Consumers MUST go through the module-level adapter functions
(``batch_stats(t)``, ``demand_feed(t)``, ...) rather than calling the
hooks directly: the adapters supply the documented default for targets
that implement only the required core (a duck-typed test fake, a
minimal remote proxy), so every optional capability degrades to "not
present" instead of ``AttributeError``.
"""
from __future__ import annotations

from typing import Dict, Optional, Protocol, Tuple, runtime_checkable

import numpy as np

# the batch_stats() keys a device-telemetry-bearing target must emit
# together — the exact columns ``IOStats.from_device_batch`` folds
# (``dedup_cross`` is the cross-tile subset of ``dedup_saved``;
# ``spec_hits``/``spec_wasted`` are the speculation outcome columns,
# zero whenever the target does not speculate; ``hot_tier_hits`` is the
# in-memory hot tier's per-query visit column, zero for targets with no
# hot tier attached)
BATCH_STAT_KEYS = ("io", "tier0_hits", "hops", "dedup_saved",
                   "dedup_cross", "rounds", "spec_hits", "spec_wasted",
                   "hot_tier_hits")

# keys the adapter zero-fills for a target that predates (or opts out
# of) speculation / hybrid hot-tier routing — a legacy 6-key emitter
# keeps working; the schema a CONSUMER sees is always the full
# BATCH_STAT_KEYS
_ZERO_DEFAULT_KEYS = ("spec_hits", "spec_wasted", "hot_tier_hits")


@runtime_checkable
class SegmentTarget(Protocol):
    """Structural type of a serving target (see module docstring)."""

    offset: int                   # base of the target's global id space
    num_vectors: int

    def search(self, queries: np.ndarray, k: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Serve a batch: ``(ids [Q, k], dists [Q, k], io [Q])`` with
        ids already in the target's global id space minus ``offset``
        (the coordinator adds ``offset`` when merging)."""
        ...

    # ---- optional capability hooks (use the module adapters) --------
    def batch_stats(self) -> Dict[str, object]: ...
    def lifetime_stats(self) -> Dict[str, float]: ...
    def repack_source(self): ...
    def repack(self, observed, plan=None) -> int: ...
    def demand_feed(self): ...
    def attach_obs(self, tracer, metrics) -> None: ...


def is_target(obj) -> bool:
    """Required-core check: anything searchable with an id-space
    offset serves as a ``SegmentTarget``."""
    return (hasattr(obj, "search") and hasattr(obj, "offset")
            and hasattr(obj, "num_vectors"))


# --------------------------------------------------- protocol adapters

def batch_stats(target) -> Dict[str, object]:
    """Device columns of the target's last served batch, or ``{}`` for
    targets without device telemetry. A non-empty dict carries every
    ``BATCH_STAT_KEYS`` entry (validated here so a half-implemented
    target fails loudly at the seam, not deep in a fold)."""
    fn = getattr(target, "batch_stats", None)
    stats = fn() if callable(fn) else {}
    if stats and any(k not in stats for k in _ZERO_DEFAULT_KEYS):
        # speculation columns default to zero arrays shaped like the
        # batch's io column: every consumer fold then sees the full
        # schema without caring whether the target speculates
        io = np.asarray(stats["io"]) if "io" in stats else np.zeros(0)
        stats = dict(stats)
        for k in _ZERO_DEFAULT_KEYS:
            stats.setdefault(k, np.zeros_like(io))
    if stats and any(k not in stats for k in BATCH_STAT_KEYS):
        missing = [k for k in BATCH_STAT_KEYS if k not in stats]
        raise ValueError(
            f"batch_stats() of {type(target).__name__} is missing "
            f"{missing} — device columns travel together")
    return stats


def lifetime_stats(target) -> Dict[str, float]:
    """Lifetime counters (cache tiers, rank loads); ``{}`` default."""
    fn = getattr(target, "lifetime_stats", None)
    return fn() if callable(fn) else {}


def repack_source(target):
    """The host ``Segment`` a tier-0 repack rebuilds from, or None —
    the scheduler's can-this-be-a-repack-target test."""
    fn = getattr(target, "repack_source", None)
    return fn() if callable(fn) else None


def demand_feed(target):
    """The target's cache-fronted ``CachedBlockStore`` (the repack
    scheduler's demand signal and the shared-queue attach point), or
    None for device-only / uncached targets."""
    fn = getattr(target, "demand_feed", None)
    return fn() if callable(fn) else None


def attach_obs(target, tracer, metrics) -> None:
    """Wire the target into the observability plane (no-op default)."""
    fn = getattr(target, "attach_obs", None)
    if callable(fn):
        fn(tracer, metrics)
