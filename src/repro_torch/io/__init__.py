"""repro_torch.io — the block cache and async batched-prefetch I/O
subsystem (port of ``repro.io``).

Caching, batching and async overlap never change which blocks the search
reads, only what each read costs (Eq. 4: T_io = #I/Os x t_block_io):

  * ``BlockCache`` / ``TieredBlockCache`` (``cache.py``) — a
    byte-budgeted resident set of block ids with LRU/LFU eviction and
    static pinning of the build-time hot set; tier 2 holds compressed
    PQ-space block summaries. The budget is charged into Eq. 10 as
    C_cache (``SegmentParams.cache``).
  * ``CachedBlockStore`` (``cached_store.py``) — drop-in for
    ``BlockStore.read_block`` that accounts cache hits, tier-2 hits,
    misses and round trips into ``IOStats``.
  * ``hotset`` — the tier-shared hot-set ranking: host tier-1 pinning
    and the device tier-0 hot-tile pack select prefixes of one ranking.
  * ``PrefetchEngine`` (``prefetch.py``) — speculative fetches of the
    blocks of the top unvisited candidates.
  * ``AsyncFetchQueue`` (``async_fetch.py``) — event-clock model of
    in-flight fetches with completion-order delivery and in-flight
    joins across queries.
"""
from repro_torch.io.async_fetch import AsyncFetchQueue, FetchTicket
from repro_torch.io.cache import (BlockCache, EvictionPolicy, LFUPolicy,
                                  LRUPolicy, TieredBlockCache)
from repro_torch.io.cached_store import (CachedBlockStore, cached_view,
                                         make_cached_store)
from repro_torch.io.hotset import (fill_to, hot_block_pin_set,
                                   hot_block_ranking,
                                   repack_from_frequencies, view_seed_ids)
from repro_torch.io.prefetch import PrefetchEngine

__all__ = [
    "AsyncFetchQueue", "FetchTicket",
    "BlockCache", "TieredBlockCache", "EvictionPolicy", "LRUPolicy",
    "LFUPolicy", "hot_block_pin_set", "hot_block_ranking", "fill_to",
    "repack_from_frequencies", "view_seed_ids", "CachedBlockStore",
    "cached_view", "make_cached_store", "PrefetchEngine",
]
