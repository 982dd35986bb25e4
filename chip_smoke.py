#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # one CUDA card; exits non-zero without

It drives the port's paths — the segment build
(``core.segment.build_segment``), the batched device search as
``SegmentServer.search`` serves it, the range search, the online tier-0
repack, the hybrid hot tier with inserts and tombstones, the serving
plane (the cache-fronted host block search, the coordinator, the request
batcher and the repack scheduler), the build variants (the k-means
packer, HNSW, BNS), the DiskANN-style baseline, the delta segment
with its compaction and serving swaps, the observability plane (spans,
metrics, the Chrome trace, a ``CostModel`` fitted to the card), the
mesh router over four segments on eight ranks of the card and the
multi-rank search step on a one-rank NCCL group — on a
1,000,000 x 128 segment built from seeded clustered vectors, then the
language models' serving and training paths at full size, and checks
them:

  1. card: name and power limit (``nvidia-smi``);
  2. build kernels: compiles every source of ``kernels/csrc`` (one
     ``nvcc`` each, all started together);
  3. segment: ``build_segment`` with the bench segment's knobs (Λ=24,
     BNF β=8 τ=0.001, PQ M=8, NSG navigation graph on a 10% sample, 10%
     tier-0 pack) and an NSG disk graph — the one reduction: Vamana's
     sequential insertion does not fit the run at 1M. Prints the stage
     times, the kNN's share, the connectivity fix's attachments, OR(G)
     after BNP and each BNF round, and Eq. 10's memory and disk bytes
     against the 2 GB / 10 GB budget; checks the layout, reachability,
     degrees and self-loops; the build must launch ``l2_tile``, and its
     launches and operations are printed by the build function they ran
     in (the kNN, the connectivity fix's host search, the beam search's
     entry distance, the navigation graph);
  4. vamana: ``build_vamana`` at 25,000 x 128 with the same knobs: time,
     average degree, OR(G) after BNF, reachability;
  5. kernels: each CUDA kernel against its plain PyTorch version — the
     round kernels on the inputs of a real first round of a 1,024-query
     batch (integer outputs equal, distances within atol 1e-4 / rtol
     1e-5, the order equal to a stable argsort of the kernel's own
     selection key), and ``gather_union`` also on the first round of a
     4,096-query batch (R = 8,192, past the first port's 4,096-slot
     union); ``l2_tile`` on the build's kNN chunk, 2,048 of the
     vectors x all 1M (atol 1e-2 / rtol 1e-5), and the kNN ids of 4,096
     sampled vertices in such chunks; ``pq_adc`` on the segment's codes x
     a 1,024-query batch's LUTs, and at the host search's 1 query x 64
     codes (equal: the same f32 order); ``tier0_fetch_rank`` on the
     first round's queries, target blocks, the 10% tier-0 pack and the
     cold store, and at 128 queries x 16 seeded target blocks (hit
     equal, atol 1e-4 / rtol 1e-5); ``block_topk`` on
     the tiles of that round at top_m = n_expand and at the kernel
     micro-bench's [128, 16, 128], m = 5 (atol 1e-3 / rtol 1e-5, the
     slots the stable order of its own distances) — each timed with CUDA
     events next to its plain version and one library call where one
     computes the same function (``torch.unique``, three
     ``index_select``, ``torch.cdist``, ``embedding_bag``); on live rows
     ``fused_round_rank``'s distances equal ``tier0_fetch_rank``'s bit
     for bit; every kernel's share of its bound is printed, and each must
     lie in (0, 1]; the timing's floor (an empty launch) and the round
     kernels' times with their inputs in L2 are printed; with
     ``--against`` other copies of ``tier0_fetch.cu``, ``pq_adc.cu`` or
     ``block_topk.cu`` (an earlier commit's, variants; the file name
     starts with the source's) are built beside this one, their
     kernels must give the same bits on the same inputs (``block_topk``
     and ``tier0_fetch_rank`` at both shapes, ``pq_adc`` at both), and
     each is timed in turns with this one (other, this, this, other),
     with the L2 flushed and then with the inputs left in it;
  6. serve: one warm-up batch, then 8 batches of 1,024 queries, k=10,
     with recall@10 against the brute-force oracle (``distances.
     brute_force_knn``, through ``l2_tile``; its ids equal the plain
     oracle's on the check batch) and the launch counts (which must
     follow the rounds); each batch's ``batch_stats`` folded into one
     ``IOStats`` (``core.iostats.IOStats.from_device_batch``, as the
     JAX package's scheduler folds them) and the 8 folds merged; then
     one batch on the two-pass union path (``fuse_union=False``, which
     runs ``gather_unique``), and the first batch again with
     ``trace_rounds``: its ids and fold equal the untraced run's, and its
     round log (``obs.roundlog.fold_round_log``) ties to the fold:
     ``sum(live) == hops``, ``sum(cold) == io``, ``sum(tier0) ==
     tier0_hits``, ``sum(joins) == dedup_saved``, ``sum(joins_x) ==
     dedup_cross``, the spec columns to theirs, the records to
     ``batch_rounds`` and ``sum(live) / rounds`` to
     ``rounds_active_weight``;
  7. kernel path against plain path: one batch with ``fetch_impl="ref"``
     (recall within ±0.01 of the kernel path);
  8. profile: one batch under ``torch.profiler`` — device busy time, the
     idle share of the batch, the ops that take the device time;
  9. range: ``device_range_search`` on 2 batches of 1,024 queries at
     the served knobs, 3 rounds, k_cap 256 (Γ 64 -> 128 -> 256), radius
     the median 10th-NN distance by the ``l2_tile`` oracle; every
     in-range id within the radius at its exact distance, recall of the
     in-range sets against ``distances.brute_force_range`` (printed),
     ``io`` below three from-scratch searches at Γ 64/128/256, launches
     following the rounds;
 10. repack: ``SegmentServer(host=...).repack`` with the per-block
     demand of the served results; ``changed`` > 0, the same ids and
     distances before and after, ``io + tier0_hits`` equal per query,
     the new pack exact copies of its blocks;
 11. hybrid: ``build_hot_tier`` (10% = 100,000 vectors, NSG of degree
     16), 4 batches through a hybrid server beside the plain one
     (recall@10, batch ms, ``hot_tier_hits``), then 256 inserts and
     1% of the base ids tombstoned in both tiers, served again: no
     tombstoned id returned; 64 inserted vectors as queries, each that
     the hot route reaches first at distance 0 (the share printed);
 12. large batch: one batch of 4,096 queries (R = 8,192 union slots a
     round) through ``SegmentServer.search``, its ids equal to the same
     batch's at ``fetch_impl="ref"``, its launches following the rounds;
 13. serving plane: the host block search (``core.search.anns`` behind
     ``HostSegmentServer``) on 256 queries of a fourth seeded set, with
     ``SEGMENT_BENCH_CACHED``'s cache (10% of the block file, LRU, a
     quarter pinned, prefetch width 4) and with ``SEGMENT_BENCH_ASYNC``'s
     tiered cache and an 8-deep queue shared through
     ``attach_shared_fetch_queue``: recall@10, block reads, round trips,
     hit rate, ms per query and ``pq_adc``'s launches (its routing keys);
     64 of the queries on the card and at ``device="cpu"`` (the plain
     ``pq_adc``), each from a cold cache: ids, dists and every
     ``IOStats`` field equal; 32 under ``torch.profiler`` (the device's
     idle share of the host search); ``pq_adc`` timed at the served
     [1 x 72];
     then 4,096 single requests near vertices of blocks the build-time
     pack left cold, through a ``RequestBatcher(dim=128, buckets=(256,
     1024))`` into a ``QueryCoordinator`` over the device server, with a
     ``RepackScheduler(SERVE_REPACK)`` fed by a cached host store that
     serves the first 256 requests of each batch: every batch's stats
     dict (its totals equal
     to the server's ``batch_stats`` columns), every decision, the batch
     median; a repack must fire at its interval, and the batch before it
     served again after it returns the same ids and dists with more
     ``total_tier0_hits`` and fewer ``total_block_reads``;
 14. build variants: the k-means packer (``layout.layout_kmeans``,
     k = ρ/4 centroids, 8 Lloyd steps, the assignment through
     ``l2_tile`` in row chunks) on phase 3's 1M graph — seconds,
     ``l2_tile``'s launches (one a chunk a step), OR(G) beside BNP's and
     BNF's, the layout a bijection; HNSW (``graph.build_hnsw``) on the
     first 10,000 vectors — level sizes (never increasing), each layer's
     degrees and reachability, ``build_segment(algo="hnsw",
     shuffle="bnf")`` (its disk graph HNSW's base layer) and 256 host
     queries (recall@10, block reads), ``navgraph.from_hnsw_layers``
     (its entry points sample ids); BNS at App. F's 1,200 vectors (BNF
     with β = 8, then one BNS round): both OR(G)s and seconds, OR never
     falling across BNS's history (Lemma 4.2);
 15. DiskANN baseline: an ID-contiguous segment on phase 3's graph;
     ``baseline.vertex_anns`` on phase 13's 256 queries at Γ = 48, with
     and without ``build_hot_cache(ratio=0.05)``, beside Starling's
     uncached ``anns``: recall@10, block reads, hops, vertex
     utilisation, ms per query, ``pq_adc``'s launches (at most one a
     hop); the hot cache changes no result and raises no query's reads;
     64 queries equal their ``device="cpu"`` run in ids, dists and every
     ``IOStats`` field; ``vertex_range_search`` against ``range_search``
     on 8 queries at phase 9's radius (block reads); the paper's claim
     that the block search reads fewer blocks printed, not bounded;
 16. delta segment: ``DeltaSegment.wrap`` (a 10% hot tier), 256 inserts,
     1% of the base ids and 16 inserted ones deleted, ``search`` on 256
     queries (recall@10 against the live set's brute force, block reads,
     ``hot_tier_hits``; no deleted id returned), 64 inserted vectors
     queried back, 64 queries against the ``device="cpu"`` run (ids and
     ``IOStats`` equal, distances within rtol 1e-5); then ``compact()``
     of a second delta over a segment of the first 100,000 vectors (64
     inserts, 1% of its base and every 16th insert deleted: stage times;
     the live count, reachability, no deleted gid);
     ``swap_into_device_server`` under a ``RepackScheduler`` whose
     window held entries past the new block count (dropped), one 1,024
     batch served on the compacted segment (no deleted id, recall@10,
     the round kernels' launches following the rounds);
     ``swap_into_host_server``, whose 64 queries equal ``anns`` on the
     compacted view;
 17. observability: phase 13's serving plane (the coordinator over the
     device server at ``trace_rounds``, its ``RepackScheduler`` fed by a
     cached host server) and phase 11's hybrid server, wired to a
     ``Tracer(WallClock())`` and a ``MetricsRegistry`` through
     ``QueryCoordinator(tracer=, metrics=)`` and ``attach_obs``: 4
     batches of 1,024 (each after 64 host-feed queries) and a hybrid
     batch, then the same on a fresh plane untraced — ids, dists, stats
     dicts, device columns, host results and ``IOStats``, cache and
     scheduler counters equal; the event count and ``dropped``; every ``STATS_SCHEMA`` total equal
     to the registry's ``snapshot()``, the ``io.*`` gauges to
     ``cache_stats()``; ``calibrate(TPU_HBM_SEGMENT, ...)`` fitted to
     this card's wall clock on batches of 128 to 4,096 queries (the
     fitted constants, ``unfit``, the error before and after, each batch
     measured and modeled, and the fit of ``t_round`` alone; the preset
     written to a temporary directory, ``results/`` untouched); the
     round logs as modeled ``device.round`` slices (``timeline_from_
     round_log`` under the fitted model, ``dma_track``) and
     ``write_chrome_trace`` to the temporary directory, where
     ``validate_chrome_trace`` returns ``[]``; the hooks' cost: 8 pairs
     of one batch on the untraced and one on the traced plane, the order
     alternating from pair to pair, the two medians and the median of
     the paired differences with its interquartile range (unresolved
     where that range holds 0);
 18. mesh router: the vectors split in id order into 4 segments of
     250,000 (the cut of scale: the paper's segments hold 1M), each an
     NSG build at global offsets 0, 250k, 500k, 750k, served as
     ``SegmentServer``s behind ``MeshQueryRouter`` on 8 ranks of the card
     (``launch.mesh.make_debug_mesh(1, 8)``, ``RouterParams(
     window_batches=8, rebalance_interval=4, min_window=2,
     skew_threshold=1.2)``): phase 6's batches 1-2 routed, each
     bit-identical to ``merge_topk`` over the four servers' own
     ``search`` (recall@10 against phase 6's brute force beside the 1M
     segment's); then a placement planned for segment-0-heavy traffic
     (``elastic.plan_placement([5, 1, 1, 1], 8)``) and 6 batches of
     queries near segment 0: the evaluation at batch 4 must fire, the
     one at batch 8 plan zero moves, and batch 4 served again give the
     same ids and dists. The placement alone fires the rebalance: every
     rank searches the whole batch, so queries near segment 0 do not
     raise its ranks' loads, while each of its 4 replicas owns a quarter
     of the rows; the check exercises the replica slices, the windowed
     loads and the restack, not a rebalance driven by the traffic.
     Every routed batch ``merge_ranks(per_rank) == total``, and the
     round kernels' launches equal to the rounds of one search a
     distinct segment (its replicas share it); one batch through a ``QueryCoordinator`` over the router;
     the routed median and ``per_rank_modeled_us`` (a ``CostModel``
     figure, not a time of the card);
 19. search step: a one-rank NCCL group (a ``file://`` store in a
     temporary directory, ``device_id`` the card; gloo in the CPU
     rehearsal) and a (1, 1) ("data", "model") ``DeviceMesh``;
     ``make_search_step``'s specs at JAX's production defaults on a
     16 x 16 layout, each rank's bytes printed from them (not
     allocated); ``fn`` on phase 3's segment as a ``[1, ...]`` stack with
     phase 12's 4,096 queries at the step's default search (Γ = 64, 128
     hops): gid, dists and the seven per-rank columns equal the direct
     ``device_anns`` bit for bit, and the round kernels' launches equal
     its rounds (the cut of scale: 1M vectors a rank at ε = 6, where the
     spec sizes 2M at BIGANN's ε = 16); ``compressed_psum`` over the
     group equals the plain formula on the card bit for bit; ``shard``
     returns a CUDA ``DTensor`` with ``logical_spec``'s placements; the
     step's and the direct search's medians over 4 alternating pairs,
     then ``device_anns`` on the stack's own views against the direct
     one (the segment's memory apart from the step's work);
 20. lm serve: ``launch.serve``'s prefill and decode step on
     ``gemma3-1b`` (8 x 2,048 tokens on a cache of 2,112: the blockwise
     attention, 2,048 x 2,112 scores a head past 2^21, each of the two
     prefills' 26 blockwise calls counted; 5:1 sliding and global layers),
     ``zamba2-1.2b`` and ``rwkv6-1.6b`` (8 x
     512 each) at their full published size, depth included, with seeded
     weights (``lm.init_params`` on the card, cast to bf16 once): 32
     greedy decode steps on a bf16 cache, logits finite, tokens under the
     vocabulary; prefill ms and tokens/s, the decode's median ms a step
     against its weight-read bound, peak memory. The same 32 steps again
     in f32 on the f32 master weights (an f32 cache, fed the bf16 run's
     tokens) must match the teacher-forced f32 ``forward`` within
     ``tests/test_models.py``'s bound (0.05 x scale + 0.05; zamba2's 544
     tokens at a Mamba2 chunk of 32, which divides them). The bf16
     decode's distance from the bf16 forward is printed, not held: at
     full depth the two orders' rounding differences grow through the
     recurrent trunks past that bound. Then each model cut to 2 layers
     (zamba2: 7, one group with its shared attention and a tail layer)
     at f32 on the card against the same weights on the CPU over 2 x 64
     tokens (1e-4 x scale + 1e-5); every smoke architecture's decode
     against its forward on the card (the bound above). No kernel of
     ``kernels/csrc`` runs here (``models/*`` has no ``pallas_call``):
     its launches row is empty. The teacher-forced forward unembeds only
     the compared rows, and one set of logits is alive at a time;
 21. lm train: ``launch.train.make_train_step`` (``optim.adamw``, the
     gradient accumulation, remat) on ``data.pipeline.TokenPipeline``
     batches at full size, depth included, seeded weights: ``gemma3-1b``
     8 x 2,048 tokens (2 microbatches; the blockwise attention's forward
     and backward, ``_chunked_ce`` in 32 checkpointed chunks of the
     262,144 vocabulary), ``zamba2-1.2b`` and ``rwkv6-1.6b`` 8 x 1,024 (4
     microbatches; 8 SSD chunks a layer; 64 WKV chunks, in groups of 8
     under checkpoints inside each layer's): a warm-up step, 4 timed and
     one profiled (wall, device
     busy, idle share, launches); loss and ``grad_norm`` finite at every
     step, every parameter finite, some changed, the optimizer's step
     equal to the steps taken; median ms, tokens/s, the model-FLOP rate
     6·N·tokens/s against the dense bf16 peak, peak memory. Then each
     model cut to 2 layers (zamba2 7) at full width in f32, one step on 2
     x 64 tokens on the card against the same weights and batch on the
     CPU: loss within 1e-5 and ``grad_norm`` within 1e-4 relative, every
     gradient leaf (``grads_of``) within 1e-3 of its largest |g|, every
     updated parameter within 2 x lr + 2e-6 (Adam's first step moves an
     element by about sign(g) x lr). The restart: gemma3-1b at full width
     and 2 layers, 8 x 128, under ``torch.use_deterministic_algorithms``
     (``CUBLAS_WORKSPACE_CONFIG`` set before torch starts): 6 steps
     straight against 3, ``ft.CheckpointManager.save`` to a temporary
     directory, a restore into fresh trees, ``set_state`` and 3 more; the
     restored tensors equal the saved ones and the resumed run the
     straight one, bit for bit. Last, ``python -m
     repro_torch.launch.train --arch gemma3-1b --smoke --steps 60 --batch
     8 --seq 128`` in a subprocess: exit 0, the loss at step 59 at least
     0.1 under step 0's, checkpoints 20, 40, 60 kept; then ``--resume
     --steps 80`` prints "resumed from step 60". No kernel of
     ``kernels/csrc`` runs here either;
 22. lm mesh: the LM under ``use_rules`` on a one-rank (1, 1) ("data",
     "model") ``DeviceMesh`` of a one-rank NCCL group (opened and
     destroyed here, as phase 19's): ``moonshot-v1-16b-a3b`` at its full
     ``CONFIG`` with bf16 weights (48 layers, 64 experts top-6, 2
     shared; ~53.8 GiB, drawn in bf16, no f32 copy of any leaf), laid out
     by their specs as DTensors (a rank's shard is the whole tensor),
     a prefill of 8 x 512 tokens and 16 greedy bf16 decode steps, each
     forward through ``_capacity_dispatch_ep`` once a layer (the calls
     counted: 48 a forward); prefill ms and tokens/s, the median decode
     ms, peak memory and one profiled decode step (idle share,
     launches); the same without the mesh on the same weights (no EP
     call). Then at full width and 4 layers under
     ``torch.use_deterministic_algorithms``: the meshed prefill logits
     and 4 decode tokens equal the plain run's bit for bit; 2-layer f32
     copies of moonshot, ``gemma3-1b`` and ``rwkv6-1.6b`` under the mesh
     on the card against the plain forward on the CPU (1e-4 x scale +
     1e-5). Beside all that, three ``python -m repro_torch.launch.dryrun``
     children (a fake group of 256 or 512 ranks cannot share this
     process's): gemma3-1b decode_32k on both production meshes,
     moonshot decode_32k on the single-pod one, and ``--starling``; every
     record must be ``OK`` and each child exit 0 within its timeout; a
     rank's bytes, FLOPs, collective bytes and dominant term printed. No
     kernel of ``kernels/csrc`` runs here;
 23. examples: the four scripts of ``examples_torch`` in this process
     through their ``main`` or stages, so their launches are counted
     (a window each): ``quickstart`` (its card-built segment's ``anns``
     and baseline equal the same stage at ``device="cpu"`` in ids and
     every ``IOStats`` field), ``serve_segments`` (each batch's ids and
     stats dict equal the same coordinator's at ``fetch_impl="ref"``,
     dists within atol 1e-4 / rtol 1e-5), ``rag_serving`` at gemma3-1b's
     smoke configuration (each retrieval's ids, ``io`` and
     ``tier0_hits`` equal ``fetch_impl="ref"``'s on the same queries)
     and ``train_resume.run`` at its defaults (rwkv6's smoke
     configuration, 24 steps, the crash at 12: the resumed run equals 24
     straight steps bit for bit under deterministic algorithms; JAX's
     check ``losses[-1] < losses[0]`` is printed, not held: JAX's own
     example fails it). Then the RAG bridge at gemma3-1b's full
     ``CONFIG`` (26 layers, d_model 1,152, vocabulary 262,144) over
     ``clustered_vectors(100,000, 1,152)`` indexed at η = 16 KB (ε = 3:
     a 4,708 B vertex does not fit 4 KB) with an NSG disk graph: the
     build's seconds by stage, OR(G), ε, ρ, the tier-0 bytes, the
     example's loop (2 x 8 prompt tokens, 12 generated, a retrieval
     every 4) with each retrieval held to ``fetch_impl="ref"`` as above,
     prefill and decode ms, peak memory; 64 ``query_set`` queries drawn
     from the corpus through the same search and a wider one (Γ 128, 256
     hops; their own window), held the same way; ``l2_tile`` at
     d = 1,152 against ``pairwise_l2_ref`` on 4,096 sampled rows x the
     corpus (phase 5's atol / rtol plus 4
     sqrt(d) u (|q|^2 + |x|^2), the norm expansion's f32 rounding; the
     kNN ids equal where the k-th gap clears the bound) and both against
     float64; recall@4 of both query sets against the plain brute force
     on the CPU (these comparisons not counted); then
     ``train_resume.run`` at rwkv6-1.6b's published widths cut to 2
     layers, held bit for bit as above, with its step ms and
     its checkpoints' seconds and bytes;
 24. summary: the launches of every kernel by phase (the build, Vamana,
     each window of phases 6-23; phase 5's comparisons and the CPU
     comparisons and timings of phases 13, 15 and 16 are not counted)
     and in total; one JSON line of the kernels with the totals, the card
     line, and last ``{"ok": true, "device": {...}}``.

Every served batch is checked: 10 distinct ids per query with ascending
distances, each the exact distance of its id. recall@10 is printed, not
bounded.

Any failed check exits non-zero, and so does a run without a CUDA card
or from a directory without the port's package (``src/repro_torch``)
beside the script. ``--device cpu --n 20000`` rehearses the whole script
on the CPU with the plain versions (for rehearsal only; its Vamana phase
then builds n/4 vectors, its HNSW n/2, and phase 20 serves the smoke
configurations of the three models, 2 x 128 tokens, without the
card-against-CPU check; phase 21 trains them, with the full
configurations' remat and accumulation, on 4 x 128 tokens, and holds the
CPU against itself; phase 22 serves moonshot's smoke configuration on a
one-rank gloo group, its f32 checks against the CPU itself; phase 23
runs the four examples at their sizes and the RAG bridge and the resume
at the smoke widths).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import datetime
import json
import math
import os
import subprocess
import sys
import tempfile
import time

# cuBLAS fixes its workspace layout when torch first creates a handle;
# phase 21's restart runs under torch.use_deterministic_algorithms, which
# needs a fixed one
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

# the examples' helpers: nvidia-smi's name and power limit, a device sync
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "examples_torch"))
try:
    from _card import device_line, sync  # noqa: E402
except ImportError:                  # not a checkout: main() says so
    device_line = sync = None

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (data sheet)
F32_OPS_PER_S = 67e12           # H100 SXM f32 outside the tensor cores
DIM, BATCH, BATCHES = 128, 1024, 8   # SIFT1M width; 8 batches of 1,024
VAMANA_N = 25_000                    # the Vamana phase's size on the card
KNN_ROWS = 4096                      # sampled vertices of the kNN check
KNN_CHUNK = 2048                     # distances.knn_graph's row chunk
L2_ATOL, L2_RTOL = 1e-2, 1e-5        # f32 order, squared norms ~1e4
ITERS = 50                           # launches per kernel timing
SPIN_CYCLES = 2_000_000              # ~1 ms of card clock before each one
RANGE_BATCHES, HYBRID_BATCHES = 2, 4 # batches of the range and hybrid
BIG_BATCH = 4096                     # the large batch: R = 8,192 at F = 2
INSERT_POOL = 1024                   # seeded vectors phases 11 and 16 insert
INSERTS, SELF_QUERIES = 256, 64      # hybrid inserts; those queried back
CSRC = "src/repro_torch/kernels/csrc/"
KERNELS = {  # name: (source, the TPU kernel it replaces)
    "gather_union": ("tier0_fetch.cu",
                     "src/repro/kernels/tier0_fetch.py:257"),
    "fused_round_rank": ("tier0_fetch.cu",
                         "src/repro/kernels/tier0_fetch.py:401"),
    "gather_unique": ("tier0_fetch.cu",
                      "src/repro/kernels/tier0_fetch.py:167"),
    "l2_tile": ("l2_tile.cu", "src/repro/kernels/l2_tile.py:43"),
    "pq_adc": ("pq_adc.cu", "src/repro/kernels/pq_adc.py:48"),
    "tier0_fetch_rank": ("tier0_fetch.cu",
                         "src/repro/kernels/tier0_fetch.py:444"),
    "block_topk": ("block_topk.cu", "src/repro/kernels/block_topk.py:51"),
}
ADC_HOST = 64          # the host search's ADC call: 1 query x 64 codes
HOST_QUERIES, HOST_CHECK = 256, 64   # phase 13's host search; on the CPU
HOST_PROFILE = 32                    # phase 13's profiled host queries
STREAM = 4096                        # phase 13's single requests
FEED_QUERIES = 256                   # of each batch, served by the feed
WIDE_Q, WIDE_F = 128, 16   # tier0_fetch_rank's wide shape: F·ε = 96 slots
KMEANS_ITERS = 8                     # phase 14: the k-means packer's steps
HNSW_N = 10_000                      # phase 14: HNSW's size on the card
BNS_N, BNF_ITERS = 1200, 8           # phase 14: App. F's BNS size and β
BASE_CHECK, BASE_RANGE = 64, 8       # phase 15: CPU check; range queries
DELTA_INSERTS, DELTA_DEAD_INSERTS = 256, 16   # phase 16's delta
DELTA_SELF, DELTA_CHECK = 64, 64     # phase 16: queried back; CPU check
COMPACT_N, COMPACT_INSERTS = 100_000, 64   # phase 16: the compaction's delta
OBS_BATCHES, OBS_FEED = 4, 64        # phase 17: traced batches; host feed
OBS_PAIRS = 8                        # phase 17: traced/untraced timing pairs
CALIB_SIZES = (128, 256, 512, 1024, 2048, 4096)   # phase 17's fit
CALIB_REPEATS = 2                    # batches of each size in the fit
MESH_SEGMENTS, MESH_RANKS = 4, 8     # phase 18: JAX's mesh_bench layout
MESH_UNIFORM, MESH_SKEWED = 2, 6     # phase 18: phase 6's batches; skewed
STEP_PAIRS = 4                       # phase 19: step/direct timing pairs
LM_PROMPTS = {"gemma3-1b": 2048,     # phase 20: the served models at full
              "zamba2-1.2b": 512,    # size and their prompt lengths (a
              "rwkv6-1.6b": 512}     # multiple of Mamba2's 128, RWKV's 16)
LM_BATCH, LM_DECODE = 8, 32          # phase 20: prompts; decode steps
LM_CHECK_TOKENS = 64                 # phases 20-21: card against CPU, f32
LM_TRAIN = {"gemma3-1b": 2048,       # phase 21: the trained models at full
            "zamba2-1.2b": 1024,     # size and their sequence lengths, 8
            "rwkv6-1.6b": 1024}      # sequences a step
LM_TRAIN_STEPS = 4                   # phase 21: timed steps after a warm-up
RESTART_STEPS = 3                    # phase 21: steps before and after
ENTRY_STEPS, ENTRY_RESUME = 60, 80   # phase 21: launch.train run, resume
BF16_OPS_PER_S = 989e12              # H100 SXM dense bf16 (data sheet)
MESH_ARCH = "moonshot-v1-16b-a3b"    # phase 22: the MoE served on a mesh
MESH_PROMPT, MESH_DECODE = 512, 16   # phase 22: 8 x 512 prompts; steps
MESH_EQ_LAYERS = 4                   # phase 22: meshed = plain, bit for bit
MESH_F32 = ("moonshot-v1-16b-a3b", "gemma3-1b", "rwkv6-1.6b")  # 2 layers
DRYRUN_CELLS = (("--arch", "gemma3-1b", "--shape", "decode_32k", "--mesh",
                 "both"),
                ("--arch", "moonshot-v1-16b-a3b", "--shape", "decode_32k",
                 "--mesh", "single"),
                ("--starling",))
DRYRUN_TIMEOUT_S = 400               # each dry-run child
EX_STEPS, EX_CRASH = 24, 12          # phase 23: train_resume's defaults
EX_GEN, EX_EVERY = 12, 4             # phase 23: rag_serving's defaults
EX_RAG_N = 100_000                   # phase 23: the full-width corpus
EX_RAG_BLOCK_KB = 16.0               # phase 23: ε = 3 at d_model 1,152
EX_TRAIN_LAYERS = 2                  # phase 23: rwkv6-1.6b's depth cut
EX_RAG_QUERIES = 64                  # phase 23: queries from the corpus
EX_RAG_WIDE = 128, 256               # phase 23: their wider beam, hops
L2_ROUND = 4                         # phase 23: x sqrt(d) u (|q|^2 + |x|^2)


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


@contextlib.contextmanager
def phase(name: str):
    print(f"== {name}", flush=True)
    t0 = time.perf_counter()
    yield
    print(f"== {name}: {time.perf_counter() - t0:.3f} s", flush=True)


def time_ms(fn, device, iters: int, flush=None) -> float:
    """Mean ms of ``fn()``: CUDA events around each call, with the L2
    flushed before each (the round's blocks are cold in L2 when the
    search asks for them) and the card kept busy (``torch.cuda._sleep``)
    while the host enqueues the call, so a call whose device work is
    shorter than its host path reads its device time; host clock on the
    CPU."""
    for _ in range(3):
        fn()
    sync(device)
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    pairs = []
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        pairs.append((e0, e1))
    torch.cuda.synchronize(device)
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def fold_batch(bs: dict, iostats):
    """One served batch's ``batch_stats`` folded into one ``IOStats``
    (``iostats``: the port's ``core.iostats`` module), as the JAX
    package's ``RepackScheduler.note_batch`` folds a target's columns."""
    return iostats.IOStats.from_device_batch(
        bs["io"], bs["tier0_hits"], bs["hops"], bs["dedup_saved"],
        bs["rounds"], bs["dedup_cross"], bs["dma_pipelined"],
        bs["spec_hits"], bs["spec_wasted"], bs["dma_speculative"],
        bs["hot_tier_hits"])


def recall(pred: np.ndarray, truth: np.ndarray) -> float:
    hits = sum(len(set(p[p >= 0].tolist()) & set(t.tolist()))
               for p, t in zip(pred, truth))
    return hits / truth.size


def reachable(adj: np.ndarray, deg: np.ndarray, entry: int) -> np.ndarray:
    """Vertices reachable from ``entry``: scipy's breadth-first order on
    the sparse adjacency, a check independent of the build's own."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import breadth_first_order
    n = adj.shape[0]
    live = np.arange(adj.shape[1])[None, :] < deg[:, None]
    rows = np.repeat(np.arange(n), live.sum(1))
    a = csr_matrix((np.ones(rows.size, np.int8), (rows, adj[live])),
                   shape=(n, n))
    seen = np.zeros(n, bool)
    seen[breadth_first_order(a, entry, directed=True,
                             return_predecessors=False)] = True
    return seen


def check_graph(g, what: str) -> None:
    """Degrees within Λ, ids in range, no self-loops, every vertex
    reachable from the entry."""
    n, lam = g.adj.shape
    live = np.arange(lam)[None, :] < g.deg[:, None]
    check(bool((g.deg >= 0).all() and (g.deg <= lam).all()),
          f"{what}: a degree exceeds Λ={lam}")
    check(bool(((g.adj >= 0) & (g.adj < n))[live].all()),
          f"{what}: an edge leaves the id range")
    check(not bool((g.adj == np.arange(n)[:, None])[live].any()),
          f"{what}: a self-loop")
    check(bool(reachable(g.adj, g.deg, g.entry).all()),
          f"{what}: a vertex is unreachable from the entry")


@contextlib.contextmanager
def l2_tile_by_call_site(tally: dict, l2, ops, sites):
    """File every ``l2_tile`` launch made inside the block under the
    nesting of the build functions ``sites`` ((module, name) pairs) it
    ran in: ``tally[path] = [launches, operations, {(Q, N): launches}]``.
    The functions are wrapped for the block's span and then restored."""
    stack, saved = [], [(m, n, getattr(m, n)) for m, n in sites]
    pairwise_l2 = ops.pairwise_l2

    def nest(name, fn):
        def call(*a, **kw):
            stack.append(name)
            try:
                return fn(*a, **kw)
            finally:
                stack.pop()
        return call

    def counted(q, x, *a, **kw):
        n0, o0 = l2.LAUNCHES["l2_tile"], l2.OPS["l2_tile"]
        out = pairwise_l2(q, x, *a, **kw)
        t = tally.setdefault("/".join(stack) or "elsewhere", [0, 0, {}])
        dn = l2.LAUNCHES["l2_tile"] - n0
        t[0] += dn
        t[1] += l2.OPS["l2_tile"] - o0
        shape = (q.shape[0], x.shape[0])
        t[2][shape] = t[2].get(shape, 0) + dn
        return out

    for m, n, fn in saved:
        setattr(m, n, nest(n, fn))
    ops.pairwise_l2 = counted
    try:
        yield
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)
        ops.pairwise_l2 = pairwise_l2


def lm_serve(device, on_card: bool, card: str, seed: int) -> None:
    """Phase 20: the LM serving path (``launch.serve`` over ``models/lm``)
    at full size on the card; see the module docstring."""
    from repro_torch.configs import CONFIGS, SMOKE_CONFIGS
    from repro_torch.launch.serve import make_prefill, make_serve_step
    from repro_torch.models import layers as LY
    from repro_torch.models import lm as LM

    def bound(ref, got, f32):
        """(max |diff|, the bound): f32 1e-4 x scale + 1e-5, bf16 0.05 x
        scale + 0.05 (``tests/test_models.py``)."""
        ref, got = ref.float(), got.float().to(ref.device)
        scale = float(ref.abs().max())
        return (float((ref - got).abs().max()),
                1e-4 * scale + 1e-5 if f32 else 0.05 * scale + 0.05)

    def nbytes(tree):
        return sum(t.numel() * t.element_size()
                   for t in _leaves(tree))

    def vocab(cfg, t):
        return t[..., :cfg.vocab_size]          # padded columns: -1e30

    def decode(cfg, params, prompt, max_len, cache_dtype, feed=None):
        """``launch.serve``'s prefill (twice: the first call warms up; a
        cache in another dtype than its bf16 through ``lm.prefill``), then
        ``LM_DECODE`` steps, greedy or fed ``feed``'s tokens: prefill
        ms, step ms, the last prefill row and the steps' logits, the fed
        tokens, the last greedy token, the cache's bytes."""
        prefill = (make_prefill(cfg, max_len) if cache_dtype == torch.bfloat16
                   else lambda p, b: LM.prefill(cfg, p, b["tokens"], max_len,
                                                cache_dtype=cache_dtype))
        serve = make_serve_step(cfg)
        pre_ms = []
        for _ in range(2 if feed is None else 1):
            logits = cache = None          # one set of logits at a time
            sync(device)
            t0 = time.perf_counter()
            logits, cache = prefill(params, {"tokens": prompt})
            sync(device)
            pre_ms.append((time.perf_counter() - t0) * 1e3)
        check(tuple(logits.shape) == (prompt.shape[0], prompt.shape[1],
                                      cfg.padded_vocab)
              and bool(torch.isfinite(vocab(cfg, logits)).all()),
              f"{cfg.name}: prefill logits not finite or misshapen")
        cache_bytes = nbytes(cache)
        rows = [logits[:, -1:].clone()]
        tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        del logits
        fed, dec_ms = [], []
        for i in range(LM_DECODE):
            fed.append(tok if feed is None else feed[:, i:i + 1])
            sync(device)
            t0 = time.perf_counter()
            lg, cache = serve(params, cache, fed[-1])
            tok = torch.argmax(lg[:, -1:], dim=-1).to(torch.int32)
            sync(device)
            dec_ms.append((time.perf_counter() - t0) * 1e3)
            rows.append(lg)
        dec = vocab(cfg, torch.cat(rows, dim=1))
        check(bool(torch.isfinite(dec).all()),
              f"{cfg.name}: decode logits not finite")
        return (pre_ms, dec_ms, dec, torch.cat(fed, dim=1), tok, cache_bytes,
                cache)

    def profile_step(cfg, params, cache, tok):
        """One more decode step under ``torch.profiler``: wall ms, device
        busy ms, and the kernel launches the host made."""
        from torch.profiler import ProfilerActivity, profile
        serve = make_serve_step(cfg)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            sync(device)
            t0 = time.perf_counter()
            serve(params, cache, tok)
            sync(device)
            wall = (time.perf_counter() - t0) * 1e3
        rows = prof.key_averages()
        busy = sum(getattr(e, "self_device_time_total", 0)
                   for e in rows) / 1e3
        launches = sum(e.count for e in rows if e.key == "cudaLaunchKernel")
        return wall, busy, launches

    def against_forward(cfg, params, prompt, fed, dec):
        """The decode's logits against the teacher-forced ``forward`` over
        the prompt and the fed tokens (Mamba2's scan wants a chunk that
        divides the length: the same scan, chunked finer). ``forward`` is
        ``_unembed`` of ``_forward_hidden``; only the compared rows are
        unembedded (gemma3's f32 logits of every row would take 17 GB)."""
        seq = torch.cat([prompt, fed], dim=1)
        if cfg.family == "hybrid":
            cfg = dataclasses.replace(
                cfg, ssm_chunk=math.gcd(cfg.ssm_chunk, seq.shape[1]))
        x, _, _ = LM._forward_hidden(cfg, params, seq)
        full = LM._unembed(cfg, params, x[:, prompt.shape[1] - 1:])
        return bound(vocab(cfg, full), dec, f32=False)

    batch = LM_BATCH if on_card else 2
    for arch, plen in LM_PROMPTS.items():
        cfg = CONFIGS[arch] if on_card else SMOKE_CONFIGS[arch]
        if not on_card:
            plen = 128
        gen = torch.Generator(device=device).manual_seed(seed)
        if on_card:
            torch.cuda.reset_peak_memory_stats(device)
        max_len = plen + 2 * LM_DECODE
        t0 = time.perf_counter()
        with torch.inference_mode():
            master = LM.init_params(cfg, gen, device=device)
            n_params = sum(t.numel() for t in _leaves(master))
            params = LM._cast_params(cfg, master)   # once, as greedy_decode
            sync(device)
            init_s = time.perf_counter() - t0
            prompt = torch.randint(0, cfg.vocab_size, (batch, plen),
                                   generator=gen, device=device,
                                   dtype=torch.int32)
            # gqa_attention goes blockwise past 2^21 scores a head (and 64
            # queries): count the prefills' blockwise calls
            blockwise = [0]
            plain_blockwise = LY._blockwise_attention

            def counted(*a, **kw):
                blockwise[0] += 1
                return plain_blockwise(*a, **kw)
            LY._blockwise_attention = counted
            try:
                pre_ms, dec_ms, dec, fed, tok, cache_bytes, cache = decode(
                    cfg, params, prompt, max_len, torch.bfloat16)
            finally:
                LY._blockwise_attention = plain_blockwise
            wide = plen * max_len > LY._BLOCKWISE_THRESHOLD and plen >= 64
            attn_layers = (cfg.num_layers // cfg.shared_attn_period
                           if cfg.family == "hybrid"
                           else 0 if cfg.family == "ssm" else cfg.num_layers)
            check(blockwise[0] == (2 * attn_layers if wide else 0),
                  f"{arch}: {blockwise[0]} blockwise attention calls in two "
                  f"prefills of {plen} x {max_len} (expected "
                  f"{2 * attn_layers if wide else 0})")
            if on_card and arch == "gemma3-1b":
                check(wide, f"{arch}: the prefill's {plen} x {max_len} "
                      f"scores do not pass 2^21: no blockwise attention")
            prof = (profile_step(cfg, params, cache, tok) if on_card
                    else None)
            del cache
            gen_toks = torch.cat([fed[:, 1:], tok], dim=1)
            check(bool(((gen_toks >= 0) & (gen_toks < cfg.vocab_size))
                       .all()), f"{arch}: a token past the vocabulary")
            peak = (torch.cuda.max_memory_allocated(device) / 2 ** 30
                    if on_card else float("nan"))
            bf16_diff, bf16_lim = against_forward(cfg, params, prompt, fed,
                                                  dec)
            w_bytes = nbytes(params)
            del params, dec
            # the same steps in f32 on the master weights, fed the bf16
            # run's tokens: bf16 rounding differences between the two
            # orders grow through the depth of the recurrent trunks
            cfg32 = dataclasses.replace(cfg, dtype="float32")
            dec32 = decode(cfg32, master, prompt, max_len, torch.float32,
                           feed=fed)[2]
            diff, lim = against_forward(cfg32, master, prompt, fed, dec32)
            check(diff <= lim, f"{arch}: the f32 decode differs from the "
                  f"teacher-forced forward by {diff} (bound {lim})")
        print(f"  {arch} ({cfg.family}, {cfg.num_layers} layers, d_model "
              f"{cfg.d_model}, vocab {cfg.vocab_size}): {n_params} "
              f"parameters, f32 {nbytes(master)} B, bf16 copy {w_bytes} B, "
              f"init {init_s:.3f} s; bf16 cache {cache_bytes} B for "
              f"{batch} x {max_len}")
        print(f"    prefill attention: {plen} x {max_len} scores a head, "
              f"{'blockwise' if wide else 'plain'} ({blockwise[0]} "
              f"blockwise calls in two prefills)")
        print(f"    prefill {batch} x {plen}: {pre_ms[1]:.3f} ms "
              f"({batch * plen / pre_ms[1] * 1e3:.1f} tokens/s; first call "
              f"{pre_ms[0]:.3f} ms); decode median {np.median(dec_ms):.3f} "
              f"ms a step (min {min(dec_ms):.3f}, max {max(dec_ms):.3f}; "
              f"{batch / np.median(dec_ms) * 1e3:.1f} tokens/s), bound "
              f"{w_bytes / HBM_BYTES_PER_S * 1e3:.6f} ms (the bf16 weights "
              f"once a step); peak memory {peak:.3f} GiB (bf16 run); {card}")
        if prof is not None:
            print(f"    one decode step profiled: wall {prof[0]:.3f} ms, "
                  f"device busy {prof[1]:.3f} ms, idle share "
                  f"{1 - prof[1] / prof[0]:.4f}, {prof[2]} kernel launches")
        print(f"    decode against the teacher-forced forward over "
              f"{plen + LM_DECODE} tokens: f32 {diff:.4g} (bound {lim:.4g}); "
              f"bf16 {bf16_diff:.4g} (the same bound {bf16_lim:.4g}, not "
              f"held)")
        del master, dec32, prompt, fed

    if on_card:
        # the card against the CPU at full width, f32, the same weights
        for arch in LM_PROMPTS:
            cfg = CONFIGS[arch]
            layers = (cfg.shared_attn_period + 1 if cfg.family == "hybrid"
                      else 2)
            cfg = dataclasses.replace(cfg, num_layers=layers,
                                      dtype="float32")
            gen = torch.Generator(device=device).manual_seed(seed + 1)
            with torch.inference_mode():
                p_card = LM.init_params(cfg, gen, device=device)
                p_cpu = _tree_to(p_card, "cpu")
                toks = torch.randint(0, cfg.vocab_size, (2, LM_CHECK_TOKENS),
                                     generator=gen, device=device,
                                     dtype=torch.int32)
                on, _, _ = LM.forward(cfg, p_card, toks)
                ref, _, _ = LM.forward(cfg, p_cpu, toks.cpu())
            diff, lim = bound(vocab(cfg, ref), vocab(cfg, on), f32=True)
            check(diff <= lim, f"{arch}: the card's f32 forward differs "
                  f"from the CPU's by {diff} (bound {lim})")
            print(f"  {arch} at {layers} layers, f32, 2 x {LM_CHECK_TOKENS} "
                  f"tokens: card against CPU {diff:.4g} (bound {lim:.4g})")
            del p_card, p_cpu, on, ref

    # every smoke architecture: prefill + decode against its forward
    for arch, cfg in SMOKE_CONFIGS.items():
        gen = torch.Generator(device=device).manual_seed(seed + 2)
        b, s, mx, pre = 2, 16, 24, 12
        with torch.inference_mode():
            params = LM.init_params(cfg, gen, device=device)
            tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                                   device=device, dtype=torch.int32)
            kw = {}
            if cfg.family == "vlm":
                kw["patch_embeds"] = torch.randn(
                    (b, cfg.patch_tokens, cfg.d_model), generator=gen,
                    device=device)
            if cfg.family == "audio":
                kw["frames"] = torch.randn(
                    (b, cfg.num_mem_tokens, cfg.d_model), generator=gen,
                    device=device)
            full, _, _ = LM.forward(cfg, params, tokens, **kw)
            lp, cache = LM.prefill(cfg, params, tokens[:, :pre], mx,
                                   cache_dtype=torch.float32, **kw)
            outs = [lp]
            for t in range(pre, s):
                lg, cache = LM.decode_step(cfg, params, cache,
                                           tokens[:, t:t + 1])
                outs.append(lg)
        diff, lim = bound(full, torch.cat(outs, dim=1), f32=False)
        check(diff <= lim, f"{arch} (smoke): decode differs from the "
              f"forward by {diff} (bound {lim})")
        print(f"  {arch} smoke ({cfg.family}): decode against forward "
              f"{diff:.4g} (bound {lim:.4g})")


def lm_train(device, on_card: bool, card: str, seed: int) -> None:
    """Phase 21: the LM training path (``launch.train`` over ``optim``,
    ``data.pipeline``, ``ft`` and ``models/lm`` with remat) at full size on
    the card; see the module docstring."""
    import re
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import CONFIGS, SMOKE_CONFIGS
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.ft.checkpoint import CheckpointManager
    from repro_torch.launch.train import default_optimizer, make_train_step
    from repro_torch.models import lm as LM
    from repro_torch.optim import adamw_init

    def finite(t) -> bool:
        return bool(torch.isfinite(t).all())

    def train(step_fn, params, opt_state, pipe, cfg, steps, times=None):
        metrics = []
        for _ in range(steps):
            batch = pipe.next_batch(cfg)
            sync(device)
            t0 = time.perf_counter()
            params, opt_state, m = step_fn(params, opt_state, batch)
            sync(device)
            if times is not None:
                times.append((time.perf_counter() - t0) * 1e3)
            metrics.append(m)
        return params, opt_state, metrics

    def profile_step(step_fn, params, opt_state, batch):
        """One step under ``torch.profiler`` (CUDA activity: the kernels and
        the runtime calls): wall ms, device busy ms, launches, kernels. The
        events are summed as they come, without building the profiler's
        per-op tables (a step makes ~10^5-10^6 of them)."""
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            sync(device)
            t0 = time.perf_counter()
            out = step_fn(params, opt_state, batch)
            sync(device)
            wall = (time.perf_counter() - t0) * 1e3
        busy_ns, launches, kernels = 0, 0, 0
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                busy_ns += e.duration_ns()
                kernels += 1
            elif e.name() in ("cudaLaunchKernel", "cudaLaunchKernelExC"):
                launches += 1
        return out, wall, busy_ns / 1e6, launches, kernels

    def full_size(arch):
        """The trained configuration: full size on the card; the smoke
        width in the CPU rehearsal, with the full one's remat and
        accumulation."""
        if on_card:
            return CONFIGS[arch]
        return dataclasses.replace(SMOKE_CONFIGS[arch], remat=True,
                                   grad_accum=CONFIGS[arch].grad_accum)

    batch = LM_BATCH if on_card else 4
    for arch, seq in LM_TRAIN.items():
        t_model = time.perf_counter()
        cfg = full_size(arch)
        if not on_card:
            seq = 128
        check(cfg.remat and cfg.param_dtype == "float32",
              f"{arch}: trained without remat or f32 master weights")
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        params = LM.init_params(cfg, gen, device=device)
        n_params = sum(t.numel() for t in _leaves(params))
        head = [t.flatten()[:4096].clone() for t in _leaves(params)]
        opt_state = adamw_init(params)
        step_fn = make_train_step(cfg, default_optimizer())
        pipe = TokenPipeline(cfg.vocab_size, batch, seq, seed=seed)
        times = []
        params, opt_state, metrics = train(step_fn, params, opt_state, pipe,
                                           cfg, 1 + LM_TRAIN_STEPS, times)
        prof = None
        if on_card:
            (params, opt_state, m), *prof = profile_step(
                step_fn, params, opt_state, pipe.next_batch(cfg))
            metrics.append(m)
            peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
        else:
            peak = float("nan")
        steps = len(metrics)
        losses = [float(m["loss"]) for m in metrics]
        gnorms = [float(m["grad_norm"]) for m in metrics]
        check(all(math.isfinite(v) for v in losses + gnorms),
              f"{arch}: a loss or grad_norm not finite: {losses} {gnorms}")
        check(all(finite(t) for t in _leaves(params)),
              f"{arch}: a parameter not finite after training")
        check(any(not torch.equal(h, t.flatten()[:4096])
                  for h, t in zip(head, _leaves(params))),
              f"{arch}: no parameter changed")
        check(int(opt_state["step"]) == steps,
              f"{arch}: optimizer step {int(opt_state['step'])}, {steps} "
              f"steps taken")
        med = float(np.median(times[1:]))
        tok_s = batch * seq / med * 1e3
        mfu = 6 * n_params * tok_s / BF16_OPS_PER_S
        print(f"  {arch} ({cfg.family}, {cfg.num_layers} layers, d_model "
              f"{cfg.d_model}, vocab {cfg.vocab_size}): {n_params} "
              f"parameters, {batch} x {seq} tokens a step in "
              f"{cfg.grad_accum} microbatches, remat {cfg.remat}")
        print(f"    step median {med:.3f} ms over {LM_TRAIN_STEPS} (warm-up "
              f"{times[0]:.3f} ms; {[round(t, 3) for t in times[1:]]}), "
              f"{tok_s:.1f} tokens/s, model FLOP rate 6·N·tokens/s "
              f"{6 * n_params * tok_s / 1e12:.3f} TFLOP/s = {mfu:.4f} of "
              f"the dense bf16 peak; peak memory {peak:.3f} GiB; {card}")
        print(f"    loss {[round(v, 4) for v in losses]}, grad_norm "
              f"{[round(v, 4) for v in gnorms]}, optimizer step {steps}")
        if prof is not None:
            wall, busy, launches, kernels = prof
            print(f"    one step profiled: wall {wall:.3f} ms, device busy "
                  f"{busy:.3f} ms, idle share {1 - busy / wall:.4f}, "
                  f"{launches} kernel launches, {kernels} device "
                  f"activities; {card}")
        print(f"    {time.perf_counter() - t_model:.3f} s for the model")
        del params, opt_state, head, metrics, step_fn

    opt = default_optimizer()
    # the card against the CPU: one f32 step at full width, cut depth (the
    # CPU rehearsal holds the CPU against itself)
    for arch in LM_TRAIN:
        t_check = time.perf_counter()
        cfg = full_size(arch)
        layers = (cfg.shared_attn_period + 1 if cfg.family == "hybrid"
                  else 2)
        cfg = dataclasses.replace(cfg, num_layers=layers,
                                  dtype="float32", grad_accum=1)
        gen = torch.Generator(device=device).manual_seed(seed + 1)
        p_card = LM.init_params(cfg, gen, device=device)
        p_cpu = _tree_to(p_card, "cpu")
        b = TokenPipeline(cfg.vocab_size, 2, LM_CHECK_TOKENS,
                          seed=seed).next_batch(cfg)
        step_fn = make_train_step(cfg, opt)
        bt = {k: torch.as_tensor(v) for k, v in b.items()}
        _, _, g_card = step_fn.grads_of(p_card, _tree_to(bt, device))
        _, _, g_cpu = step_fn.grads_of(p_cpu, bt)
        g_rel = max(float((a.cpu() - r).abs().max())
                    / max(float(r.abs().max()), 1e-30)
                    for a, r in zip(_leaves(g_card), _leaves(g_cpu)))
        del g_card, g_cpu
        n_card, _, m_card = step_fn(p_card, adamw_init(p_card), b)
        n_cpu, _, m_cpu = step_fn(p_cpu, adamw_init(p_cpu), b)
        lr = float(m_cpu["lr"])
        d_p = [(a.cpu() - r).abs() for a, r in zip(_leaves(n_card),
                                                   _leaves(n_cpu))]
        p_max = max(float(d.max()) for d in d_p)
        flips = (sum(int((d > lr / 2).sum()) for d in d_p)
                 / sum(d.numel() for d in d_p))
        rel = {k: abs(float(m_card[k]) - float(m_cpu[k]))
               / abs(float(m_cpu[k])) for k in ("loss", "grad_norm")}
        check(rel["loss"] <= 1e-5 and rel["grad_norm"] <= 1e-4,
              f"{arch}: the card's loss / grad_norm leave the CPU's: "
              f"{rel}")
        check(g_rel <= 1e-3, f"{arch}: a gradient leaf leaves the "
              f"CPU's by {g_rel} of its largest |g| (bound 1e-3)")
        check(p_max <= 2 * lr + 2e-6, f"{arch}: an updated parameter "
              f"leaves the CPU's by {p_max} (bound 2 x lr + 2e-6 = "
              f"{2 * lr + 2e-6})")
        print(f"  {arch} at {layers} layers, f32, 2 x {LM_CHECK_TOKENS} "
              f"tokens, one step, card against CPU: loss rel "
              f"{rel['loss']:.3g} (bound 1e-5), grad_norm rel "
              f"{rel['grad_norm']:.3g} (1e-4), gradients {g_rel:.3g} of "
              f"the leaf's largest |g| (1e-3), parameters {p_max:.4g} "
              f"(2 x lr + 2e-6 = {2 * lr + 2e-6:.4g}), share past lr/2 "
              f"{flips:.3g}; {time.perf_counter() - t_check:.3f} s")
        del p_card, p_cpu, n_card, n_cpu, d_p

    # the restart: 6 steps straight against 3, a checkpoint, a restore
    # into fresh trees and 3 more, under deterministic algorithms
    t_restart = time.perf_counter()
    cfg = full_size("gemma3-1b")
    if on_card:
        cfg = dataclasses.replace(cfg, num_layers=2)
    step_fn = make_train_step(cfg, opt)
    gen = torch.Generator(device=device).manual_seed(seed + 2)
    p0 = LM.init_params(cfg, gen, device=device)
    o0 = adamw_init(p0)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        with tempfile.TemporaryDirectory() as d:
            def pipe():
                return TokenPipeline(cfg.vocab_size, batch, 128, seed=seed)
            pa, oa, _ = train(step_fn, p0, o0, pipe(), cfg,
                              2 * RESTART_STEPS)
            pipe_b = pipe()
            pb, ob, _ = train(step_fn, p0, o0, pipe_b, cfg, RESTART_STEPS)
            t0 = time.perf_counter()
            ckpt = CheckpointManager(d, keep=2)
            ckpt.save(RESTART_STEPS, pb, ob, pipe_b.get_state())
            save_s = time.perf_counter() - t0
            fresh = LM.init_params(cfg, torch.Generator(
                device=device).manual_seed(seed + 3), device=device)
            t0 = time.perf_counter()
            pr, orr, pipe_state, step = ckpt.restore(fresh,
                                                     adamw_init(fresh))
            load_s = time.perf_counter() - t0
            check(step == RESTART_STEPS, f"restart: restored step {step}")
            check(all(a.dtype == r.dtype and a.device == r.device
                      and torch.equal(a, r) for a, r in zip(
                          _leaves((pb, ob)), _leaves((pr, orr)))),
                  "restart: a restored tensor differs from the saved one")
            pipe_c = pipe()
            pipe_c.set_state(pipe_state)
            pc, oc, _ = train(step_fn, pr, orr, pipe_c, cfg, RESTART_STEPS)
            ckpt_bytes = sum(os.path.getsize(os.path.join(dp, f))
                             for dp, _, fs in os.walk(d) for f in fs)
    finally:
        torch.use_deterministic_algorithms(was)
    same = [torch.equal(a, c) for a, c in zip(_leaves((pa, oa)),
                                               _leaves((pc, oc)))]
    check(all(same), f"restart: {same.count(False)} of {len(same)} tensors "
          f"differ from the straight run's")
    print(f"  restart, {cfg.name} at {cfg.num_layers} layers, {batch} x "
          f"128: {2 * RESTART_STEPS} steps straight equal {RESTART_STEPS} + "
          f"checkpoint + restore + {RESTART_STEPS} bit for bit "
          f"({len(same)} tensors; deterministic algorithms); checkpoint "
          f"{ckpt_bytes} B, save {save_s:.3f} s, restore {load_s:.3f} s; "
          f"{time.perf_counter() - t_restart:.3f} s")
    del p0, o0, pa, oa, pb, ob, pr, orr, pc, oc, fresh

    # the entry point: python -m repro_torch.launch.train, then --resume
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    with tempfile.TemporaryDirectory() as d:
        def run(steps, *extra):
            cmd = [sys.executable, "-m", "repro_torch.launch.train",
                   "--arch", "gemma3-1b", "--smoke", "--steps", str(steps),
                   "--batch", "8", "--seq", "128", "--ckpt-dir", d,
                   "--ckpt-every", "20", "--device", device.type, *extra]
            t0 = time.perf_counter()
            r = subprocess.run(cmd, env=env, capture_output=True, text=True,
                               timeout=600)
            check(r.returncode == 0, f"launch.train exited {r.returncode}: "
                  f"{r.stderr[-2000:]}")
            return r.stdout, time.perf_counter() - t0

        out, first_s = run(ENTRY_STEPS)
        loss = {int(m.group(1)): float(m.group(2)) for m in re.finditer(
            r"step\s+(\d+) loss (\S+)", out)}
        last = ENTRY_STEPS - 1
        check(0 in loss and last in loss and loss[0] - loss[last] >= 0.1,
              f"launch.train: the loss fell from {loss.get(0)} to "
              f"{loss.get(last)} (at least 0.1 wanted)")
        kept = CheckpointManager(d).steps()
        check(kept == [20, 40, 60], f"launch.train kept checkpoints {kept}")
        out2, resume_s = run(ENTRY_RESUME, "--resume")
        check(f"resumed from step {ENTRY_STEPS}" in out2,
              f"launch.train --resume: {out2[:500]}")
        kept2 = CheckpointManager(d).steps()
        check(kept2 == [40, 60, 80], f"launch.train kept {kept2} after "
              f"resuming")
    print(f"  python -m repro_torch.launch.train --arch gemma3-1b --smoke "
          f"--steps {ENTRY_STEPS} --batch 8 --seq 128: loss {loss[0]:.4f} "
          f"-> {loss[last]:.4f} at step {last} ({first_s:.3f} s), "
          f"checkpoints {kept}; --resume --steps {ENTRY_RESUME}: resumed "
          f"from step {ENTRY_STEPS}, kept {kept2} ({resume_s:.3f} s)")


def lm_mesh(device, on_card: bool, card: str, seed: int) -> None:
    """Phase 22: the LM on a mesh (``use_rules`` on a one-rank (1, 1)
    ("data", "model") ``DeviceMesh``) and the dry run; see the module
    docstring."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import CONFIGS, SMOKE_CONFIGS
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import rules_for
    from repro_torch.models import layers as LY
    from repro_torch.models import lm as LM
    from repro_torch.models.layers import P

    # the dry run, in processes of its own (each cell opens a fake group
    # of 256 or 512 ranks, which cannot share this process's group):
    # started now, read at the end
    runs = tempfile.TemporaryDirectory(prefix="chip_smoke_dryrun_")
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "src"))
    children = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *argv, "--out",
         os.path.join(runs.name, f"cells{i}.jsonl")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i, argv in enumerate(DRYRUN_CELLS)]
    import gc
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    print(f"  memory held from earlier phases: "
          f"{torch.cuda.memory_allocated(device) / 2 ** 30:.3f} GiB"
          if on_card else "  CPU rehearsal: smoke configs, a gloo group")

    def full(t):
        return t.full_tensor() if isinstance(t, DTensor) else t

    def bound(ref, got):
        ref, got = ref.float(), got.float().to(ref.device)
        scale = float(ref.abs().max())
        return float((ref - got).abs().max()), 1e-4 * scale + 1e-5

    ep_calls = [0]
    plain_ep = LY._capacity_dispatch_ep

    def counted(*a, **kw):
        ep_calls[0] += 1
        return plain_ep(*a, **kw)

    store = tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_")
    dist.init_process_group(
        "nccl" if on_card else "gloo",
        init_method=f"file://{store.name}/store", rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=300),
        **({"device_id": torch.device(
            "cuda", torch.cuda.current_device())} if on_card else {}))
    LY._capacity_dispatch_ep = counted
    try:
        mesh = init_device_mesh(device.type, (1, 1),
                                mesh_dim_names=("data", "model"))
        rules = rules_for(mesh)

        def on_mesh(cfg, params):
            """The parameters laid out by their specs on the one-rank
            mesh (each rank's shard is the whole tensor: no copy)."""
            specs = []
            SH.tree_map(specs.append, LM.param_specs(cfg),
                        is_leaf=lambda x: isinstance(x, P))
            it = iter(specs)

            def one(t):
                ps = next(it)
                return DTensor.from_local(t, mesh, SH.placements(
                    SH.logical_spec(ps.shape, ps.axes, rules, mesh), mesh),
                    run_check=False)
            with torch.inference_mode():     # the weights' own mode
                return SH.tree_map(one, params)

        def rows(t):
            return DTensor.from_local(t, mesh, SH.placements(SH.logical_spec(
                t.shape, ("batch",) + (None,) * (t.ndim - 1), rules, mesh),
                mesh), run_check=False)

        def serve(cfg, params, prompt, meshed, steps, keep_logits=False):
            """``lm.prefill`` and ``steps`` greedy ``decode_step``s, under
            the rules when ``meshed``: prefill ms, step ms, the prefill's
            logits (all, or the last row), the tokens, the cache, the EP
            calls of the prefill and of each step."""
            ctx = (SH.use_rules(rules, mesh) if meshed
                   else contextlib.nullcontext())
            calls = []
            with ctx, torch.inference_mode():
                ep_calls[0] = 0
                sync(device)
                t0 = time.perf_counter()
                logits, cache = LM.prefill(cfg, params,
                                           rows(prompt) if meshed else prompt,
                                           prompt.shape[1] + steps)
                sync(device)
                pre_ms = (time.perf_counter() - t0) * 1e3
                calls.append(ep_calls[0])
                kept = full(logits if keep_logits else logits[:, -1:])
                tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
                del logits
                toks, dec_ms = [full(tok)], []
                for _ in range(steps - 1):
                    ep_calls[0] = 0
                    sync(device)
                    t0 = time.perf_counter()
                    lg, cache = LM.decode_step(cfg, params, cache, tok)
                    tok = torch.argmax(lg[:, -1:], dim=-1).to(torch.int32)
                    sync(device)
                    dec_ms.append((time.perf_counter() - t0) * 1e3)
                    calls.append(ep_calls[0])
                    toks.append(full(tok))
                    check(bool(torch.isfinite(full(lg)[..., :cfg.vocab_size])
                               .all()), f"{cfg.name}: decode not finite")
            return (pre_ms, dec_ms, kept, torch.cat(toks, dim=1), cache, tok,
                    calls)

        def profile_step(cfg, params, cache, tok, meshed):
            from torch.profiler import ProfilerActivity, profile
            ctx = (SH.use_rules(rules, mesh) if meshed
                   else contextlib.nullcontext())
            with ctx, torch.inference_mode(), profile(activities=[
                    ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                sync(device)
                t0 = time.perf_counter()
                LM.decode_step(cfg, params, cache, tok)
                sync(device)
                wall = (time.perf_counter() - t0) * 1e3
            ev = prof.key_averages()
            busy = sum(getattr(e, "self_device_time_total", 0)
                       for e in ev) / 1e3
            launches = sum(e.count for e in ev
                           if e.key == "cudaLaunchKernel")
            return wall, busy, launches

        # ---- the MoE at its full CONFIG (bf16 weights) under the mesh
        base = CONFIGS[MESH_ARCH] if on_card else dataclasses.replace(
            SMOKE_CONFIGS[MESH_ARCH], moe_dispatch="capacity")
        cfg = dataclasses.replace(base, param_dtype="bfloat16")
        check(cfg.moe_dispatch == "capacity",
              f"{MESH_ARCH}: its dispatch is {cfg.moe_dispatch}")
        batch, plen = (LM_BATCH, MESH_PROMPT) if on_card else (2, 32)
        gen = torch.Generator(device=device).manual_seed(seed)
        if on_card:
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        with torch.inference_mode():
            params = LM.init_params(cfg, gen, device=device)
            prompt = torch.randint(0, cfg.vocab_size, (batch, plen),
                                   generator=gen, device=device,
                                   dtype=torch.int32)
        sync(device)
        n_params = sum(t.numel() for t in _leaves(params))
        w_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
        check(all(t.dtype == torch.bfloat16 for t in _leaves(params)),
              f"{MESH_ARCH}: a weight leaf not bf16")
        print(f"  {MESH_ARCH} ({cfg.num_layers} layers, d_model "
              f"{cfg.d_model}, {cfg.num_experts} experts top-"
              f"{cfg.experts_per_token}, {cfg.num_shared_experts} shared, "
              f"vocab {cfg.vocab_size}): {n_params} parameters, bf16 "
              f"{w_bytes} B ({w_bytes / 2 ** 30:.2f} GiB), init "
              f"{time.perf_counter() - t0:.3f} s")
        runs_out = {}
        for meshed in (True, False):
            tag = "mesh (1, 1)" if meshed else "no mesh"
            if on_card:
                torch.cuda.reset_peak_memory_stats(device)
            p = on_mesh(cfg, params) if meshed else params
            pre_ms, dec_ms, last, toks, cache, tok, calls = serve(
                cfg, p, prompt, meshed, MESH_DECODE)
            want = cfg.num_layers if meshed else 0
            check(all(c == want for c in calls),
                  f"{MESH_ARCH} {tag}: _capacity_dispatch_ep calls {calls} "
                  f"(expected {want} a forward)")
            check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
                  f"{MESH_ARCH} {tag}: a token past the vocabulary")
            prof = (profile_step(cfg, p, cache, tok, meshed) if on_card
                    else None)
            peak = (torch.cuda.max_memory_allocated(device) / 2 ** 30
                    if on_card else float("nan"))
            del cache
            runs_out[meshed] = toks
            print(f"    {tag}: prefill {batch} x {plen} {pre_ms:.3f} ms "
                  f"({batch * plen / pre_ms * 1e3:.1f} tokens/s); decode "
                  f"median {np.median(dec_ms):.3f} ms a step (min "
                  f"{min(dec_ms):.3f}, max {max(dec_ms):.3f}; "
                  f"{MESH_DECODE - 1} steps); _capacity_dispatch_ep "
                  f"{calls[0]} calls in the prefill, {calls[1]} a step; "
                  f"peak {peak:.3f} GiB; {card}")
            if prof is not None:
                print(f"      one decode step profiled: wall {prof[0]:.3f} "
                      f"ms, device busy {prof[1]:.3f} ms, idle share "
                      f"{1 - prof[1] / prof[0]:.4f}, {prof[2]} kernel "
                      f"launches")
            del p
        same = int((runs_out[True] == runs_out[False]).all(-1).sum())
        print(f"    greedy tokens, mesh against no mesh: {same} of {batch} "
              f"sequences the same over {MESH_DECODE} steps (full depth, "
              f"bf16; printed, not held)")
        del params, prompt, runs_out

        # ---- meshed = plain, bit for bit, at full width and 4 layers
        cfg4 = dataclasses.replace(cfg, num_layers=min(MESH_EQ_LAYERS,
                                                       cfg.num_layers))
        gen = torch.Generator(device=device).manual_seed(seed + 1)
        torch.use_deterministic_algorithms(True)
        try:
            with torch.inference_mode():
                params = LM.init_params(cfg4, gen, device=device)
                prompt = torch.randint(0, cfg4.vocab_size, (batch, plen),
                                       generator=gen, device=device,
                                       dtype=torch.int32)
            got = serve(cfg4, on_mesh(cfg4, params), prompt, True, 4,
                        keep_logits=True)
            want = serve(cfg4, params, prompt, False, 4, keep_logits=True)
        finally:
            torch.use_deterministic_algorithms(False)
        check(got[6][0] == cfg4.num_layers and want[6][0] == 0,
              f"{MESH_ARCH} at {cfg4.num_layers} layers: EP calls "
              f"{got[6]} / {want[6]}")
        gap = float((got[2].float() - want[2].float()).abs().max())
        check(torch.equal(got[2], want[2]) and torch.equal(got[3], want[3]),
              f"{MESH_ARCH} at {cfg4.num_layers} layers: the meshed prefill "
              f"logits or decode tokens differ from the plain run's (max "
              f"|diff| {gap})")
        print(f"  {MESH_ARCH} at {cfg4.num_layers} layers, full width, bf16, "
              f"deterministic: the meshed prefill logits "
              f"{tuple(got[2].shape)} and 4 decode tokens equal the plain "
              f"run's bit for bit (expert-parallel against "
              f"_capacity_dispatch)")
        del params, prompt, got, want

        # ---- f32, 2 layers: the meshed card against the plain CPU; the
        # MoE with the card's sums in a fixed order (its index_put_ adds by
        # atomics otherwise, and a capacity choice near a tie in the
        # second layer's router may then fall either way from run to run)
        for arch in MESH_F32:
            base = CONFIGS[arch] if on_card else SMOKE_CONFIGS[arch]
            c = dataclasses.replace(base, num_layers=2, dtype="float32")
            if c.family == "moe":
                c = dataclasses.replace(c, moe_dispatch="capacity")
            torch.use_deterministic_algorithms(c.family == "moe")
            gen = torch.Generator(device=device).manual_seed(seed + 2)
            with torch.inference_mode():
                p = LM.init_params(c, gen, device=device)
                p_cpu = _tree_to(p, "cpu")
                toks = torch.randint(0, c.vocab_size, (2, LM_CHECK_TOKENS),
                                     generator=gen, device=device,
                                     dtype=torch.int32)
                ep_calls[0] = 0
                with SH.use_rules(rules, mesh):
                    on, _, _ = LM.forward(c, on_mesh(c, p), rows(toks))
                    on = full(on)
                ref, _, _ = LM.forward(c, p_cpu, toks.cpu())
            want = 2 if (c.family == "moe") else 0
            check(ep_calls[0] == want, f"{arch}: {ep_calls[0]} EP calls")
            diff, lim = bound(ref[..., :c.vocab_size], on[..., :c.vocab_size])
            check(diff <= lim, f"{arch}: the meshed f32 forward on the card "
                  f"differs from the CPU's by {diff} (bound {lim})")
            print(f"  {arch} at 2 layers, f32, 2 x {LM_CHECK_TOKENS} tokens: "
                  f"the mesh on the {device.type} against the plain CPU "
                  f"{diff:.4g} (bound {lim:.4g})")
            del p, p_cpu, on, ref
    finally:
        torch.use_deterministic_algorithms(False)
        LY._capacity_dispatch_ep = plain_ep
        dist.destroy_process_group()
        store.cleanup()

    # ---- the dry run's records
    try:
        for argv, ch in zip(DRYRUN_CELLS, children):
            try:
                out, err = ch.communicate(timeout=DRYRUN_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                ch.kill()
                ch.communicate()
                raise SmokeFailure(f"dry run {' '.join(argv)}: past "
                                   f"{DRYRUN_TIMEOUT_S} s")
            check(ch.returncode == 0, f"dry run {' '.join(argv)}: exit "
                  f"{ch.returncode}: {err[-2000:]}")
        recs = []
        for i in range(len(DRYRUN_CELLS)):
            with open(os.path.join(runs.name, f"cells{i}.jsonl")) as f:
                recs += [json.loads(line) for line in f]
        want = sum(2 if ("both" in a or "--starling" in a) else 1
                   for a in DRYRUN_CELLS)
        check(len(recs) == want, f"dry run: {len(recs)} records (expected "
              f"{want})")
        for r in recs:
            check(r.get("status") == "OK", f"dry run {r['arch']} "
                  f"{r['shape']} {r['mesh']}: {r.get('status')} "
                  f"{r.get('error', '')}")
            bpd = r["bytes_per_device"]
            if r["arch"] == "starling-search":
                print(f"  dry run {r['arch']} {r['mesh']} ({r['chips']} "
                      f"ranks): argument {bpd['argument']} B a rank, "
                      f"collective {r['collective_bytes']} B (the step's "
                      f"two all-gathers; the round loop is not traced)")
                continue
            print(f"  dry run {r['arch']} {r['shape']} {r['mesh']} "
                  f"({r['chips']} ranks, {r['lower_s']} s): a rank's "
                  f"argument {bpd['argument']} B, peak {bpd['peak']} B, "
                  f"total {bpd['total']} B; {r['hlo_flops']:.6g} FLOPs, "
                  f"{r['hlo_bytes']:.6g} B moved, collective "
                  f"{r['collective_bytes']} B {r['collectives']}; dominant "
                  f"{r['dominant']} (roofline on the H100's 989e12 FLOP/s, "
                  f"3.35e12 B/s, 450e9 B/s)")
    finally:
        for ch in children:
            if ch.poll() is None:
                ch.kill()
                ch.communicate()
        runs.cleanup()


def _example(name: str):
    """``examples_torch/<name>.py`` beside this script, as a module."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "examples_torch", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def examples(device, on_card: bool, card: str, seed: int, take) -> None:
    """Phase 23: the four examples of ``examples_torch`` in this process
    (their launches counted), each held to the plain path or the CPU; the
    RAG bridge at gemma3-1b's full width; ``train_resume`` at rwkv6-1.6b's
    full width, cut depth. See the module docstring."""
    from repro_torch import kernels as K
    from repro_torch.configs import CONFIGS, SMOKE_CONFIGS
    from repro_torch.configs.starling_segment import SEGMENT_BENCH_DEVICE
    from repro_torch.core import device_search as DS
    from repro_torch.core import distances as D
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.data.vectors import clustered_vectors, query_set
    from repro_torch.kernels import l2_tile as L2
    from repro_torch.kernels import ref
    from repro_torch.launch.train import default_optimizer, make_train_step
    from repro_torch.models import lm as LM
    from repro_torch.optim import adamw_init
    QS, SS, RS, TR = (_example(n) for n in (
        "quickstart", "serve_segments", "rag_serving", "train_resume"))
    dev = device.type

    def asdicts(stats):
        return [dataclasses.asdict(s) for s in stats]

    def against_ref(found, ds, what, params=RS.RETRIEVE):
        """Each search in ``found`` (dicts of its queries, ids, dists, io
        and tier0_hits) again at ``fetch_impl="ref"`` on the same queries
        and segment: ids, io and tier0_hits equal, dists within t0_rank's
        atol 1e-4 / rtol 1e-5. The largest |dist diff|."""
        p = dataclasses.replace(params, fetch_impl="ref")
        err = 0.0
        for i, g in enumerate(found):
            r = DS.device_anns(ds, torch.as_tensor(g["queries"],
                                                   device=ds.device), p)
            for f in ("ids", "io", "tier0_hits"):
                check(np.array_equal(g[f], getattr(r, f).cpu().numpy()),
                      f"{what}: search {i}'s {f} differ from the plain "
                      f"round's")
            rd = r.dists.cpu().numpy()
            check(np.allclose(g["dists"], rd, atol=1e-4, rtol=1e-5),
                  f"{what}: search {i}'s dists leave the plain round's")
            err = max(err, float(np.abs(g["dists"] - rd).max()))
        return err

    def l2_at_width(corpus, kk):
        """``l2_tile`` against ``pairwise_l2_ref`` on the build's kNN
        chunks of ``KNN_ROWS`` sampled corpus rows against the whole
        corpus, both also against the float64 value. Per entry the bound
        is phase 5's atol / rtol plus ``L2_ROUND`` sqrt(d) u (|q|^2 +
        |x|^2), u = 2^-24: the norm expansion's f32 rounding grows with
        the squared norms and (summed in any order) sqrt(d). The kNN ids
        (k = ``kk``) must be equal where the k-th gap exceeds both
        entries' bounds."""
        n, d = corpus.shape
        xt = torch.as_tensor(corpus, device=device)
        xd = xt.double()
        xx = (xd ** 2).sum(1)
        round_u = L2_ROUND * math.sqrt(d) * 2.0 ** -24
        rows = torch.as_tensor(np.sort(np.random.default_rng(seed).choice(
            n, min(KNN_ROWS, n), replace=False)), device=device)
        chunk = D._row_chunk(n, device, KNN_CHUNK)
        err = worst = rel_k = rel_p = 0.0
        clear = same_set = 0
        for s in range(0, rows.numel(), chunk):
            xr = xt[rows[s:s + chunk]]
            got, want = L2.l2_tile(xr, xt), ref.pairwise_l2_ref(xr, xt)
            norms = xx[rows[s:s + chunk]][:, None] + xx[None]
            exact = torch.clamp_min(norms - 2.0 * (xr.double() @ xd.T), 0.0)
            tol = L2_ATOL + L2_RTOL * want.abs() + round_u * norms
            diff = (got - want).abs()
            worst = max(worst, float((diff / tol).max()))
            check(worst <= 1.0, f"l2_tile at d {d} leaves the plain version "
                  f"by {worst:.3f} x the bound")
            err = max(err, float(diff.max()))
            rel_k = max(rel_k, float(((got - exact).abs() / norms).max()))
            rel_p = max(rel_p, float(((want - exact).abs() / norms).max()))
            del diff, exact, norms
            ik = D.topk_smallest(got, kk + 1)
            ip = D.topk_smallest(want, kk + 1)
            vp = torch.gather(want, 1, ip)
            tp = torch.gather(tol, 1, ip)
            del got, want, tol
            ok = (vp[:, kk] - vp[:, kk - 1]) > tp[:, kk] + tp[:, kk - 1]
            eq = (torch.sort(ik[:, :kk], 1).values
                  == torch.sort(ip[:, :kk], 1).values).all(1)
            check(bool(eq[ok].all()), f"l2_tile kNN ids at d {d} differ "
                  f"from the plain path's where the k-th gap exceeds the "
                  f"bound")
            clear += int(ok.sum())
            same_set += int(eq.sum())
        print(f"  l2_tile at d {d} against pairwise_l2_ref: {rows.numel()} "
              f"rows x {n}, max |diff| {err:.6g}, at most {worst:.4f} of "
              f"the bound (atol {L2_ATOL} + rtol {L2_RTOL} + {L2_ROUND} "
              f"sqrt(d) u (|q|^2 + |x|^2)); "
              f"to the f64 value, relative to |q|^2 + |x|^2: kernel "
              f"{rel_k:.3g}, plain {rel_p:.3g}; kNN (k={kk}) same id set "
              f"{same_set}, {clear} rows with a k-th gap past the bound "
              f"(all equal); {card}")

    def straight(cfg, params, steps):
        """``steps`` of the example's training without a crash."""
        step_fn = make_train_step(cfg, default_optimizer())
        pipe = TokenPipeline(cfg.vocab_size, batch=TR.BATCH, seq=TR.SEQ,
                             seed=0)
        opt, losses = adamw_init(params), []
        for _ in range(steps):
            params, opt, m = step_fn(params, opt, pipe.next_batch(cfg))
            losses.append(float(m["loss"]))
        return losses, params, opt

    def resume(cfg, what):
        """``TR.run`` (24 steps, the crash at 12) against 24 straight steps
        from the same weights, bit for bit, under deterministic
        algorithms."""
        t0 = time.perf_counter()
        was = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(True)
        try:
            with tempfile.TemporaryDirectory() as d:
                a = TR.run(cfg, TR.init(cfg, device), EX_STEPS, EX_CRASH, d,
                           device)
            losses, params, opt = straight(cfg, TR.init(cfg, device),
                                           EX_STEPS)
        finally:
            torch.use_deterministic_algorithms(was)
        check(a["resumed_at"] == EX_CRASH,
              f"{what}: resumed at {a['resumed_at']}")
        same = [torch.equal(x, y) for x, y in zip(
            _leaves((a["params"], a["opt"])), _leaves((params, opt)))]
        check(a["losses"] == losses and all(same),
              f"{what}: the resumed run leaves the straight one "
              f"({same.count(False)} of {len(same)} tensors differ)")
        ls = a["losses"]
        print(f"  {what}: {cfg.name}, {cfg.num_layers} layers, d_model "
              f"{cfg.d_model}; {EX_STEPS} steps of {TR.BATCH} x {TR.SEQ}, "
              f"the crash at {EX_CRASH}, resumed at {a['resumed_at']}: "
              f"losses and {len(same)} tensors equal the straight run bit "
              f"for bit (deterministic algorithms); loss {ls[0]:.4f} -> "
              f"{ls[-1]:.4f}, the example's check losses[-1] < losses[0] "
              f"{'holds' if ls[-1] < ls[0] else 'fails'}; step ms median "
              f"{np.median(a['step_ms']):.3f}; checkpoints "
              f"{[(round(t, 3), b) for t, b in a['saves']]} (s, bytes), "
              f"restore {a['restore_s']:.3f} s; "
              f"{time.perf_counter() - t0:.3f} s; {card}")

    # 1. the four examples at their JAX sizes
    t0 = time.perf_counter()
    r = QS.main(["--device", dev])
    c = QS.search(r["seg"], r["x"], r["q"], r["truth"], "cpu")
    for kind in ("", "base_"):
        check(np.array_equal(r[kind + "ids"], c[kind + "ids"])
              and asdicts(r[kind + "stats"]) == asdicts(c[kind + "stats"]),
              f"quickstart: {kind or 'starling '}ids or IOStats on the card "
              f"differ from device='cpu'")
    print(f"  quickstart: the card-built segment's anns and baseline equal "
          f"device='cpu' in ids and every IOStats field ({len(r['q'])} "
          f"queries); range AP {r['ap']:.3f} (cpu {c['ap']:.3f}); "
          f"{time.perf_counter() - t0:.3f} s; {card}")
    del r, c
    take("23 quickstart")

    t0 = time.perf_counter()
    s = SS.main(["--device", dev])
    ref_s = SS.serve(SS.make_servers(s["segs"], device, fetch_impl="ref"),
                     s["queries"])
    err = 0.0
    for a, b in zip(s["batches"], ref_s["batches"]):
        check(np.array_equal(a["ids"], b["ids"]),
              "serve_segments: ids differ from the plain round's")
        check(a["stats"] == b["stats"], f"serve_segments: stats "
              f"{a['stats']} differ from the plain round's {b['stats']}")
        check(np.allclose(a["dists"], b["dists"], atol=1e-4, rtol=1e-5),
              "serve_segments: dists leave the plain round's")
        err = max(err, float(np.abs(a["dists"] - b["dists"]).max()))
    print(f"  serve_segments: {len(s['batches'])} batches equal the plain "
          f"round's in ids and stats, dists within {err:.3g}; recall@10 "
          f"{s['recall']:.3f}; {time.perf_counter() - t0:.3f} s; {card}")
    del s, ref_s
    take("23 serve_segments")

    t0 = time.perf_counter()
    g = RS.main(["--device", dev])
    err = against_ref(g["retrievals"], g["ds"], "rag_serving")
    print(f"  rag_serving: {len(g['retrievals'])} retrievals equal the "
          f"plain round's, dists within {err:.3g}; "
          f"{time.perf_counter() - t0:.3f} s; {card}")
    del g
    take("23 rag_serving")

    resume(SMOKE_CONFIGS["rwkv6-1.6b"], "train_resume")
    take("23 train_resume")

    # 2. the RAG bridge at gemma3-1b's full width (the smoke width in the
    # CPU rehearsal)
    t0 = time.perf_counter()
    cfg = CONFIGS["gemma3-1b"] if on_card else SMOKE_CONFIGS["gemma3-1b"]
    n = EX_RAG_N if on_card else 2000
    params = dataclasses.replace(
        SEGMENT_BENCH_DEVICE,
        layout=dataclasses.replace(SEGMENT_BENCH_DEVICE.layout,
                                   block_kb=EX_RAG_BLOCK_KB),
        graph=dataclasses.replace(SEGMENT_BENCH_DEVICE.graph, algo="nsg"))
    gamma = cfg.d_model * 4 + 4 + params.graph.max_degree * 4
    print(f"  reductions: η {EX_RAG_BLOCK_KB} KB (a {gamma} B vertex: "
          f"ε {4096 // gamma} at 4 KB), an NSG disk graph (Vamana's hop "
          f"loop at n = {n})")
    corpus = clustered_vectors(n, cfg.d_model, num_clusters=16, seed=seed)
    t1 = time.perf_counter()
    seg, ds = RS.index(corpus, params, device)
    build_s = time.perf_counter() - t1
    print(f"  corpus {n} x {cfg.d_model} ({corpus.nbytes} B f32) built in "
          f"{build_s:.3f} s: " + ", ".join(
              f"{k} {v:.3f}" for k, v in seg.build_times.items())
          + f", kNN {seg.build_info.get('knn_s', float('nan')):.3f} s; "
          f"OR(G) {seg.overlap_ratio:.4f}, ε {seg.vecs.shape[1]}, ρ "
          f"{seg.num_blocks}, tier-0 {DS.tier0_bytes(ds)} B; {card}")
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    lm_params = LM.init_params(cfg, torch.Generator(device=device)
                               .manual_seed(seed), device=device)
    out = RS.rag(cfg, lm_params, RS.make_prompt(cfg, device), ds, EX_GEN,
                 EX_EVERY)
    peak = (torch.cuda.max_memory_allocated(device) / 2 ** 30 if on_card
            else float("nan"))
    del lm_params
    take("23 rag full width")
    # the same search, and a wider one, for queries drawn from the corpus
    # (the example's queries are embedding rows, near the origin)
    cq = query_set(corpus, EX_RAG_QUERIES, seed=seed + 1)
    wide = dataclasses.replace(RS.RETRIEVE, candidates=EX_RAG_WIDE[0],
                               max_hops=EX_RAG_WIDE[1])
    near = {}
    for name, p in (("example", RS.RETRIEVE), ("wide", wide)):
        r = DS.device_anns(ds, torch.as_tensor(cq, device=ds.device), p)
        near[name] = {"queries": cq, "ids": r.ids.cpu().numpy(),
                      "dists": r.dists.cpu().numpy(),
                      "io": r.io.cpu().numpy(),
                      "tier0_hits": r.tier0_hits.cpu().numpy()}
    take("23 rag corpus queries")
    # the comparisons (not counted): the rounds against the plain round,
    # l2_tile at this width against its plain version, the recall truth
    # on the CPU's plain path
    err = max(against_ref(out["retrievals"] + [near["example"]], ds,
                          "rag at full width"),
              against_ref([near["wide"]], ds, "rag at full width", wide))
    l2_at_width(corpus, min(max(2 * params.graph.max_degree,
                                params.graph.build_beam), n - 1))
    qs = np.concatenate([g["queries"] for g in out["retrievals"]])
    got = np.concatenate([g["ids"] for g in out["retrievals"]])
    k = RS.RETRIEVE.k
    truth = D.brute_force_knn(corpus, qs, k, device="cpu")
    near_truth = D.brute_force_knn(corpus, cq, k, device="cpu")
    K.reset_all_launches()
    print(f"  rag at full width: {cfg.name}, {cfg.num_layers} layers, "
          f"d_model {cfg.d_model}, vocab {cfg.vocab_size}, params "
          f"{cfg.param_dtype}, compute {cfg.dtype}; {RS.BATCH} x "
          f"{RS.PROMPT_LEN} prompt tokens, {EX_GEN} generated, a retrieval "
          f"every {EX_EVERY}: {len(out['retrievals'])} retrievals and "
          f"{len(cq)} corpus queries at two beams equal the plain round's "
          f"(ids, io, tier0_hits), dists within {err:.3g}; recall@{k} "
          f"against the plain brute force: the example's queries "
          f"{recall(got, truth):.4f}; {len(cq)} queries drawn from the "
          f"corpus " + ", ".join(
              f"at Γ {p.candidates} / {p.max_hops} hops "
              f"{recall(near[name]['ids'], near_truth):.4f} (their nearest "
              f"found {recall(near[name]['ids'], near_truth[:, :1]):.4f})"
              for name, p in (("example", RS.RETRIEVE), ("wide", wide)))
          + f"; prefill "
          f"{out['prefill_ms']:.3f} ms, decode median "
          f"{np.median(out['decode_ms']):.3f} ms a step "
          f"({[round(v, 3) for v in out['decode_ms']]}); peak "
          f"{peak:.3f} GiB; {time.perf_counter() - t0:.3f} s; {card}")
    del out, corpus, seg, ds
    if on_card:
        torch.cuda.empty_cache()

    # 3. train_resume at rwkv6-1.6b's published widths, 2 layers (the
    # smoke width with the full configuration's remat and accumulation in
    # the CPU rehearsal)
    full = CONFIGS["rwkv6-1.6b"]
    cfg = (dataclasses.replace(full, num_layers=EX_TRAIN_LAYERS) if on_card
           else dataclasses.replace(SMOKE_CONFIGS["rwkv6-1.6b"],
                                    remat=full.remat,
                                    grad_accum=full.grad_accum))
    resume(cfg, "train_resume at full width")
    take("23 train full width")


def _leaves(tree):
    """The tensors of a tree, dict keys sorted (as the port flattens)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif torch.is_tensor(tree):
        yield tree


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cpu only to rehearse with the plain versions")
    ap.add_argument("--n", type=int, default=1_000_000,
                    help="segment size; smaller only to rehearse")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--against", nargs="+", default=[],
                    help="other copies of tier0_fetch.cu, pq_adc.cu or "
                         "block_topk.cu (an earlier commit's, variants; "
                         "the file name starts with the source's) to "
                         "build, hold bit for bit and time beside this "
                         "one")
    args = ap.parse_args()

    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: no src/repro_torch beside {__file__}: run it "
              f"from a checkout of the repository", file=sys.stderr)
        return 2
    if args.device == "cuda" and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    from repro_torch import kernels as K
    from repro_torch.core import device_search as DS
    from repro_torch.core import distances as D
    from repro_torch.core import graph as G
    from repro_torch.core import iostats as IO
    from repro_torch.core import layout as L
    from repro_torch.core.baseline import (build_hot_cache, vertex_anns,
                                           vertex_range_search)
    from repro_torch.core.delta import (DeltaSegment, swap_into_device_server,
                                        swap_into_host_server)
    from repro_torch.core import navgraph as NG
    from repro_torch.configs.starling_segment import (SEGMENT_BENCH_ASYNC,
                                                      SEGMENT_BENCH_CACHED,
                                                      SEGMENT_BENCH_DEVICE,
                                                      SERVE_REPACK)
    from repro_torch.core.params import DeviceSearchParams, HotTierParams
    from repro_torch.core.search import anns, range_search
    from repro_torch.core.segment import build_segment
    from repro_torch.data.vectors import clustered_vectors, query_set
    from repro_torch.io.cached_store import cached_view
    from repro_torch.io.hottier import build_hot_tier
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import block_topk as BT
    from repro_torch.kernels import l2_tile as L2
    from repro_torch.kernels import ops as KO
    from repro_torch.kernels import pq_adc as PQK
    from repro_torch.kernels import tier0_fetch as T0
    from repro_torch.core.params import RouterParams
    from repro_torch.distributed.compress import compressed_psum
    from repro_torch.distributed.elastic import plan_placement
    from repro_torch.distributed.sharding import (SINGLE_POD_RULES,
                                                  logical_spec, placements,
                                                  shard, use_rules)
    from repro_torch.launch.mesh import make_debug_mesh, rules_for
    from repro_torch.obs import (CalibrationPreset, CalibrationSample,
                                 MetricsRegistry, Tracer, WallClock,
                                 calibrate, fold_round_log, load_calibrated,
                                 round_log_totals, timeline_from_round_log,
                                 validate_chrome_trace, write_chrome_trace)
    from repro_torch.pq.pq import lut_batch, lut_host
    from repro_torch.serving.batcher import RequestBatcher
    from repro_torch.serving.coordinator import (SERVE_DEVICE_SEARCH,
                                                 HostSegmentServer,
                                                 QueryCoordinator,
                                                 SegmentServer,
                                                 attach_shared_fetch_queue,
                                                 merge_topk)
    from repro_torch.serving.router import MeshQueryRouter
    from repro_torch.serving.scheduler import RepackScheduler
    from torch.distributed.tensor import DTensor

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(args.device)
    on_card = device.type == "cuda"
    by_phase = {}                      # window -> {kernel: launches}

    def take(window: str) -> dict:
        """The launches since the last take (or reset), filed under
        ``window``; the counters restart at 0."""
        got = K.launch_counts()
        K.reset_all_launches()
        acc = by_phase.setdefault(window, dict.fromkeys(got, 0))
        for name, v in got.items():
            acc[name] += v
        return got

    with phase("1 card"):
        card = device_line(device) if on_card else "cpu rehearsal"
        print(f"card: {card}")
        if on_card:
            print(f"torch {torch.__version__} cuda {torch.version.cuda} "
                  f"devices {torch.cuda.device_count()}")

    with phase("2 build kernels"):
        if on_card:
            t0 = time.perf_counter()
            libs = _build.build()
            for name in libs:
                _build.load(name)
            print(f"built {sorted(libs)} in "
                  f"{time.perf_counter() - t0:.3f} s")
        else:
            print("skipped: the CPU rehearsal runs the plain versions")

    with phase("3 segment"):
        params = dataclasses.replace(
            SEGMENT_BENCH_DEVICE, graph=dataclasses.replace(
                SEGMENT_BENCH_DEVICE.graph, algo="nsg"))
        print("  reduction: disk graph NSG instead of Vamana (Vamana's "
              "sequential batched insertion does not fit this run at "
              f"n={args.n}; it is built at {VAMANA_N} in phase 4)")
        t0 = time.perf_counter()
        x = clustered_vectors(args.n, DIM, seed=args.seed)
        print(f"  vectors_s: {time.perf_counter() - t0:.3f}")
        K.reset_all_launches()
        sites = {}
        with l2_tile_by_call_site(sites, L2, KO, (
                (NG, "build_navgraph"), (D, "knn_graph"),
                (G, "_nearest_hosts"), (G, "greedy_search_batch"))):
            seg = build_segment(x, params, device=device)
        built = take("3 build")
        bt, info = seg.build_times, seg.build_info
        for k, v in bt.items():
            print(f"  {k}: {v:.3f}")
        print(f"  build total: {sum(bt.values()):.3f} s; kNN "
              f"{info['knn_s']:.3f} s = "
              f"{info['knn_s'] / bt['disk_graph_s']:.4f} of disk_graph_s;"
              f" prune {info['prune_s']:.3f} s; connectivity fix attached "
              f"{info['attached']} vertices")
        hist = info["or_history"]
        served_layout = ("BNF" if seg.overlap_ratio > hist[0]
                         else "BNP (BNF rounds rejected)")
        print(f"  OR(G): BNP {hist[0]:.4f}; after each BNF round "
              f"{[round(h, 4) for h in hist[1:]]}; kept "
              f"{seg.overlap_ratio:.4f}: the served layout is "
              f"{served_layout}")
        mem, disk = seg.memory_bytes(), seg.disk_bytes()
        print(f"  memory_bytes {mem} of {params.budget.memory_bytes} "
              f"(Eq. 10); disk_bytes {disk} of {params.budget.disk_bytes}; "
              f"check_budget {seg.check_budget()}")
        print(f"  l2_tile launches in the build: {built['l2_tile']}, "
              f"{sum(v[1] for v in sites.values())} operations (2·Q·N·D)")
        for path, (cnt, ops_, shapes) in sorted(sites.items()):
            top = sorted(shapes.items(), key=lambda kv: -kv[1])[:3]
            print(f"    in {path}: {cnt} launches, {ops_} operations, "
                  f"{len(shapes)} shapes; most launched "
                  f"{[(list(sh), k) for sh, k in top]}")
        check(sum(v[0] for v in sites.values()) == built["l2_tile"],
              "l2_tile launches outside ops.pairwise_l2 in the build")
        seg.layout.validate()
        check_graph(seg.graph, "disk graph")
        check(mem <= params.budget.memory_bytes
              and disk <= params.budget.disk_bytes, "over the space budget")
        if on_card:
            check(built["l2_tile"] > 0, "the build launched no l2_tile")
        print(f"  graph: avg degree {seg.graph.avg_degree():.3f}, entry "
              f"{seg.entry}; nav graph {seg.nav_ids.shape[0]} vertices")
        t0 = time.perf_counter()
        ds = DS.from_segment(seg, device=device)
        sync(device)
        print(f"  from_segment_s: {time.perf_counter() - t0:.3f}")
        nb = ds.nbytes()
        for k, v in nb.items():
            print(f"  {k}: {v} B")
        print(f"  device total: {sum(nb.values())} B; n={args.n} "
              f"rho={seg.num_blocks} eps={seg.vid.shape[1]} "
              f"hot={len(DS.hot_pack_blocks(ds))}")

    with phase("4 vamana"):
        nv = VAMANA_N if on_card else min(VAMANA_N, args.n // 4)
        xv = clustered_vectors(nv, DIM, seed=args.seed + 1)
        vstats = {}
        t0 = time.perf_counter()
        gv = G.build_vamana(xv, SEGMENT_BENCH_DEVICE.graph, device=device,
                            stats=vstats)
        tv = time.perf_counter() - t0
        eps_v = params.layout.verts_per_block(DIM, gv.max_degree)
        hv = []
        t0 = time.perf_counter()
        L.make_layout(gv, eps_v, "bnf", bnf_iters=params.layout.bnf_iters,
                      tau=params.layout.gain_tau, history=hv)
        print(f"  build_vamana n={nv}: {tv:.3f} s (beam search "
              f"{vstats['search_s']:.3f} s), avg degree "
              f"{gv.avg_degree():.3f}, connectivity fix attached "
              f"{vstats['attached']}; BNF {time.perf_counter() - t0:.3f} s, "
              f"OR(G) BNP {hv[0]:.4f} -> BNF {[round(h, 4) for h in hv[1:]]}")
        check_graph(gv, "vamana graph")
        del xv, gv
        take("4 vamana")

    p = SERVE_DEVICE_SEARCH
    nq = BATCH
    queries = query_set(x, nq * (BATCHES + 3), seed=1)
    batches = [queries[i * nq:(i + 1) * nq]
               for i in range(BATCHES + 3)]
    big = query_set(x, BIG_BATCH, seed=5)    # its own seed: the batches
    kern = {}                                # above stay those of before

    with phase("5 kernels against plain versions"):
        q0 = torch.as_tensor(batches[0], device=device)
        q0, _, st = DS.initial_state(ds, q0, p)
        fw = p.fetch_width
        u, _ = DS.pick_candidates(st["cand_id"], st["open_key"], fw)
        eps = ds.vid.shape[1]
        n_expand = DS.expansions(eps, fw, p.sigma)
        bq = T0.BQ
        b = ds.block_of[u.long().clamp_min(0)]
        r = b.numel()
        flush = (torch.empty(2 ** 27, dtype=torch.int32, device=device)
                 if on_card else None)               # 512 MB > L2
        args_g = (ds.vecs, ds.vid, ds.nbrs)

        got = T0.gather_union(b, *args_g)
        want = ref.gather_union_ref(b, *args_g)
        for name, g, w in zip(("uniq", "rank2d", "tiles", "vid", "nbrs"),
                              got, want):
            check(torch.equal(g, w), f"gather_union {name} differs")
        uniq, rank2d, tv, ti, tn = want
        ndist = int(torch.unique(b).numel())
        payload = eps * (DIM + 1 + ds.nbrs.shape[2]) * 4
        out_rows = r * payload
        kern["gather_union"] = {
            "max_abs_err": 0.0,
            "bytes": r * 4 + ndist * payload + 2 * r * 4 + out_rows,
            "ops": 0,
            "ms": time_ms(lambda: T0.gather_union(b, *args_g), device,
                          ITERS, flush),
            "plain_ms": time_ms(lambda: ref.gather_union_ref(b, *args_g),
                                device, ITERS, flush),
            "library_ms": time_ms(lambda: torch.unique(
                b.reshape(-1), sorted=True, return_inverse=True), device,
                ITERS, flush)}

        # the first round of a 4,096-query batch: R = 8,192
        qb4, _, st4 = DS.initial_state(
            ds, torch.as_tensor(big, device=device), p)
        u4, _ = DS.pick_candidates(st4["cand_id"], st4["open_key"], fw)
        b4 = ds.block_of[u4.long().clamp_min(0)]
        got = T0.gather_union(b4, *args_g)
        want = ref.gather_union_ref(b4, *args_g)
        for name, g, w in zip(("uniq", "rank2d", "tiles", "vid", "nbrs"),
                              got, want):
            check(torch.equal(g, w), f"gather_union {name} differs at "
                  f"R={b4.numel()}")
        del got, want
        ms4 = time_ms(lambda: T0.gather_union(b4, *args_g), device, ITERS,
                      flush)
        print(f"  gather_union at R={b4.numel()} "
              f"({int(torch.unique(b4).numel())} distinct): equal to the "
              f"plain version; {ms4:.6f} ms")
        del qb4, st4, u4, b4

        got = T0.gather_unique(uniq, *args_g)
        want = ref.gather_unique_ref(uniq, *args_g)
        for name, g, w in zip(("tiles", "vid", "nbrs"), got, want):
            check(torch.equal(g, w), f"gather_unique {name} differs")

        def three_selects():
            """The library's copy: one index_select per store array."""
            return tuple(torch.index_select(a, 0, uniq) for a in args_g)
        check(all(torch.equal(g, w) for g, w in zip(three_selects(), want)),
              "index_select does not compute the gather_unique function")
        kern["gather_unique"] = {
            "max_abs_err": 0.0,
            "bytes": r * 4 + ndist * payload + out_rows,
            "ops": 0,
            "ms": time_ms(lambda: T0.gather_unique(uniq, *args_g), device,
                          ITERS, flush),
            "plain_ms": time_ms(lambda: ref.gather_unique_ref(
                uniq, *args_g), device, ITERS, flush),
            "library_ms": time_ms(three_selects, device, ITERS, flush)}

        hot = (ds.hot_slot_of, ds.hot_vecs, ds.hot_vid, ds.hot_nbrs)
        u_idle = u.clone()
        u_idle[-bq:] = -1                      # one all-idle tile too
        err = 0.0
        rank_dd = []
        for case in (u, u_idle):
            rargs = (q0, case, rank2d, uniq, *hot, tv, ti, tn, n_expand)
            dd, vid, nbrs, hit, order = T0.fused_round_rank(*rargs, bq=bq)
            w = ref.fused_round_rank_ref(*rargs, bq=bq)
            for name, g, ww in zip(("vid", "nbrs", "hit"), (vid, nbrs, hit),
                                   w[1:4]):
                check(torch.equal(g, ww), f"fused_round_rank {name} differs")
            check(torch.allclose(dd, w[0], atol=1e-4, rtol=1e-5),
                  "fused_round_rank dd outside atol 1e-4 / rtol 1e-5")
            err = max(err, float((dd - w[0]).abs().max()))
            _, own = ref.selection_order(dd, vid, case, n_expand)
            live = torch.repeat_interleave(
                (case >= 0).reshape(-1, bq * fw).any(1), bq)
            own = torch.where(live[:, None], own, torch.zeros_like(own))
            rank_dd.append((dd, live))
            check(torch.equal(order, own),
                  "fused_round_rank order is not the stable argsort of "
                  "its own selection key")
            print(f"  rank: order equal to the plain order on "
                  f"{float((order == w[4]).all(1).float().mean()):.4f} "
                  f"of rows; idle rows {int((~live).sum())}")
        rargs = (q0, u, rank2d, uniq, *hot, tv, ti, tn, n_expand)
        rargs_idle = (q0, u_idle, rank2d, uniq, *hot, tv, ti, tn, n_expand)
        fe = fw * eps
        kern["fused_round_rank"] = {
            "max_abs_err": err,
            "bytes": (nq * DIM * 4 + 3 * r * 4 + ndist * (payload + 4)
                      + nq * fe * (2 + ds.nbrs.shape[2]) * 4
                      + nq * (fw + n_expand) * 4),
            "ops": 3 * nq * fe * DIM,
            "ms": time_ms(lambda: T0.fused_round_rank(*rargs, bq=bq),
                          device, ITERS, flush),
            "plain_ms": time_ms(lambda: ref.fused_round_rank_ref(
                *rargs, bq=bq), device, ITERS, flush),
            "library_ms": None}

        # tier0_fetch_rank on the same round: its queries, the target
        # blocks block_of[u], the 10% pack and the cold store
        t0_args = (q0, b, ds.hot_slot_of, ds.hot_vecs, ds.vecs)
        got_d, got_h = T0.tier0_fetch_rank(*t0_args)
        want_d, want_h = ref.tier0_fetch_rank_ref(*t0_args)
        check(torch.equal(got_h, want_h), "tier0_fetch_rank hit differs")
        check(torch.allclose(got_d, want_d, atol=1e-4, rtol=1e-5),
              "tier0_fetch_rank dists outside atol 1e-4 / rtol 1e-5")
        # one f32 order: on live rows the rank pass's distances are the
        # probe's, bit for bit (the same queries and target blocks)
        for dd, live in rank_dd:
            check(torch.equal(dd[live].view(torch.int32),
                              got_d[live].view(torch.int32)),
                  "fused_round_rank dd is not tier0_fetch_rank's bit for bit")
        print(f"  fused_round_rank dd equals tier0_fetch_rank's bit for bit "
              f"on {int(rank_dd[0][1].sum())} and {int(rank_dd[1][1].sum())}"
              f" live rows")
        kern["tier0_fetch_rank"] = {
            "max_abs_err": float((got_d - want_d).abs().max()),
            "bytes": (nq * DIM * 4 + 2 * r * 4 + ndist * eps * DIM * 4
                      + nq * fe * 4 + r * 4),
            "ops": 3 * nq * fe * DIM,
            "ms": time_ms(lambda: T0.tier0_fetch_rank(*t0_args), device,
                          ITERS, flush),
            "plain_ms": time_ms(lambda: ref.tier0_fetch_rank_ref(*t0_args),
                                device, ITERS, flush),
            "library_ms": None}
        print(f"  tier0_fetch_rank: {int(got_h.sum())} of {r} targets hot")
        # and at a wide round: 128 queries x 16 seeded target blocks
        rng_w = torch.Generator(device="cpu").manual_seed(args.seed + 6)
        b_w = torch.randint(0, seg.num_blocks, (WIDE_Q, WIDE_F),
                            generator=rng_w, dtype=torch.int32).to(device)
        t0_wide = (q0[:WIDE_Q].contiguous(), b_w, ds.hot_slot_of,
                   ds.hot_vecs, ds.vecs)
        got_d, got_h = T0.tier0_fetch_rank(*t0_wide)
        want_d, want_h = ref.tier0_fetch_rank_ref(*t0_wide)
        check(torch.equal(got_h, want_h) and torch.allclose(
            got_d, want_d, atol=1e-4, rtol=1e-5), "tier0_fetch_rank at "
            f"[{WIDE_Q} x {WIDE_F}] outside atol 1e-4 / rtol 1e-5 or hit "
            "differs")
        r_w = WIDE_Q * WIDE_F
        wide_bytes = (WIDE_Q * DIM * 4 + 2 * r_w * 4 + int(torch.unique(
            b_w).numel()) * eps * DIM * 4 + r_w * eps * 4 + r_w * 4)
        print(f"  tier0_fetch_rank at [{WIDE_Q} x {WIDE_F}] (F·ε = "
              f"{WIDE_F * eps}): within tolerance, {int(got_h.sum())} of "
              f"{r_w} hot; "
              f"{time_ms(lambda: T0.tier0_fetch_rank(*t0_wide), device, ITERS, flush):.6f}"
              f" ms, byte bound {wide_bytes / HBM_BYTES_PER_S * 1e3:.6f} ms")

        # block_topk on the tiles of that round (each query's first
        # target block) at top_m = n_expand, and at the kernel
        # micro-bench's shape [128, 16, 128], m = 5
        tiles_r = ds.vecs[b[:, 0].long()].contiguous()
        rng_m = torch.Generator(device="cpu").manual_seed(args.seed)
        q_m = torch.randn((128, DIM), generator=rng_m).to(device)
        t_m = torch.randn((128, 16, DIM), generator=rng_m).to(device)
        err = 0.0
        for qq, tt, m in ((q0, tiles_r, n_expand), (q_m, t_m, 5)):
            got_d, got_i = BT.block_topk(qq, tt, m)
            want_d, _ = ref.block_topk_ref(qq, tt, m)
            check(torch.allclose(got_d, want_d, atol=1e-3, rtol=1e-5),
                  "block_topk dists outside atol 1e-3 / rtol 1e-5")
            own = torch.argsort(got_d, dim=1, stable=True)[:, :m]
            check(torch.equal(got_i[:, :own.shape[1]], own.to(torch.int32))
                  and not bool(got_i[:, own.shape[1]:].any()),
                  "block_topk slots are not the stable order of its own "
                  "distances")
            err = max(err, float((got_d - want_d).abs().max()))
            ms = time_ms(lambda: BT.block_topk(qq, tt, m), device, ITERS,
                         flush)
            print(f"  block_topk [{qq.shape[0]} x {tt.shape[1]} x {DIM}] "
                  f"m={m}: {ms:.6f} ms")
        kern["block_topk"] = {
            "max_abs_err": err,
            "bytes": (nq * DIM * 4 + nq * eps * DIM * 4 + nq * eps * 4
                      + nq * n_expand * 4),
            "ops": 4 * nq * eps * DIM,
            "ms": time_ms(lambda: BT.block_topk(q0, tiles_r, n_expand),
                          device, ITERS, flush),
            "plain_ms": time_ms(lambda: ref.block_topk_ref(
                q0, tiles_r, n_expand), device, ITERS, flush),
            "library_ms": None}

        # l2_tile at the shape the build gives it: a kNN chunk of the
        # segment's own vectors against all of them
        xt = torch.as_tensor(x, device=device)
        chunk = D._row_chunk(args.n, device, KNN_CHUNK)
        rows = torch.as_tensor(np.sort(np.random.default_rng(
            args.seed).choice(args.n, min(KNN_ROWS, args.n), replace=False)),
            device=device)
        xc = xt[rows[:chunk]]
        got = L2.l2_tile(xc, xt)
        want = ref.pairwise_l2_ref(xc, xt)
        err = float((got - want).abs().max())
        check(torch.allclose(got, want, atol=L2_ATOL, rtol=L2_RTOL),
              f"l2_tile outside atol {L2_ATOL} / rtol {L2_RTOL}")
        del got, want
        # the kNN of sampled vertices, kernel path against plain path,
        # in the build's chunks
        kk = min(max(2 * params.graph.max_degree, params.graph.build_beam),
                 args.n - 1)
        clear = same_set = same_order = 0
        for s in range(0, rows.numel(), chunk):
            xr = xt[rows[s:s + chunk]]
            ik = D.topk_smallest(L2.l2_tile(xr, xt), kk + 1)
            dp = ref.pairwise_l2_ref(xr, xt)
            ip = D.topk_smallest(dp, kk + 1)
            vp = torch.gather(dp, 1, ip)
            del dp
            ok = (vp[:, kk] - vp[:, kk - 1]) > L2_ATOL
            eq = (torch.sort(ik[:, :kk], 1).values
                  == torch.sort(ip[:, :kk], 1).values).all(1)
            check(bool(eq[ok].all()), "l2_tile kNN ids differ from the "
                  "plain path's where the k-th gap exceeds the tolerance")
            clear += int(ok.sum())
            same_set += int(eq.sum())
            same_order += int((ik[:, :kk] == ip[:, :kk]).all(1).sum())
        print(f"  l2_tile kNN (k={kk}) on {rows.numel()} vertices: same id "
              f"set {same_set}, same order {same_order}; "
              f"{clear} rows with a k-th gap > {L2_ATOL} (all equal)")
        big_iters = 10
        mc = xc.shape[0]
        kern["l2_tile"] = {
            "max_abs_err": err,
            "bytes": (mc + args.n) * DIM * 4 + mc * args.n * 4,
            "ops": 2 * mc * args.n * DIM,
            "ms": time_ms(lambda: L2.l2_tile(xc, xt), device, big_iters,
                          flush),
            "plain_ms": time_ms(lambda: ref.pairwise_l2_ref(xc, xt), device,
                                big_iters, flush),
            # torch.cdist: the same matrix, plus a square root
            "library_ms": time_ms(lambda: torch.cdist(
                xc, xt, compute_mode="use_mm_for_euclid_dist"), device,
                big_iters, flush)}
        print(f"  l2_tile held and timed at [{mc} x {args.n} x {DIM}] (the "
              f"build's kNN chunk)")

        # pq_adc: the segment's codes against a 1,024-query batch's LUTs
        ql = torch.as_tensor(batches[0], device=device)
        luts = lut_batch(ql, torch.as_tensor(seg.pq_cent, device=device),
                         seg.metric)
        codes = ds.pq_codes
        got = PQK.pq_adc(codes, luts)
        want = ref.pq_adc_ref(luts, codes)
        check(torch.equal(got, want), "pq_adc differs from its plain "
              "version (the same f32 order: it must be equal)")
        m_sub, k_cent = luts.shape[1], luts.shape[2]
        # the library call: one embedding_bag, the LUTs as a [M*K, B]
        # table, each code row a bag of M offsets (out [N, B], the TPU
        # kernel's own layout); index and table made outside the timing
        bag_idx = codes.long() + torch.arange(
            m_sub, device=device) * k_cent
        bag_w = luts.permute(1, 2, 0).reshape(m_sub * k_cent, nq).contiguous()
        lib = torch.nn.functional.embedding_bag(bag_idx, bag_w, mode="sum")
        check(torch.allclose(lib.T, want, rtol=1e-4, atol=1e-3),
              "embedding_bag does not compute the pq_adc function")
        del lib
        kern["pq_adc"] = {
            "max_abs_err": float((got - want).abs().max()),
            "bytes": (args.n * m_sub + nq * m_sub * k_cent * 4
                      + nq * args.n * 4),
            "ops": nq * args.n * m_sub,
            "ms": time_ms(lambda: PQK.pq_adc(codes, luts), device, big_iters,
                          flush),
            "plain_ms": time_ms(lambda: ref.pq_adc_ref(luts, codes), device,
                                big_iters, flush),
            "library_ms": time_ms(lambda: torch.nn.functional.embedding_bag(
                bag_idx, bag_w, mode="sum"), device, big_iters, flush)}
        del got, want, bag_idx, bag_w
        for name, k in kern.items():
            k["bound_ms"] = max(k["bytes"] / HBM_BYTES_PER_S,
                                k["ops"] / F32_OPS_PER_S) * 1e3
            k["bound_by"] = ("bytes" if k["bytes"] / HBM_BYTES_PER_S
                             >= k["ops"] / F32_OPS_PER_S else "operations")
            print(f"  {name}: ms={k['ms']:.6f} plain_ms={k['plain_ms']:.6f}"
                  f" bound_ms={k['bound_ms']:.6f} library_ms="
                  f"{k['library_ms']} max_abs_err={k['max_abs_err']:.3e} "
                  f"bound_by={k['bound_by']}")
        print(f"  round inputs: R={r}, distinct={ndist}")
        for name, k in kern.items():
            share = k["bound_ms"] / k["ms"]
            print(f"  {name}: {share:.4f} of its bound ({k['bound_by']})")
            check(0 < share <= 1, f"{name} beat its own bound: the "
                  "count or the timing is wrong")
        print(f"  l2_tile at the kNN chunk: "
              f"{kern['l2_tile']['ops'] / kern['l2_tile']['ms'] / 1e9:.3f} "
              f"TFLOP/s f32 against {F32_OPS_PER_S / 1e12:.0f}")

        # what the timing itself costs: an empty launch under the same
        # protocol; and the round kernels with their inputs left in L2,
        # as the round's previous kernel leaves them
        floor = time_ms(lambda: torch.cuda._sleep(0), device, ITERS, flush) \
            if on_card else float("nan")
        print(f"  timing floor (an empty launch, L2 flushed): {floor:.6f} ms")
        # pq_adc at the host search's shape (A3): one query's LUT against
        # the codes of one hop's neighbours
        codes_h = codes[:ADC_HOST].contiguous()
        luts_h = luts[:1].contiguous()
        check(torch.equal(PQK.pq_adc(codes_h, luts_h),
                          ref.pq_adc_ref(luts_h, codes_h)),
              "pq_adc differs from its plain version at 1 x 64")
        host_bytes = ADC_HOST * m_sub + m_sub * k_cent * 4 + ADC_HOST * 4
        print(f"  pq_adc at [1 x {ADC_HOST}] (the host search's call): "
              f"{time_ms(lambda: PQK.pq_adc(codes_h, luts_h), device, ITERS, flush):.6f}"
              f" ms against the floor {floor:.6f} ms (byte bound "
              f"{host_bytes / HBM_BYTES_PER_S * 1e3:.6f} ms)")
        for name, fn in (
                ("gather_union", lambda: T0.gather_union(b, *args_g)),
                ("gather_unique", lambda: T0.gather_unique(uniq, *args_g)),
                ("fused_round_rank", lambda: T0.fused_round_rank(
                    *rargs, bq=bq)),
                ("tier0_fetch_rank", lambda: T0.tier0_fetch_rank(*t0_args)),
                (f"tier0_fetch_rank [{WIDE_Q} x {WIDE_F}]",
                 lambda: T0.tier0_fetch_rank(*t0_wide)),
                ("block_topk", lambda: BT.block_topk(q0, tiles_r, n_expand)),
                (f"pq_adc [1 x {ADC_HOST}]", lambda: PQK.pq_adc(codes_h,
                                                                luts_h))):
            print(f"  {name} with its inputs in L2: "
                  f"{time_ms(fn, device, ITERS):.6f} ms")

        if args.against:
            # other builds of the sources through the same wrappers: the
            # same bits on the same inputs, timed in turns
            runs = {"tier0_fetch": {
                "gather_union": lambda: T0.gather_union(b, *args_g),
                "gather_unique": lambda: T0.gather_unique(uniq, *args_g),
                "fused_round_rank": lambda: T0.fused_round_rank(
                    *rargs, bq=bq),
                "fused_round_rank (idle tile)": lambda: T0.
                fused_round_rank(*rargs_idle, bq=bq),
                "tier0_fetch_rank": lambda: T0.tier0_fetch_rank(*t0_args),
                f"tier0_fetch_rank [{WIDE_Q} x {WIDE_F}]": lambda: T0.
                tier0_fetch_rank(*t0_wide)},
                "pq_adc": {
                "pq_adc": lambda: adc(codes, luts),
                f"pq_adc [1 x {ADC_HOST}]": lambda: adc(codes_h, luts_h)},
                "block_topk": {
                f"block_topk [{nq} x {eps} x {DIM}] m={n_expand}":
                lambda: BT.block_topk(q0, tiles_r, n_expand),
                f"block_topk [128 x 16 x {DIM}] m=5":
                lambda: BT.block_topk(q_m, t_m, 5)}}

            legacy = []

            def adc(c, lt):
                """``PQK.pq_adc``; a copy of PR 15's pq_adc.cu (a CTA per
                row tile x at most 8 queries) swapped in is called with
                that PR's wrapper's query tile."""
                lib = _build.load("pq_adc")
                if not any(lib is x for x in legacy):
                    return PQK.pq_adc(c, lt)
                (n_, m_), (b_, _, k_) = c.shape, lt.shape
                o = torch.empty((b_, n_), dtype=torch.float32, device=device)
                _build.check(lib.pq_adc(
                    c.data_ptr(), lt.data_ptr(), n_, m_, k_, b_,
                    max(1, min(b_, 96 * 1024 // (m_ * k_ * 4), 8)),
                    o.data_ptr(), _build.stream()), "pq_adc")
                return o

            def bits(t):
                t = t if isinstance(t, tuple) else (t,)
                return [a.view(torch.int32) if a.is_floating_point() else a
                        for a in t]

            for path in args.against:
                name_src = next((n for n in runs
                                 if os.path.basename(path).startswith(n)),
                                None)
                check(name_src is not None, f"--against {path}: the file "
                      f"name starts with none of {sorted(runs)}")
                other = _build.load_source(name_src, path)
                if name_src == "pq_adc" and "ROWS_PER_CTA" in open(
                        path).read():
                    legacy.append(other)
                for name, fn in runs[name_src].items():
                    mine = fn()
                    with _build.swapped(name_src, other):
                        theirs = fn()
                    check(all(torch.equal(a, o)
                              for a, o in zip(bits(mine), bits(theirs))),
                          f"{name} differs from {path}'s")
                    turns = []
                    for fl in (flush, None):      # from HBM, then in L2
                        for which in ("other", "this", "this", "other"):
                            with (_build.swapped(name_src, other)
                                  if which == "other"
                                  else contextlib.nullcontext()):
                                turns.append(time_ms(
                                    fn, device,
                                    big_iters if name == "pq_adc" else ITERS,
                                    fl))
                    print(f"  against {path}: {name} bit-identical; ms other "
                          f"{turns[0]:.6f} this {turns[1]:.6f} this "
                          f"{turns[2]:.6f} other {turns[3]:.6f}; inputs in "
                          f"L2: other {turns[4]:.6f} this {turns[5]:.6f} "
                          f"this {turns[6]:.6f} other {turns[7]:.6f}")
        del flush
        K.reset_all_launches()          # phase 5's comparisons: not counted

    with phase("6 serve"):
        srv = SegmentServer(segment=ds, offset=0,
                            num_vectors=seg.num_vectors, params=p,
                            device=args.device)

        def oracle(qb):
            """Exact top-10 through the l2_tile kernel."""
            return D.brute_force_knn(xt, qb, 10, device=device)

        def serve(qb, server):
            sync(device)
            t0 = time.perf_counter()
            ids, dists, _ = server.search(qb, 10)
            sync(device)
            return ids, dists, (time.perf_counter() - t0) * 1e3

        def check_results(qb, ids, dists, table=None):
            """Shape, finiteness, ascending distances, no repeated id,
            and each distance the exact one of its id in ``table`` (the
            segment's vectors by default; f32 sums in another order:
            rtol 1e-4, atol 1e-3)."""
            table = xt if table is None else table
            rows = qb.shape[0]
            check(ids.shape == (rows, 10) and dists.shape == (rows, 10),
                  f"result shapes {ids.shape} {dists.shape}")
            check(bool((ids >= 0).all() and np.isfinite(dists).all()),
                  "a query returned fewer than 10 results")
            check(bool((np.diff(dists, axis=1) >= 0).all()),
                  "distances are not ascending")
            check(all(len(set(r.tolist())) == 10 for r in ids),
                  "a query returned an id twice")
            qt = torch.as_tensor(qb, device=device)
            it = torch.as_tensor(ids, device=device).long()
            exact = torch.sum(torch.square(table[it] - qt[:, None, :]),
                              dim=-1)
            check(torch.allclose(torch.as_tensor(dists, device=device),
                                 exact, rtol=1e-4, atol=1e-3),
                  "returned distances are not the ids' exact distances")

        serve(batches[0], srv)                       # warm-up
        take("6 warm-up")
        if on_card:
            torch.cuda.reset_peak_memory_stats(device)
        rounds, served, lat, batch_st, folds = [], [], [], [], []
        for i in range(1, BATCHES + 1):
            ids, dists, ms = serve(batches[i], srv)
            st = srv.batch_stats()
            batch_st.append(st)
            rounds.append(st["rounds"])
            served.append((ids, dists))
            lat.append(ms)
            folds.append(fold_batch(st, IO))
            print(f"  batch {i}: {ms:.3f} ms, {nq / ms * 1e3:.1f} QPS, "
                  f"rounds {st['rounds']}, io {st['io'].mean():.3f}, "
                  f"tier0_hits {st['tier0_hits'].mean():.3f}, "
                  f"dedup_saved {st['dedup_saved'].mean():.3f} per query")
        served_launches = take("6 served")
        for i, (st, fo) in enumerate(zip(batch_st, folds), start=1):
            check(fo.block_reads == int(st["io"].sum() + st["tier0_hits"]
                                        .sum())
                  and fo.hops == int(st["hops"].sum())
                  and fo.batch_rounds == st["rounds"],
                  f"batch {i}'s IOStats fold does not hold its columns")
            print(f"  batch {i} folded: block_reads {fo.block_reads}, "
                  f"io_round_trips {fo.io_round_trips}, batch_rounds "
                  f"{fo.batch_rounds}, rounds_active_weight "
                  f"{fo.rounds_active_weight:.6f}")
        merged = IO.IOStats()
        for fo in folds:
            merged.merge(fo)
        print(f"  {BATCHES} batches folded and merged: block_reads "
              f"{merged.block_reads}, io_round_trips "
              f"{merged.io_round_trips}, tier0_hits {merged.tier0_hits}, "
              f"dedup_saved_fetches {merged.dedup_saved_fetches}, "
              f"dedup_cross_tile {merged.dedup_cross_tile}, hops "
              f"{merged.hops}, batch_rounds {merged.batch_rounds} (the "
              f"longest batch), rounds_active_weight (summed) "
              f"{merged.rounds_active_weight:.6f}, dma_pipelined "
              f"{merged.dma_pipelined}")
        print(f"  batch ms median {np.median(lat):.3f} max {max(lat):.3f}"
              f" ({BATCHES} batches); QPS at the median "
              f"{nq / np.median(lat) * 1e3:.1f}; ms per round "
              f"{sum(lat) / sum(rounds):.3f}")
        if on_card:
            print(f"  max_memory_allocated "
                  f"{torch.cuda.max_memory_allocated(device)} B")
        truth = []
        for i, (ids, dists) in enumerate(served, start=1):
            check_results(batches[i], ids, dists)
            truth.append(oracle(batches[i]))
        rec = recall(np.concatenate([s[0] for s in served]),
                     np.concatenate(truth))
        io = np.mean([s["io"].mean() for s in batch_st])
        print(f"  recall@10 {rec:.4f} over {nq * BATCHES} queries (built "
              f"segment: NSG, {served_layout}); per query io {io:.3f}, "
              f"tier0_hits "
              f"{np.mean([s['tier0_hits'].mean() for s in batch_st]):.3f}, "
              f"dedup_saved "
              f"{np.mean([s['dedup_saved'].mean() for s in batch_st]):.3f}")
        print(f"  launches {served_launches}, rounds {sum(rounds)}")
        if on_card:
            check(served_launches["gather_union"] == sum(rounds) > 0
                  and served_launches["fused_round_rank"] == sum(rounds),
                  "main-path launches do not follow the rounds")

        take("6 oracle")

        # the two-pass union path on the next batch
        srv2 = dataclasses.replace(
            srv, params=dataclasses.replace(p, fuse_union=False))
        ids_f, _, _ = serve(batches[BATCHES + 1], srv)
        take("6 two-pass: the fused twin")
        ids_2, _, ms = serve(batches[BATCHES + 1], srv2)
        r2 = srv2.batch_stats()["rounds"]
        two_pass = take("6 two-pass")
        print(f"  two-pass union batch: {ms:.3f} ms, rounds {r2}, "
              f"launches {two_pass}")
        check(np.array_equal(ids_f, ids_2),
              "fuse_union=False changed the ids")
        if on_card:
            check(two_pass["gather_unique"] == r2 > 0
                  and two_pass["gather_union"] == 0,
                  "two-pass launches do not follow the rounds")

        # the first batch again with the round log on: the same ids and
        # fold, and the log ties to the fold
        srv_t = dataclasses.replace(
            srv, params=dataclasses.replace(p, trace_rounds=True))
        ids_t, _, _ = serve(batches[1], srv_t)
        traced = take("6 traced batch")
        st_t = srv_t.batch_stats()
        fo_t = fold_batch(st_t, IO)
        check(np.array_equal(ids_t, served[0][0])
              and dataclasses.asdict(fo_t) == dataclasses.asdict(folds[0]),
              "trace_rounds changed the ids or the counters")
        recs = fold_round_log(srv_t.last_round_log, st_t["rounds"])
        tot = round_log_totals(recs)
        ties = {
            "len(records) == batch_rounds": tot["rounds"] == fo_t.batch_rounds,
            "sum(live) == hops": tot["hops"] == fo_t.hops,
            "sum(cold) == io": tot["io"] == fo_t.cache_misses,
            "sum(tier0) == tier0_hits": tot["tier0_hits"] == fo_t.tier0_hits,
            "sum(joins) == dedup_saved":
                tot["dedup_saved"] == fo_t.dedup_saved_fetches,
            "sum(joins_x) == dedup_cross":
                tot["dedup_cross"] == fo_t.dedup_cross_tile,
            "sum(spec_hits) == spec_hits":
                tot["spec_hits"] == int(st_t["spec_hits"].sum()),
            "sum(spec_wasted) == spec_wasted":
                tot["spec_wasted"] == fo_t.spec_wasted,
            "sum(live) / rounds == rounds_active_weight": math.isclose(
                tot["live_weight"] / max(tot["rounds"], 1),
                fo_t.rounds_active_weight, rel_tol=1e-9)}
        for what, ok in ties.items():
            check(ok, f"round log: {what} does not hold")
        print(f"  traced batch: ids and fold equal the untraced run's; "
              f"{len(recs)} rounds, live {recs[0].live} -> {recs[-1].live},"
              f" {tot['compactions']} compactions, cold {tot['io']}, tier0 "
              f"{tot['tier0_hits']}, joins {tot['dedup_saved']} "
              f"(cross-tile {tot['dedup_cross']}); {len(ties)} ties hold")
        if on_card:
            check(traced["gather_union"] == st_t["rounds"]
                  and traced["fused_round_rank"] == st_t["rounds"],
                  "traced-batch launches do not follow the rounds")
        # pq_adc, tier0_fetch_rank and block_topk are the kernel API's
        # entries (ops): the counts over every phase say whether one
        # called them

    with phase("7 kernel path against plain path"):
        qb = batches[BATCHES + 2]
        srv_ref = dataclasses.replace(
            srv, params=dataclasses.replace(p, fetch_impl="ref"))
        ids_k, d_k, ms_k = serve(qb, srv)
        ids_r, d_r, ms_r = serve(qb, srv_ref)
        check_results(qb, ids_k, d_k)
        check_results(qb, ids_r, d_r)
        t = oracle(qb)
        # the oracle's ids against the plain oracle's (pairwise_l2_ref):
        # equal sets wherever the 10th/11th gap exceeds the tolerance
        qbt = torch.as_tensor(qb, device=device)
        dp = ref.pairwise_l2_ref(qbt, xt)
        ip = D.topk_smallest(dp, 11)
        vp = torch.gather(dp, 1, ip).cpu().numpy()
        del dp
        same = (np.sort(t, 1) == np.sort(ip[:, :10].cpu().numpy(), 1)).all(1)
        clear = (vp[:, 10] - vp[:, 9]) > L2_ATOL
        check(bool(same[clear].all()), "the oracle's ids differ from the "
              "plain oracle's")
        print(f"  oracle: ids equal to the plain oracle's on "
              f"{int(same.sum())} of {nq} queries ({int(clear.sum())} with "
              f"a 10th/11th gap > {L2_ATOL}, all equal)")
        rk, rr = recall(ids_k, t), recall(ids_r, t)
        agree = float((ids_k == ids_r).all(1).mean())
        print(f"  kernel path {ms_k:.3f} ms recall {rk:.4f}; plain path "
              f"{ms_r:.3f} ms recall {rr:.4f}; ids agree on {agree:.4f} "
              f"of queries")
        check(abs(rk - rr) <= 0.01, "kernel and plain recall differ "
              "by more than 0.01")
        take("7 kernel path against plain path")

    with phase("8 profile one batch"):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if on_card:
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            _, _, ms = serve(qb, srv)
        take("8 profile")
        rows = prof.key_averages()
        busy_ms = sum(getattr(e, "self_device_time_total", 0)
                      for e in rows) / 1e3
        print(f"  wall {ms:.3f} ms (profiled), device busy {busy_ms:.3f} ms"
              + (f", idle share {1 - busy_ms / ms:.4f}" if on_card
                 else " (not measured on the CPU)"))
        for what, key in (("device", lambda e: getattr(
                e, "self_device_time_total", 0)),
                ("host", lambda e: e.self_cpu_time_total)):
            print(f"  top ops by {what} time:")
            for e in sorted(rows, key=lambda e: -key(e))[:8]:
                print(f"    {e.key[:56]:56s} calls {e.count:6d} device "
                      f"{getattr(e, 'self_device_time_total', 0) / 1e3:9.3f}"
                      f" ms host {e.self_cpu_time_total / 1e3:9.3f} ms")

    # the new phases' queries: a second seeded set, so the batches of
    # phases 5-8 stay those of earlier runs
    extra = query_set(x, nq * (RANGE_BATCHES + HYBRID_BATCHES + 1), seed=2)
    extra = [extra[i * nq:(i + 1) * nq]
             for i in range(RANGE_BATCHES + HYBRID_BATCHES + 1)]

    with phase("9 range"):
        k_cap, rs_rounds = 256, 3
        q_r = torch.as_tensor(extra[0], device=device)
        nn10 = torch.as_tensor(oracle(extra[0])[:, 9], device=device).long()
        d10 = torch.sum(torch.square(xt[nn10] - q_r), dim=-1)
        radius = float(torch.median(d10))
        print(f"  radius {radius:.6f}: the median 10th-NN distance of the "
              f"first batch (l2_tile oracle)")
        take("9 radius")
        ranged, rs_total = [], 0
        for qb in extra[:RANGE_BATCHES]:
            qt = torch.as_tensor(qb, device=device)
            sync(device)
            t0 = time.perf_counter()
            rr = DS.device_range_search(ds, qt, radius, k_cap=k_cap, p=p,
                                        rounds=rs_rounds)
            sync(device)
            ms = (time.perf_counter() - t0) * 1e3
            ranged.append(rr)
            rs_total += rr.rounds
            print(f"  batch: {ms:.3f} ms, rounds {rr.rounds}, io "
                  f"{float(rr.io.float().mean()):.3f}, tier0_hits "
                  f"{float(rr.tier0_hits.float().mean()):.3f}, in range "
                  f"{float(rr.in_range.sum(1).float().mean()):.3f} per query")
        rs_launch = take("9 range")
        print(f"  launches {rs_launch}, rounds {rs_total}")
        if on_card:
            check(rs_launch["gather_union"] == rs_total > 0
                  and rs_launch["fused_round_rank"] == rs_total,
                  "range launches do not follow the rounds")
        hits = want_n = capped = 0
        for qb, rr in zip(extra[:RANGE_BATCHES], ranged):
            qt = torch.as_tensor(qb, device=device)
            inr = rr.in_range
            ids_r = rr.ids.long()
            check(bool((ids_r[inr] >= 0).all()), "an in-range slot is empty")
            check(bool((rr.dists[inr] <= radius).all()),
                  "an in-range distance exceeds the radius")
            exact = torch.sum(torch.square(
                xt[ids_r.clamp_min(0)] - qt[:, None, :]), dim=-1)
            check(torch.allclose(rr.dists[inr], exact[inr], rtol=1e-4,
                                 atol=1e-3),
                  "in-range distances are not the ids' exact distances")
            gt = D.brute_force_range(xt, qt, radius, device=device)
            got_ids = ids_r.cpu().numpy()
            got_in = inr.cpu().numpy()
            for row, inrow, want in zip(got_ids, got_in, gt):
                got_set = set(row[inrow].tolist())
                check(len(got_set) == int(inrow.sum()),
                      "an in-range id repeats")
                hits += len(got_set & set(want.tolist()))
                want_n += len(want)
                capped += min(len(want), k_cap)
        sizes = [len(w) for w in gt]
        print(f"  range recall {hits / max(want_n, 1):.4f} ({hits} of "
              f"{want_n} in-range ids of the brute force; "
              f"{hits / max(capped, 1):.4f} of the {capped} a k_cap="
              f"{k_cap} result can hold); brute-force in-range ids per "
              f"query of the last batch: median {int(np.median(sizes))}, "
              f"max {max(sizes)}")
        qt = torch.as_tensor(extra[0], device=device)
        scratch = {c: float(DS.device_anns(ds, qt, dataclasses.replace(
            p, k=c, candidates=c)).io.float().mean()) for c in (64, 128, 256)}
        io3, io_scratch = float(ranged[0].io.float().mean()), sum(
            scratch.values())
        print(f"  io per query after 3 rounds {io3:.3f}; from scratch at "
              f"Γ 64/128/256 {scratch}; ratio {io3 / io_scratch:.4f}")
        check(io3 < io_scratch, "range io is not below three from-scratch "
              "searches")
        take("9 brute force and from-scratch searches")

    with phase("10 repack"):
        observed = {}
        for ids, _ in served:
            blk = seg.block_of[ids[ids >= 0]]
            for bb, cnt in zip(*np.unique(blk, return_counts=True)):
                observed[int(bb)] = observed.get(int(bb), 0) + int(cnt)
        srv_h = SegmentServer(segment=ds, offset=0,
                              num_vectors=seg.num_vectors, params=p,
                              device=args.device, host=seg)
        qb = extra[RANGE_BATCHES]
        ids0, d0, _ = serve(qb, srv_h)
        st0 = srv_h.batch_stats()
        t0 = time.perf_counter()
        changed = srv_h.repack(observed)
        sync(device)
        print(f"  repack of {len(DS.hot_pack_blocks(ds))} slots from the "
              f"demand of {len(observed)} blocks: changed {changed} in "
              f"{(time.perf_counter() - t0) * 1e3:.3f} ms")
        check(changed > 0, "the repack changed no slot")
        ids1, d1, _ = serve(qb, srv_h)
        st1 = srv_h.batch_stats()
        take("10 repack")
        check_results(qb, ids0, d0)
        check(np.array_equal(ids0, ids1) and np.array_equal(d0, d1),
              "the repack changed the results")
        check(np.array_equal(st0["io"] + st0["tier0_hits"],
                             st1["io"] + st1["tier0_hits"]),
              "the repack changed io + tier0_hits")
        print(f"  tier0_hits per query {st0['tier0_hits'].mean():.3f} -> "
              f"{st1['tier0_hits'].mean():.3f}; io {st0['io'].mean():.3f} "
              f"-> {st1['io'].mean():.3f}")
        new = srv_h.segment
        packed = torch.nonzero(new.hot_slot_of >= 0).squeeze(1)
        slot = new.hot_slot_of[packed].long()
        check(torch.equal(new.hot_vecs[slot], new.vecs[packed])
              and torch.equal(new.hot_vid[slot], new.vid[packed])
              and torch.equal(new.hot_nbrs[slot], new.nbrs[packed]),
              "the new pack is not an exact copy of its blocks")
        del srv_h, new

    with phase("11 hybrid"):
        sync(device)
        t0 = time.perf_counter()
        hot = build_hot_tier(seg, HotTierParams(), device=device)
        sync(device)
        print(f"  build_hot_tier: {hot.size} vectors, degree "
              f"{hot.adj.shape[1]} (avg {hot.deg[:hot.size].mean():.3f}), "
              f"{time.perf_counter() - t0:.3f} s, memory_bytes "
              f"{hot.memory_bytes()}")
        hyb = SegmentServer(segment=ds, offset=0,
                            num_vectors=seg.num_vectors, params=p,
                            device=args.device, host=seg, hot_tier=hot)
        hb = extra[RANGE_BATCHES + 1:RANGE_BATCHES + 1 + HYBRID_BATCHES]
        serve(hb[0], hyb)                                   # warm-up
        plain_ms, hyb_ms, plain_ids, hyb_ids, hot_hits = [], [], [], [], []
        for qb in hb:
            ids_p, d_p, ms_p = serve(qb, srv)
            io_p = srv.batch_stats()["io"].mean()
            rounds_p = srv.batch_stats()["rounds"]
            ids_h, d_h, ms_h = serve(qb, hyb)
            st = hyb.batch_stats()
            check_results(qb, ids_p, d_p)
            check_results(qb, ids_h, d_h)
            plain_ms.append(ms_p)
            hyb_ms.append(ms_h)
            plain_ids.append(ids_p)
            hyb_ids.append(ids_h)
            hot_hits.append(st["hot_tier_hits"].mean())
            print(f"  batch: plain {ms_p:.3f} ms, hybrid {ms_h:.3f} ms; "
                  f"rounds {rounds_p} -> {st['rounds']}; io {io_p:.3f} -> "
                  f"{st['io'].mean():.3f}, hot_tier_hits "
                  f"{st['hot_tier_hits'].mean():.3f} per query")
        truth_h = np.concatenate([oracle(qb) for qb in hb])
        rec_p = recall(np.concatenate(plain_ids), truth_h)
        rec_h = recall(np.concatenate(hyb_ids), truth_h)
        print(f"  recall@10 plain {rec_p:.4f} hybrid {rec_h:.4f}; batch "
              f"ms median plain {np.median(plain_ms):.3f} hybrid "
              f"{np.median(hyb_ms):.3f}; hot_tier_hits "
              f"{np.mean(hot_hits):.3f} per query")

        # inserts, then 1% of the base tombstoned in both tiers
        # (the pool of earlier runs' 1,024; the first INSERTS go in)
        new_v = query_set(x, INSERT_POOL, seed=3)
        gids = np.arange(args.n, args.n + INSERTS)
        sync(device)
        t0 = time.perf_counter()
        hot.insert(new_v[:INSERTS], gids)
        sync(device)
        ins_s = time.perf_counter() - t0
        dead = np.random.default_rng(args.seed + 4).choice(
            args.n, args.n // 100, replace=False)
        tomb = np.zeros(args.n, bool)
        tomb[dead] = True
        in_hot = sum(hot.delete(int(g)) for g in dead)
        print(f"  insert {INSERTS}: {ins_s:.3f} s ({ins_s / INSERTS * 1e3:.3f}"
              f" ms each); tombstoned {dead.size} base ids, {in_hot} of them"
              f" hot; hot tier size {hot.size}, live {hot.live_count}")
        hyb = dataclasses.replace(hyb, tombstones=tomb)
        table = torch.cat([xt, torch.as_tensor(new_v[:INSERTS],
                                               device=device)])
        qb = extra[-1]
        ids_t, d_t, ms_t = serve(qb, hyb)
        check_results(qb, ids_t, d_t, table)
        check(not bool(tomb[ids_t[ids_t < args.n]].any()),
              "a tombstoned id was returned")
        # each inserted vector as a query: where the hot route reaches it,
        # it comes first at distance 0 (the route is a beam search, so
        # it need not reach every one; the share is printed)
        selfq = new_v[:SELF_QUERIES]
        ids_s, d_s, _ = serve(selfq, hyb)
        check_results(selfq, ids_s, d_s, table)
        own = gids[:SELF_QUERIES, None]
        found = (ids_s == own).any(1)
        check(bool(found.any()), "no inserted vector found itself")
        check(bool((ids_s[found, 0] == own[found, 0]).all()
                   and not d_s[found, 0].any()),
              "an inserted vector found itself but not first at distance 0")
        check(not bool(tomb[ids_s[ids_s < args.n]].any()),
              "a tombstoned id was returned")
        print(f"  after: batch {ms_t:.3f} ms, recall@10 "
              f"{recall(ids_t, oracle(qb)):.4f} (the oracle ignores the "
              f"tombstones and inserts); {int(found.sum())} of "
              f"{SELF_QUERIES} inserted vectors found themselves, each "
              f"first at distance 0")
        take("11 hybrid")

    with phase("12 large batch"):
        # 4,096 queries: R = 8,192 union slots a round, past the 4,096 the
        # first port's one-CTA union sorted
        ids_b, d_b, ms_b = serve(big, srv)
        st_b = srv.batch_stats()
        got = take("12 large batch")
        ids_r, d_r, ms_r = serve(big, srv_ref)
        check_results(big, ids_b, d_b)
        print(f"  {BIG_BATCH} queries: {ms_b:.3f} ms ({BIG_BATCH / ms_b * 1e3:.1f}"
              f" QPS), rounds {st_b['rounds']}, io {st_b['io'].mean():.3f}, "
              f"tier0_hits {st_b['tier0_hits'].mean():.3f}, dedup_saved "
              f"{st_b['dedup_saved'].mean():.3f} per query; launches {got}; "
              f"plain path {ms_r:.3f} ms; ids equal on "
              f"{float((ids_b == ids_r).all(1).mean()):.4f} of queries")
        check(np.array_equal(ids_b, ids_r),
              "the large batch's ids differ from the plain path's")
        if on_card:
            check(got["gather_union"] == st_b["rounds"] > 0
                  and got["fused_round_rank"] == st_b["rounds"],
                  "large-batch launches do not follow the rounds")
        take("12 plain path and checks")

    with phase("13 serving plane"):
        # the host block search behind the block cache, twice: the
        # synchronous cache of SEGMENT_BENCH_CACHED and the tiered cache
        # with an 8-deep shared fetch queue of SEGMENT_BENCH_ASYNC
        host_q = query_set(x, HOST_QUERIES, seed=4)
        truth_h = oracle(host_q)
        take("13 oracle")
        for name, preset in (("cached", SEGMENT_BENCH_CACHED),
                             ("async", SEGMENT_BENCH_ASYNC)):
            t0 = time.perf_counter()
            view = cached_view(seg.view, seg.graph, preset.cache)
            hs = HostSegmentServer(view=view, params=preset.search,
                                   offset=0, num_vectors=seg.num_vectors,
                                   device=args.device)
            if preset.cache.queue_depth:
                attach_shared_fetch_queue(
                    [hs], depth=preset.cache.queue_depth)
            wrap_s = time.perf_counter() - t0
            ids_h, d_h, ms_h = serve(host_q, hs)
            got = take(f"13 host search {name}")
            check_results(host_q, ids_h, d_h)
            agg = IO.IOStats()
            for s_ in hs.last_stats:
                agg.merge(s_)
            cs = hs.cache_stats()
            print(f"  host search ({name}: budget {preset.cache.budget_frac}"
                  f" of the block file = {view.store.memory_bytes()} B, "
                  f"{preset.cache.policy}, pinned "
                  f"{len(view.store.cache.pinned)} blocks, prefetch width "
                  f"{preset.cache.prefetch_width}, tier2_frac "
                  f"{preset.cache.tier2_frac}, queue depth "
                  f"{preset.cache.queue_depth}; wrap {wrap_s:.3f} s): "
                  f"{HOST_QUERIES} queries in {ms_h:.3f} ms = "
                  f"{ms_h / HOST_QUERIES:.3f} ms per query; recall@10 "
                  f"{recall(ids_h, truth_h):.4f}; per query block_reads "
                  f"{agg.block_reads / HOST_QUERIES:.3f}, io_round_trips "
                  f"{agg.io_round_trips / HOST_QUERIES:.3f}, hops "
                  f"{agg.hops / HOST_QUERIES:.3f}, pq_comps "
                  f"{agg.pq_comps / HOST_QUERIES:.3f}; cache hit rate "
                  f"{cs['hit_rate']:.4f} (tier-1 {cs['cache_hits']}, "
                  f"tier-2 {cs['tier2_hits']}, misses {cs['cache_misses']},"
                  f" joins {cs['inflight_joins']}, reorders "
                  f"{cs['completion_reorders']}); launches {got}"
                  + (f"; ADC codes per pq_adc call "
                     f"{agg.pq_comps / got['pq_adc']:.3f}" if on_card
                     else ""))
            check(agg.block_reads == agg.cache_hits + agg.tier2_hits
                  + agg.cache_misses, "cache accounting does not add up")
            if on_card:
                # one call for the entry points, at most one a hop
                check(HOST_QUERIES < got["pq_adc"]
                      <= HOST_QUERIES + agg.hops,
                      "pq_adc launches do not follow the host search's "
                      "hops")
            del hs, view

        # the device's share of the host search: one profiled run of 32
        # queries behind a cold cache
        view = cached_view(seg.view, seg.graph, SEGMENT_BENCH_CACHED.cache)
        hs = HostSegmentServer(view=view, params=SEGMENT_BENCH_CACHED.search,
                               offset=0, num_vectors=seg.num_vectors,
                               device=args.device)
        with profile(activities=acts) as prof:
            _, _, ms_p = serve(host_q[:HOST_PROFILE], hs)
        got = take("13 host search profiled")
        rows_p = prof.key_averages()
        busy_p = sum(getattr(e, "self_device_time_total", 0)
                     for e in rows_p) / 1e3
        print(f"  host search of {HOST_PROFILE} queries under "
              f"torch.profiler: wall {ms_p:.3f} ms, device busy "
              f"{busy_p:.3f} ms"
              + (f", idle share {1 - busy_p / ms_p:.4f}" if on_card
                 else " (not measured on the CPU)")
              + f"; launches {got}")
        for e in sorted(rows_p, key=lambda e: -e.self_cpu_time_total)[:5]:
            print(f"    {e.key[:56]:56s} calls {e.count:6d} device "
                  f"{getattr(e, 'self_device_time_total', 0) / 1e3:9.3f}"
                  f" ms host {e.self_cpu_time_total / 1e3:9.3f} ms")
        del hs, view

        # the same 64 queries on the card and through the plain pq_adc on
        # the CPU, each from a cold cache: equal ids, dists and IOStats
        sub = host_q[:HOST_CHECK]
        outs = {}
        for dev_name in (args.device, "cpu"):
            view = cached_view(seg.view, seg.graph,
                               SEGMENT_BENCH_CACHED.cache)
            t0 = time.perf_counter()
            outs[dev_name] = anns(view, sub, 10,
                                  SEGMENT_BENCH_CACHED.search,
                                  device=dev_name)
            print(f"  {HOST_CHECK} queries at device={dev_name}: "
                  f"{(time.perf_counter() - t0) * 1e3:.3f} ms")
        (ia, da, sa), (ib, db, sb) = outs[args.device], outs["cpu"]
        check(np.array_equal(ia, ib) and np.array_equal(da, db)
              and all(dataclasses.asdict(a) == dataclasses.asdict(b_)
                      for a, b_ in zip(sa, sb)),
              "the host search on the card differs from its CPU run")
        print(f"  host search on the card equals its device=cpu run "
              f"(plain pq_adc) on {HOST_CHECK} queries: ids, dists and "
              f"every IOStats field")
        K.reset_all_launches()          # the comparison: not counted

        # pq_adc at the served host shape: one LUT against the codes of
        # one hop's new neighbours (at most 1 + ceil((eps-1)·σ) = 3
        # expanded vertices of degree <= Λ = 24)
        n_exp = 1 + math.ceil((seg.vid.shape[1] - 1)
                              * SEGMENT_BENCH_CACHED.search.pruning_ratio)
        adc_n = n_exp * seg.adj.shape[1]
        codes_s = ds.pq_codes[torch.as_tensor(
            np.random.default_rng(args.seed).choice(
                args.n, adc_n, replace=False), device=device)].contiguous()
        lut_s = lut_host(torch.as_tensor(host_q[:1], device=device),
                         ds.pq_cent, seg.metric).contiguous()
        check(torch.equal(PQK.pq_adc(codes_s, lut_s),
                          ref.pq_adc_ref(lut_s, codes_s)),
              f"pq_adc differs from its plain version at 1 x {adc_n}")
        if on_card:
            flush = torch.empty(2 ** 27, dtype=torch.int32, device=device)
            served_adc = {
                "flushed": time_ms(lambda: PQK.pq_adc(codes_s, lut_s),
                                   device, ITERS, flush),
                "in_l2": time_ms(lambda: PQK.pq_adc(codes_s, lut_s),
                                 device, ITERS),
                "plain_flushed": time_ms(lambda: ref.pq_adc_ref(
                    lut_s, codes_s), device, ITERS, flush),
                "floor": time_ms(lambda: torch.cuda._sleep(0), device,
                                 ITERS, flush)}
            del flush
            by = adc_n * m_sub + m_sub * k_cent * 4 + adc_n * 4
            print(f"  pq_adc at [1 x {adc_n}] (the host search's largest "
                  f"call): {served_adc['flushed']:.6f} ms with the L2 "
                  f"flushed, {served_adc['in_l2']:.6f} ms with its inputs"
                  f" in L2; plain {served_adc['plain_flushed']:.6f} ms; "
                  f"an empty launch {served_adc['floor']:.6f} ms; byte "
                  f"bound {by / HBM_BYTES_PER_S * 1e3:.6f} ms")
        K.reset_all_launches()          # the comparison: not counted

        # the coordinator over the device server, a repack scheduler fed
        # by the cached host store, and a request batcher in front
        feed_view = cached_view(seg.view, seg.graph,
                                SEGMENT_BENCH_CACHED.cache)
        feed = HostSegmentServer(view=feed_view,
                                 params=SEGMENT_BENCH_CACHED.search,
                                 offset=0, num_vectors=seg.num_vectors,
                                 device=args.device)
        srv_s = SegmentServer(segment=ds, offset=0,
                              num_vectors=seg.num_vectors, params=p,
                              device=args.device, host=seg)
        sched = RepackScheduler(SERVE_REPACK)
        sched.attach_feed(feed_view.store)
        coord = QueryCoordinator([srv_s], scheduler=sched)
        batcher = RequestBatcher(dim=DIM, buckets=(256, 1024))
        # single requests near vertices in blocks the build-time pack
        # left cold: a stream that drifts away from the build-time prior
        pack0 = sorted(DS.hot_pack_blocks(srv_s.segment))
        cold_vid = np.flatnonzero(~np.isin(seg.block_of, pack0))
        rng = np.random.default_rng(args.seed + 6)
        stream = (x[rng.choice(cold_vid, STREAM)] + rng.normal(
            0, 0.01, (STREAM, DIM))).astype(np.float32)
        for row in stream:
            batcher.submit(row)
        print(f"  stream: {STREAM} requests near vertices of the "
              f"{seg.num_blocks - len(pack0)} blocks outside the "
              f"{len(pack0)}-block build-time pack; batcher buckets "
              f"{batcher.buckets}")
        sched_ms, results, fired = [], [], None
        while batcher.queue:
            qb_, rids, nv = batcher.next_batch()
            qb_ = qb_[:nv]
            t0 = time.perf_counter()
            feed.search(qb_[:FEED_QUERIES])
            feed_ms = (time.perf_counter() - t0) * 1e3
            take("13 host feed")
            sync(device)
            t0 = time.perf_counter()
            gi, gd, st = coord.search(qb_, k=10)
            sync(device)
            ms = (time.perf_counter() - t0) * 1e3
            got = take("13 coordinator")
            bs = srv_s.batch_stats()
            check(st["total_block_reads"] == int(bs["io"].sum())
                  and st["total_tier0_hits"] == int(bs["tier0_hits"].sum())
                  and st["total_dedup_saved"] == int(bs["dedup_saved"].sum())
                  and st["total_dedup_cross"] == int(bs["dedup_cross"].sum())
                  and st["total_spec_hits"] == int(bs["spec_hits"].sum())
                  and st["total_spec_wasted"] == int(bs["spec_wasted"].sum())
                  and st["total_hot_tier_hits"] == int(
                      bs["hot_tier_hits"].sum())
                  and st["deduped_block_reads"] == int(
                      bs["io"].sum() - bs["dedup_saved"].sum()),
                  "a stats dict's totals differ from the batch columns")
            check(set(QueryCoordinator.STATS_SCHEMA) <= set(st),
                  "a stats dict lacks a schema key")
            if on_card:
                check(got["gather_union"] == bs["rounds"] > 0
                      and got["fused_round_rank"] == bs["rounds"],
                      "coordinator launches do not follow the rounds")
            check_results(qb_, gi, gd)
            sched_ms.append(ms)
            results.append((qb_, gi, gd, st))
            print(f"  batch {len(results)} ({nv} requests {rids[0]}.."
                  f"{rids[-1]}): {ms:.3f} ms (host feed of the first "
                  f"{min(nv, FEED_QUERIES)}: {feed_ms:.3f} ms);"
                  f" stats {json.dumps(st, sort_keys=True)}")
            if "repack" in st and fired is None and \
                    st["repack"]["repacked"]:
                fired = len(results)
        print(f"  scheduler: {sched.stats()}; last decision "
              f"{dataclasses.asdict(sched.last_decision)}")
        print(f"  coordinator batch ms median {np.median(sched_ms):.3f} "
              f"over {len(sched_ms)} batches of {BATCH}")
        check(sched.evals >= 1 and "repack" in results[
            SERVE_REPACK.interval_batches - 1][3],
              "the scheduler did not evaluate at its interval")
        check(fired is not None, "no scheduled repack fired (max drift "
              f"{sched.last_decision.max_drift:.4f} against the "
              f"hysteresis {SERVE_REPACK.hysteresis})")
        qb_, gi0, gd0, st0 = results[fired - 1]
        pack1 = sorted(DS.hot_pack_blocks(srv_s.segment))
        gi1, gd1, st1 = coord.search(qb_, k=10)
        take("13 coordinator after the repack")
        check(np.array_equal(gi0, gi1) and np.array_equal(gd0, gd1),
              "the scheduled repack changed the results")
        moved = len(set(pack1) - set(pack0))
        print(f"  batch {fired} again after the repack ({moved} of "
              f"{len(pack1)} pack slots changed): ids and dists equal;"
              f" total_tier0_hits {st0['total_tier0_hits']} -> "
              f"{st1['total_tier0_hits']}, total_block_reads "
              f"{st0['total_block_reads']} -> {st1['total_block_reads']}")
        check(st1["total_tier0_hits"] > st0["total_tier0_hits"]
              and st1["total_block_reads"] < st0["total_block_reads"],
              "the repack did not move touches into tier 0")
        del feed, feed_view, coord, srv_s

    with phase("14 build variants"):
        # the k-means packer at full size on phase 3's graph (App. G)
        eps = seg.vid.shape[1]
        k_cent = max(-(-args.n // eps) // 4, 1)
        sync(device)
        t0 = time.perf_counter()
        lay_k = L.layout_kmeans(x, seg.graph, eps, iters=KMEANS_ITERS,
                                device=device)
        sync(device)
        km_s = time.perf_counter() - t0
        got = take("14 k-means")
        lay_k.validate()
        chunk = max(1, L._KMEANS_ELEMS[device.type] // k_cent)
        want_l2 = KMEANS_ITERS * -(-args.n // chunk)
        or_k = L.overlap_ratio(seg.graph, lay_k)
        print(f"  k-means packer: k={k_cent} centroids, {KMEANS_ITERS} "
              f"iterations, {km_s:.3f} s; l2_tile launches {got['l2_tile']}"
              f" ({KMEANS_ITERS} x {-(-args.n // chunk)} row chunks of "
              f"{chunk}); OR(G) k-means {or_k:.4f}, BNP {hist[0]:.4f}, BNF "
              f"rounds {[round(h, 4) for h in hist[1:]]}")
        if on_card:
            check(got["l2_tile"] == want_l2,
                  "the k-means assignment's l2_tile launches do not follow "
                  "its chunks")
        del lay_k

        # HNSW on the first HNSW_N vectors (Fig. 16): the layers, then a
        # segment over its base layer and host queries
        nh = HNSW_N if on_card else min(HNSW_N, args.n // 2)
        xh = np.ascontiguousarray(x[:nh])
        p_h = dataclasses.replace(
            params, graph=dataclasses.replace(params.graph, algo="hnsw"),
            layout=dataclasses.replace(params.layout, shuffle="bnf"))
        sync(device)
        t0 = time.perf_counter()
        hg = G.build_hnsw(xh, p_h.graph, device=device)
        sync(device)
        hn_s = time.perf_counter() - t0
        got = take("14 hnsw")
        sizes = [int(ids.size) for ids in hg.level_ids]
        print(f"  build_hnsw n={nh}: {hn_s:.3f} s, level sizes {sizes}; "
              f"l2_tile launches {got['l2_tile']}")
        check(sizes == sorted(sizes, reverse=True) and sizes[0] == nh,
              "HNSW level sizes increase with the level")
        for lv, (lg, ids) in enumerate(zip(hg.layers, hg.level_ids)):
            check_graph(lg, f"hnsw level {lv}")
            print(f"    level {lv}: {ids.size} vertices, degree cap "
                  f"{lg.max_degree}, avg {lg.avg_degree():.3f}, max "
                  f"{int(lg.deg.max())}; every vertex reachable")
        if on_card:
            check(got["l2_tile"] > 0, "the HNSW build launched no l2_tile")
        sync(device)
        t0 = time.perf_counter()
        seg_h = build_segment(xh, p_h, device=device)
        sync(device)
        got = take("14 hnsw segment")
        print(f"  build_segment(algo=hnsw, shuffle=bnf): "
              f"{time.perf_counter() - t0:.3f} s "
              f"({ {k: round(v, 3) for k, v in seg_h.build_times.items()} });"
              f" OR(G) {seg_h.overlap_ratio:.4f}; l2_tile launches "
              f"{got['l2_tile']}")
        check(np.array_equal(seg_h.adj, hg.base.adj)
              and np.array_equal(seg_h.deg, hg.base.deg),
              "the segment's disk graph is not HNSW's base layer")
        seg_h.layout.validate()
        qh = query_set(xh, HOST_QUERIES, seed=7)
        truth_q = D.brute_force_knn(torch.as_tensor(xh, device=device), qh,
                                    10, device=device)
        take("14 hnsw oracle")
        t0 = time.perf_counter()
        ids_q, d_q, st_q = anns(seg_h.view, qh, 10, seg_h.params.search,
                                device=device)
        ms_q = (time.perf_counter() - t0) * 1e3
        got = take("14 hnsw queries")
        check_results(qh, ids_q, d_q, torch.as_tensor(xh, device=device))
        print(f"  {HOST_QUERIES} host queries: recall@10 "
              f"{recall(ids_q, truth_q):.4f}, block_reads "
              f"{np.mean([s.block_reads for s in st_q]):.3f}, hops "
              f"{np.mean([s.hops for s in st_q]):.3f} per query, "
              f"{ms_q / HOST_QUERIES:.3f} ms per query; launches {got}")
        nav_h = NG.from_hnsw_layers(xh, hg, params.nav, device=device)
        ep = nav_h.entry_points(qh, beam=16, num=4, device=device)
        take("14 hnsw navigation")
        upper = hg.level_ids[1] if len(hg.layers) > 1 else None
        if upper is not None:
            check(np.array_equal(nav_h.sample_ids, upper),
                  "from_hnsw_layers does not hold level 1")
        check(bool(np.isin(ep, nav_h.sample_ids).all()),
              "an HNSW entry point is not a sample id")
        print(f"  from_hnsw_layers: {nav_h.sample_ids.size} vertices "
              f"(level 1), degree {nav_h.graph.max_degree}, "
              f"{nav_h.memory_bytes()} B; entry points of {qh.shape[0]} "
              f"queries all sample ids")
        del hg, seg_h, nav_h, xh

        # BNS at App. F's size: BNF (β = 8) as its start, one BNS round
        xs_ = np.ascontiguousarray(x[:BNS_N])
        gb = G.build_graph(xs_, SEGMENT_BENCH_DEVICE.graph, device=device)
        take("14 bns graph")
        t0 = time.perf_counter()
        lay_f, hist_f = L.layout_bnf(gb, eps, iters=BNF_ITERS)
        bnf_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        lay_s, hist_s = L.layout_bns(gb, eps, iters=1, init=lay_f)
        bns_s = time.perf_counter() - t0
        lay_s.validate()
        print(f"  BNS n={BNS_N} (Vamana, eps={eps}): BNF OR(G) "
              f"{L.overlap_ratio(gb, lay_f):.4f} in {bnf_s:.3f} s (rounds "
              f"{[round(h, 4) for h in hist_f]}); BNS OR(G) "
              f"{hist_s[-1]:.4f} in {bns_s:.3f} s (history "
              f"{[round(h, 4) for h in hist_s]})")
        check(all(b >= a - 1e-9 for a, b in zip(hist_s, hist_s[1:])),
              "OR(G) fell across BNS's history (Lemma 4.2)")
        take("14 bns")
        del gb, xs_

    with phase("15 diskann baseline"):
        # the ID-contiguous baseline segment on phase 3's graph
        p_b = dataclasses.replace(params, layout=dataclasses.replace(
            params.layout, shuffle="none"))
        sync(device)
        t0 = time.perf_counter()
        seg_b = build_segment(x, p_b, graph=seg.graph, device=device)
        sync(device)
        take("15 baseline segment")
        print(f"  baseline segment (layout none, phase 3's graph): "
              f"{time.perf_counter() - t0:.3f} s, OR(G) "
              f"{seg_b.overlap_ratio:.4f}")
        sp = params.search
        sp_b = dataclasses.replace(sp, use_block_search=False,
                                   use_nav_graph=False)
        t0 = time.perf_counter()
        hot_b = build_hot_cache(seg_b.view, ratio=0.05)
        print(f"  build_hot_cache(0.05): {len(hot_b)} vertices in "
              f"{time.perf_counter() - t0:.3f} s")
        runs = {}

        def host_run(name, fn):
            t0 = time.perf_counter()
            ids_, d_, st_ = fn()
            ms_ = (time.perf_counter() - t0) * 1e3
            got_ = take(f"15 {name}")
            check_results(host_q, ids_, d_)
            used = sum(s.vertices_used for s in st_)
            fetched = sum(s.vertices_fetched for s in st_)
            print(f"  {name}: recall@10 {recall(ids_, truth_h):.4f}; per "
                  f"query block_reads "
                  f"{np.mean([s.block_reads for s in st_]):.3f}, hops "
                  f"{np.mean([s.hops for s in st_]):.3f}, pq_comps "
                  f"{np.mean([s.pq_comps for s in st_]):.3f}; vertex "
                  f"utilisation {used / max(fetched, 1):.4f}; "
                  f"{ms_ / len(st_):.3f} ms per query; pq_adc launches "
                  f"{got_['pq_adc']}")
            if on_card:
                check(len(st_) < got_["pq_adc"]
                      <= len(st_) + sum(s.hops for s in st_),
                      f"{name}: pq_adc launches do not follow the hops")
            runs[name] = (ids_, d_, st_)

        host_run("baseline", lambda: vertex_anns(
            seg_b.view, host_q, 10, sp_b, device=device))
        host_run("baseline hot cache", lambda: vertex_anns(
            seg_b.view, host_q, 10, sp_b, hot=hot_b, device=device))
        host_run("starling", lambda: anns(seg.view, host_q, 10, sp,
                                          device=device))
        (ia, da, sa), (ib, db, sb) = (runs["baseline"],
                                      runs["baseline hot cache"])
        check(np.array_equal(ia, ib) and np.array_equal(da, db),
              "the hot cache changed an id or a distance")
        check(all(b_.block_reads <= a.block_reads for a, b_ in zip(sa, sb)),
              "the hot cache raised a query's block_reads")
        sub = host_q[:BASE_CHECK]
        outs = {dn: vertex_anns(seg_b.view, sub, 10, sp_b, device=dn)
                for dn in (args.device, "cpu")}
        (ia, da, sa), (ib, db, sb) = outs[args.device], outs["cpu"]
        check(np.array_equal(ia, ib) and np.array_equal(da, db)
              and all(dataclasses.asdict(a) == dataclasses.asdict(b_)
                      for a, b_ in zip(sa, sb)),
              "the baseline on the card differs from its CPU run")
        print(f"  baseline on the card equals its device=cpu run on "
              f"{BASE_CHECK} queries: ids, dists and every IOStats field")
        K.reset_all_launches()          # the comparison: not counted
        sub = host_q[:BASE_RANGE]
        t0 = time.perf_counter()
        _, st_vr = vertex_range_search(seg_b.view, sub, radius, sp_b,
                                       device=device)
        ms_vr = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        _, st_rs = range_search(seg.view, sub, radius, sp, device=device)
        ms_rs = (time.perf_counter() - t0) * 1e3
        take("15 range")
        print(f"  range search, {BASE_RANGE} queries at phase 9's radius: "
              f"block_reads per query baseline (repeated ANNS) "
              f"{np.mean([s.block_reads for s in st_vr]):.3f} in "
              f"{ms_vr:.3f} ms, Starling "
              f"{np.mean([s.block_reads for s in st_rs]):.3f} in "
              f"{ms_rs:.3f} ms")
        br = {n_: np.mean([s.block_reads for s in r[2]])
              for n_, r in runs.items()}
        print(f"  the paper's claim (printed, not bounded): Starling reads "
              f"fewer blocks per query than the baseline: "
              f"{br['starling']:.3f} against {br['baseline']:.3f} "
              f"({'holds' if br['starling'] < br['baseline'] else 'fails'}"
              f" here)")
        del seg_b, hot_b, runs, outs

    with phase("16 delta segment"):
        sync(device)
        t0 = time.perf_counter()
        dl = DeltaSegment.wrap(seg, HotTierParams(budget_frac=0.10),
                               device=args.device)
        sync(device)
        take("16 wrap")
        print(f"  wrap: hot tier of {dl.hot.size} vectors in "
              f"{time.perf_counter() - t0:.3f} s")
        ins = new_v[:DELTA_INSERTS]
        sync(device)
        t0 = time.perf_counter()
        gids_d = dl.insert(ins)
        sync(device)
        ins_s = time.perf_counter() - t0
        take("16 inserts")
        dead_ins = gids_d[::DELTA_INSERTS // DELTA_DEAD_INSERTS]
        for g in dead:
            check(dl.delete(int(g)), "a base delete failed")
        for g in dead_ins:
            check(dl.delete(int(g)), "an insert's delete failed")
        gone = set(dead.tolist()) | set(dead_ins.tolist())
        print(f"  insert {DELTA_INSERTS}: {ins_s:.3f} s "
              f"({ins_s / DELTA_INSERTS * 1e3:.3f} ms each); deleted "
              f"{dead.size} base ids and {dead_ins.size} inserted; "
              f"num_deleted {dl.num_deleted}, live_count {dl.live_count}")
        check(dl.num_deleted == len(gone)
              and dl.live_count == args.n + DELTA_INSERTS - len(gone),
              "the delta's census is off")
        x_live, live_g = dl.live_vectors()
        x_live_t = torch.as_tensor(x_live, device=device)
        truth_d = live_g[D.brute_force_knn(x_live_t, host_q, 10,
                                           device=device)]
        take("16 oracle")
        sp = params.search
        t0 = time.perf_counter()
        ids_d, d_d, st_d = dl.search(host_q, 10, sp)
        ms_d = (time.perf_counter() - t0) * 1e3
        got = take("16 search")
        gid_vecs = np.concatenate([x, new_v[:DELTA_INSERTS]])
        check_results(host_q, ids_d, d_d,
                      torch.as_tensor(gid_vecs, device=device))
        check(not np.isin(ids_d, list(gone)).any(),
              "the delta returned a tombstoned id")
        print(f"  search {HOST_QUERIES} queries: recall@10 "
              f"{recall(ids_d, truth_d):.4f} (live-set brute force); per "
              f"query block_reads "
              f"{np.mean([s.block_reads for s in st_d]):.3f}, hot_tier_hits "
              f"{np.mean([s.hot_tier_hits for s in st_d]):.3f}; "
              f"{ms_d / HOST_QUERIES:.3f} ms per query; launches {got}")
        if on_card:
            check(got["pq_adc"] > HOST_QUERIES,
                  "the delta's search launched no pq_adc a hop")
        live_ins = np.setdiff1d(gids_d, dead_ins)[:DELTA_SELF]
        selfq = gid_vecs[live_ins]
        ids_s, d_s, _ = dl.search(selfq, 10, sp)
        take("16 self queries")
        found = (ids_s[:, 0] == live_ins) & (d_s[:, 0] == 0)
        print(f"  {live_ins.size} inserted vectors queried back: "
              f"{found.mean():.4f} found first at distance 0")
        check(not np.isin(ids_s, list(gone)).any(),
              "the delta returned a tombstoned id")
        sub = host_q[:DELTA_CHECK]
        cpu_dl = dataclasses.replace(dl, device="cpu", hot=dataclasses.replace(
            dl.hot, device="cpu", _mirror=None))
        (ia, da, sa) = dl.search(sub, 10, sp)
        (ib, db, sb) = cpu_dl.search(sub, 10, sp)
        bits = float((da.view(np.uint32) == db.view(np.uint32)).mean())
        check(np.array_equal(ia, ib)
              and np.allclose(da, db, rtol=1e-5, atol=1e-4)
              and all(dataclasses.asdict(a) == dataclasses.asdict(b_)
                      for a, b_ in zip(sa, sb)),
              "the delta's search on the card differs from its CPU run")
        print(f"  delta search on the card equals its device=cpu run on "
              f"{DELTA_CHECK} queries: ids and every IOStats field; "
              f"distances within rtol 1e-5, {bits:.4f} of them bit-equal "
              f"(the hot route's torch sums)")
        K.reset_all_launches()          # the comparison: not counted
        del cpu_dl

        del dl, x_live_t

        # the compaction at COMPACT_N (of scale only): a delta over a
        # segment of the first COMPACT_N vectors, with inserts and 1% of
        # its base plus every 16th insert deleted, folded back to disk;
        # then the swaps
        n_c = COMPACT_N if on_card else min(COMPACT_N, args.n // 2)
        xc = np.ascontiguousarray(x[:n_c])
        sync(device)
        t0 = time.perf_counter()
        seg_c = build_segment(xc, params, device=device)
        sync(device)
        print(f"  compaction base: {n_c} vectors built in "
              f"{time.perf_counter() - t0:.3f} s")
        dl_c = DeltaSegment.wrap(seg_c, HotTierParams(budget_frac=0.10),
                                 device=args.device)
        gids_cc = dl_c.insert(new_v[:COMPACT_INSERTS])
        dead_c = np.random.default_rng(args.seed + 5).choice(
            n_c, n_c // 100, replace=False)
        dead_ci = gids_cc[::16]
        for g in np.concatenate([dead_c, dead_ci]):
            check(dl_c.delete(int(g)), "a delete before the compaction "
                                       "failed")
        gone_c = set(dead_c.tolist()) | set(dead_ci.tolist())
        x_live, live_g = dl_c.live_vectors()
        x_live_t = torch.as_tensor(x_live, device=device)
        take("16 compaction delta")
        t0 = time.perf_counter()
        comp, cgids = dl_c.compact()
        comp_s = time.perf_counter() - t0
        take("16 compaction")
        bt_c = comp.build_times
        print(f"  compact() of {n_c} + {COMPACT_INSERTS} inserts - "
              f"{len(gone_c)} deleted: {comp_s:.3f} s "
              f"({ {k: round(v, 3) for k, v in bt_c.items()} }); "
              f"{comp.num_vectors} vectors, {comp.num_blocks} blocks "
              f"(base {seg_c.num_blocks}); OR(G) {comp.overlap_ratio:.4f}")
        check(comp.num_vectors == dl_c.live_count == cgids.size,
              "the compaction lost or added vectors")
        check(not np.isin(cgids, list(gone_c)).any(),
              "a tombstoned gid survived the compaction")
        check(np.array_equal(cgids, live_g), "gids are not the live set's")
        check_graph(comp.graph, "compacted graph")
        comp.layout.validate()

        srv_d = SegmentServer(segment=DS.from_segment(seg_c, device=device),
                              offset=0, num_vectors=n_c, params=p,
                              device=args.device, host=seg_c)
        sched = RepackScheduler(SERVE_REPACK)
        sched.attach_target(srv_d)
        # observed demand on the old layout's tail, at and past the
        # compacted block count (or past it by 8 when the compaction
        # grew the segment), beside entries that stay valid
        new_total, old_total = comp.num_blocks, seg_c.num_blocks
        sched._window.update({b: 5 for b in range(
            new_total - 8, max(old_total, new_total + 8))})
        sched._window.update({0: 3, 1: 2})
        stale = sum(1 for b in sched._window if b >= new_total)
        t0 = time.perf_counter()
        swap_into_device_server(srv_d, comp, scheduler=sched)
        sync(device)
        print(f"  swap_into_device_server: {time.perf_counter() - t0:.3f} "
              f"s; the window held {stale} entries at or past the new "
              f"block count {new_total}, now {len(sched._window)} entries")
        check(stale > 0 and all(0 <= b < new_total for b in sched._window)
              and len(sched._window) == 10 and sched._window[0] == 3
              and sched._window[1] == 2,
              "the swap left stale window entries or dropped valid ones")
        take("16 swap")
        qc = query_set(xc, BATCH, seed=10)
        ids_c, d_c, ms_c = serve(qc, srv_d)
        st_c = srv_d.batch_stats()
        got = take("16 compacted serve")
        check_results(qc, ids_c, d_c, x_live_t)
        gid_c = cgids[ids_c]
        check(not np.isin(gid_c, list(gone_c)).any(),
              "the compacted segment served a tombstoned id")
        truth_c = D.brute_force_knn(x_live_t, qc, 10, device=device)
        take("16 oracle")
        print(f"  {BATCH} queries on the compacted segment: {ms_c:.3f} ms,"
              f" rounds {st_c['rounds']}, io {st_c['io'].mean():.3f}; "
              f"recall@10 {recall(ids_c, truth_c):.4f} (live-set brute "
              f"force); launches {got}")
        if on_card:
            check(got["gather_union"] == st_c["rounds"] > 0
                  and got["fused_round_rank"] == st_c["rounds"],
                  "compacted-serve launches do not follow the rounds")
        hs = HostSegmentServer.from_segment(seg_c, 0, device=args.device)
        swap_into_host_server(hs, comp, scheduler=sched)
        sub = host_q[:DELTA_CHECK]
        ids_hs, d_hs, _ = hs.search(sub)
        want_i, want_d, want_s = anns(comp.view, sub, 10, comp.params.search,
                                      device=device)
        take("16 host swap")
        check(np.array_equal(ids_hs, want_i) and np.array_equal(d_hs, want_d)
              and all(dataclasses.asdict(a) == dataclasses.asdict(b_)
                      for a, b_ in zip(hs.last_stats, want_s)),
              "the swapped host server differs from anns on the compacted "
              "view")
        print(f"  swap_into_host_server: {DELTA_CHECK} queries equal anns "
              f"on the compacted view")
        del dl_c, seg_c, comp, srv_d, hs, x_live_t

    with phase("17 observability"):
        # phase 13's serving plane with a tracer on the wall clock and a
        # metrics registry wired through QueryCoordinator(tracer=,
        # metrics=) and attach_obs (the host feed server and its cached
        # store, the scheduler), phase 11's hot tier through the hybrid
        # server; the same batches untraced on a fresh plane
        obs_b = batches[1:1 + OBS_BATCHES]
        feed_q = host_q[:OBS_FEED]
        p_tr = dataclasses.replace(p, trace_rounds=True)
        res_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "results")
        results_before = (sorted(os.listdir(res_dir))
                          if os.path.isdir(res_dir) else [])

        def obs_run(traced):
            tr = Tracer(WallClock()) if traced else None
            reg = MetricsRegistry() if traced else None
            fview = cached_view(seg.view, seg.graph,
                                SEGMENT_BENCH_CACHED.cache)
            fsrv = HostSegmentServer(view=fview,
                                     params=SEGMENT_BENCH_CACHED.search,
                                     offset=0, num_vectors=seg.num_vectors,
                                     device=args.device)
            dsrv = SegmentServer(segment=ds, offset=0,
                                 num_vectors=seg.num_vectors,
                                 params=p_tr if traced else p,
                                 device=args.device, host=seg)
            sch = RepackScheduler(SERVE_REPACK)
            sch.attach_feed(fview.store)
            crd = QueryCoordinator([dsrv], scheduler=sch, tracer=tr,
                                   metrics=reg)
            hyb_o = dataclasses.replace(hyb, hot_tier=dataclasses.replace(
                hot, tracer=None, metrics=None))
            if traced:
                fsrv.attach_obs(tr, reg)
                hyb_o.attach_obs(tr, reg)
            out, logs = [], []
            for qb in obs_b:
                fi, fd, _ = fsrv.search(feed_q)
                gi, gd, st = crd.search(qb, k=10)
                bs = dsrv.batch_stats()
                if traced:
                    logs.append((dsrv.last_round_log, bs["rounds"]))
                out.append((gi, gd, st, {k_: np.asarray(v).tolist()
                                         for k_, v in bs.items()},
                            fi, fd, [dataclasses.asdict(s_)
                                     for s_ in fsrv.last_stats]))
            hi, hd, _ = hyb_o.search(obs_b[0], 10)
            out.append((hi, hd, {k_: np.asarray(v).tolist() for k_, v
                                 in hyb_o.batch_stats().items()},
                        fsrv.cache_stats(), sch.stats()))
            return out, crd, tr, reg, logs

        plain_out, plain_crd, _, _, _ = obs_run(False)
        take("17 untraced")
        trac_out, trac_crd, tr, reg, logs = obs_run(True)
        traced = take("17 traced")
        for i, (a, b_) in enumerate(zip(trac_out[:-1], plain_out[:-1])):
            check(np.array_equal(a[0], b_[0]) and np.array_equal(a[1], b_[1])
                  and a[2] == b_[2] and a[3] == b_[3]
                  and np.array_equal(a[4], b_[4])
                  and np.array_equal(a[5], b_[5]) and a[6] == b_[6],
                  f"tracing changed batch {i + 1}'s ids, dists, stats "
                  f"dict, device columns or host feed")
            check_results(obs_b[i], a[0], a[1])
        ha, hb_ = trac_out[-1], plain_out[-1]
        check(np.array_equal(ha[0], hb_[0]) and np.array_equal(ha[1], hb_[1])
              and ha[2:] == hb_[2:],
              "tracing changed the hybrid batch, the cache counters or "
              "the scheduler")
        rounds_t = sum(r_ for _, r_ in logs)
        if on_card:
            want_r = rounds_t + ha[2]["rounds"]
            check(traced["gather_union"] == want_r > 0
                  and traced["fused_round_rank"] == want_r,
                  "traced launches do not follow the rounds")
        print(f"  {OBS_BATCHES} batches of {BATCH} through the coordinator "
              f"(+ {OBS_FEED} host feed queries each, 1 hybrid batch), "
              f"traced and untraced: ids, dists, stats dicts, device "
              f"columns, host feed results and IOStats, cache and "
              f"scheduler counters equal")
        print(f"  {len(tr)} events, dropped {tr.dropped}")
        names = {}
        for e in tr.events:
            names[e.name] = names.get(e.name, 0) + 1
        print(f"  events by name: {dict(sorted(names.items()))}")
        for want in ("coord.batch", "coord.segment", "host.search",
                     "io.read", "hot.route", "sched.eval"):
            check(names.get(want, 0) > 0, f"no {want} event was traced")
        check(names["coord.batch"] == OBS_BATCHES
              and names["host.search"] == OBS_BATCHES,
              "one coord.batch and one host.search span a batch")
        snap = reg.snapshot()
        sts = [o[2] for o in trac_out[:-1]]
        for key in QueryCoordinator.STATS_SCHEMA:
            if key.startswith("total_") or key in ("cache_hits",
                                                   "cache_misses"):
                check(snap[f"serve.{key}"][""] == sum(s_[key] for s_ in sts),
                      f"the registry's serve.{key} differs from the stats "
                      f"dicts' total")
        check(snap["serve.batches"][""] == OBS_BATCHES
              and snap["serve.queries"][""] == OBS_BATCHES * BATCH
              and snap["serve.block_reads"]["seg0"]
              == sum(s_["total_block_reads"] for s_ in sts),
              "the registry's batch, query or per-segment counts are off")
        cs = ha[3]
        check(all(snap[f"io.{k_}"]["seg0"] == cs[k_] for k_ in (
            "cache_hits", "tier2_hits", "cache_misses")),
              "the io.* gauges differ from cache_stats()")
        print(f"  registry: every STATS_SCHEMA total equals snapshot(); "
              f"serve.batch_block_reads "
              f"{json.dumps(snap['serve.batch_block_reads'][''])}; io.* "
              f"gauges = cache_stats(); hot.route_hits "
              f"{snap['hot.route_hits']['seg0']}, hot.size "
              f"{snap['hot.size']['seg0']}")

        # CostModel constants fitted to this card's wall clock: batches
        # of several sizes, so t_round and t_round_comp can be told apart
        samples = []
        for size in CALIB_SIZES:
            for rep in range(CALIB_REPEATS):
                qb = big[:size]
                sync(device)
                t0 = time.perf_counter()
                srv.search(qb, 10)
                sync(device)
                us = (time.perf_counter() - t0) * 1e6
                samples.append(CalibrationSample(
                    fold_batch(srv.batch_stats(), IO), us))
        take("17 calibration")
        with tempfile.TemporaryDirectory() as tmp:
            cal_path = os.path.join(tmp, f"CALIB_{IO.TPU_HBM_SEGMENT.name}"
                                         f".json")
            fitted, preset, report = calibrate(
                IO.TPU_HBM_SEGMENT, samples, preset_path=cal_path,
                source=f"chip_smoke.py phase 17: {len(samples)} batches "
                       f"of {list(CALIB_SIZES)} queries on {card}")
            check(CalibrationPreset.load(cal_path) == preset,
                  "the stored preset does not load back")
            check(load_calibrated(IO.TPU_HBM_SEGMENT, results_dir=tmp)
                  == fitted, "load_calibrated does not give the fit")
            # the served batches' round logs as modeled device.round
            # slices under the fitted model, each at its coord.batch
            starts = [e.ts_us for e in tr.by_name("coord.batch")]
            for bi, ((log, r_), ts) in enumerate(zip(logs, starts), 1):
                timeline_from_round_log(fold_round_log(log, r_), fitted,
                                        tracer=tr, track="device",
                                        t0_us=ts, batch=bi, dma_track=True)
            trace_path = os.path.join(tmp, "phase17.json")
            write_chrome_trace(trace_path, tr, metadata={
                "card": card, "batches": OBS_BATCHES})
            with open(trace_path) as f:
                problems = validate_chrome_trace(json.load(f))
            size_b = os.path.getsize(trace_path)
        check(problems == [], f"the Chrome trace is invalid: {problems[:3]}")
        print(f"  Chrome trace: {len(tr)} events with "
              f"{len(tr.by_name('device.round'))} modeled device.round "
              f"slices, {size_b} B, validate_chrome_trace -> []")
        fit_s = {k_: round(v, 6) for k_, v in report["fitted"].items()}
        print(f"  CostModel fitted to this card's wall clock ({card}; "
              f"{len(samples)} batches of {list(CALIB_SIZES)} queries, "
              f"{CALIB_REPEATS} each): fitted {fit_s}, unfit "
              f"{report['unfit']}, base {report['base']}")
        print(f"  error before (TPU-HBM constants): "
              f"{json.dumps(report['error_before'])}; after: "
              f"{json.dumps(report['error_after'])}")
        check(report["n_samples"] == len(samples)
              and all(math.isfinite(v) and v >= 0.0
                      for v in report["fitted"].values()),
              "the fit gave a negative or non-finite constant")
        # the round chain alone: on a launch-bound card a batch's time
        # follows its rounds, whatever its size
        per_round, _, rep_r = calibrate(IO.TPU_HBM_SEGMENT, samples,
                                        fields=("t_round",))
        print(f"  t_round alone: fitted {rep_r['fitted']}, error after "
              f"{json.dumps(rep_r['error_after'])}")
        print("  per batch (queries, rounds, live query-rounds, cold reads:"
              " measured ms / TPU-HBM model ms / fitted model ms / t_round"
              " alone ms):")
        for s_, size in zip(samples, [z for z in CALIB_SIZES
                                      for _ in range(CALIB_REPEATS)]):
            print(f"    {size}, {s_.stats.batch_rounds}, "
                  f"{s_.stats.hops}, {s_.stats.cache_misses}: "
                  f"{s_.measured_us / 1e3:.3f} / "
                  f"{IO.TPU_HBM_SEGMENT.latency_us(s_.stats) / 1e3:.3f} / "
                  f"{fitted.latency_us(s_.stats) / 1e3:.3f} / "
                  f"{per_round.latency_us(s_.stats) / 1e3:.3f}")
        results_after = (sorted(os.listdir(res_dir))
                         if os.path.isdir(res_dir) else [])
        check(results_after == results_before,
              "a preset was written under results/")

        # what the hooks cost: pairs of one batch on each plane, the
        # order alternating so that neither plane always runs first
        def timed(crd, qb):
            sync(device)
            t0 = time.perf_counter()
            crd.search(qb, k=10)
            sync(device)
            return (time.perf_counter() - t0) * 1e3

        plain_ms, trac_ms = [], []
        for i in range(OBS_PAIRS):
            qb = batches[i % len(batches)]
            if i % 2:
                trac_ms.append(timed(trac_crd, qb))
                plain_ms.append(timed(plain_crd, qb))
            else:
                plain_ms.append(timed(plain_crd, qb))
                trac_ms.append(timed(trac_crd, qb))
        take("17 overhead")
        diff = np.asarray(trac_ms) - np.asarray(plain_ms)
        q25, q50, q75 = np.percentile(diff, [25, 50, 75])
        verdict = ("unresolved: the interquartile range holds 0"
                   if q25 <= 0.0 <= q75 else "resolved")
        print(f"  the hooks' cost ({card}; {OBS_PAIRS} pairs of a "
              f"{BATCH}-query coordinator batch, order alternating): "
              f"median ms traced (spans, metrics, trace_rounds) "
              f"{np.median(trac_ms):.3f}, untraced "
              f"{np.median(plain_ms):.3f}; paired traced - untraced "
              f"median {q50:.3f} ms ({q50 / np.median(plain_ms):.4f} of "
              f"the untraced median), interquartile range [{q25:.3f}, "
              f"{q75:.3f}] ms: {verdict}")
        del plain_out, trac_out, plain_crd, trac_crd, tr, reg, logs

    with phase("18 mesh router"):
        # 4 segments of n/4 in id order (the way a vector database seals
        # segments), each an NSG build, on 8 ranks of the one card
        n_s = args.n // MESH_SEGMENTS
        check(n_s * MESH_SEGMENTS == args.n, "n must split into 4 segments")
        msrv = []
        for s in range(MESH_SEGMENTS):
            xs_ = np.ascontiguousarray(x[s * n_s:(s + 1) * n_s])
            sync(device)
            t0 = time.perf_counter()
            seg_s = build_segment(xs_, params, device=device)
            sync(device)
            seg_s.layout.validate()
            print(f"  segment {s}: ids {s * n_s}..{(s + 1) * n_s - 1}, "
                  f"built in {time.perf_counter() - t0:.3f} s, OR(G) "
                  f"{seg_s.overlap_ratio:.4f}, rho {seg_s.num_blocks}")
            msrv.append(SegmentServer(
                segment=DS.from_segment(seg_s, device=device),
                offset=s * n_s, num_vectors=n_s, params=p,
                device=args.device, host=seg_s))
            del xs_
        take("18 segment builds")
        router = MeshQueryRouter(
            msrv, mesh=make_debug_mesh(1, MESH_RANKS),
            params=RouterParams(window_batches=8, rebalance_interval=4,
                                min_window=2, skew_threshold=1.2))
        print(f"  router: {router.world} ranks, placement "
              f"{router.placement}")

        def single_target(qb):
            ids_, dd_, offs_ = [], [], []
            for s_ in msrv:
                i_, d_, _ = s_.search(qb, 10)
                ids_.append(i_)
                dd_.append(d_)
                offs_.append(s_.offset)
            return merge_topk(ids_, dd_, offs_, 10)

        route_ms, routed = [], {}

        def route(b, qb):
            sync(device)
            t0 = time.perf_counter()
            ri, rd, st = router.route(qb, k=10)
            sync(device)
            route_ms.append((time.perf_counter() - t0) * 1e3)
            got_ = take("18 routed")
            check(IO.IOStats.merge_ranks(st["per_rank"]) == st["total"],
                  f"routed batch {b}: merge_ranks(per_rank) != total")
            # one search a distinct segment, shared by its replicas
            first = {}
            for r_, si_ in enumerate(st["placement"]):
                first.setdefault(si_, r_)
            rounds_ = sum(st["per_rank"][r_].batch_rounds
                          for r_ in first.values())
            if on_card:
                check(got_["gather_union"] == rounds_ > 0
                      and got_["fused_round_rank"] == rounds_,
                      f"routed batch {b}: launches do not follow the "
                      f"segments' rounds")
            check_results(qb, ri, rd)
            rb = st.get("rebalance")
            print(f"  routed batch {b}: {route_ms[-1]:.3f} ms, placement "
                  f"{st['placement']}, rank rounds "
                  f"{[s_.batch_rounds for s_ in st['per_rank'].values()]}"
                  f" (one search a segment: {rounds_} rounds; "
                  f"gather_union launches "
                  f"{got_['gather_union']}), block_reads "
                  f"{st['total_block_reads']}, rank loads "
                  f"{[round(s_.rounds_active_weight, 3) for s_ in st['per_rank'].values()]}"
                  + (f"; evaluation: fired {rb['fired']}, moves "
                     f"{rb['moves']}, skew {rb['skew']:.4f}, the window's "
                     f"segment loads "
                     f"{[round(float(v), 3) for v in router.last_plan.seg_loads]}"
                     if rb else ""))
            routed[b] = (ri, rd, st)
            return ri, rd, st

        # phase 6's batches, uniform over the id space
        for b in range(1, MESH_UNIFORM + 1):
            route(b, batches[b])
        for b in (1, 2):
            gi_, gd_ = single_target(batches[b])
            check(np.array_equal(routed[b][0], gi_)
                  and np.array_equal(routed[b][1], gd_),
                  f"routed batch {b} differs from merge_topk over the "
                  f"four servers' own search")
        take("18 single-target reference")
        rec_r = recall(np.concatenate([routed[b][0] for b in range(
            1, MESH_UNIFORM + 1)]), np.concatenate(truth[:MESH_UNIFORM]))
        rec_1 = recall(np.concatenate([served[b - 1][0] for b in range(
            1, MESH_UNIFORM + 1)]), np.concatenate(truth[:MESH_UNIFORM]))
        print(f"  routed batches 1-2 bit-identical to merge_topk over the "
              f"4 servers' own search; recall@10 over batches 1-"
              f"{MESH_UNIFORM} against phase 6's brute force: routed "
              f"(4 x {n_s}) {rec_r:.4f}, the single {args.n} segment "
              f"{rec_1:.4f}")
        st1 = routed[1][2]
        print(f"  per_rank_modeled_us of batch 1 (a CostModel figure, "
              f"{router.cost_model.name} constants: a model, not a time "
              f"of the card): "
              f"{ {r: round(v, 3) for r, v in st1['per_rank_modeled_us'].items()} }"
              f"; modeled_step_us {st1['modeled_step_us']:.3f}")

        # a placement planned for segment-0-heavy traffic, then a stream
        # of queries near segment 0: the evaluation must fire, the next
        # must plan zero moves. The placement alone fires it: every rank
        # searches the whole batch, so the stream's skew leaves the rank
        # loads as they are, while segment 0's 4 replicas each own a
        # quarter of the rows
        skew_b = [query_set(x[:n_s], BATCH, seed=11 + j)
                  for j in range(MESH_SKEWED)]
        router._placement = plan_placement([5.0, 1.0, 1.0, 1.0],
                                           MESH_RANKS)
        router._restack()
        print(f"  placement planned for segment-0-heavy traffic: "
              f"{router.placement} (it, not the queries' skew, fires the "
              f"rebalance: every rank searches the whole batch)")
        evals = []
        for j in range(MESH_SKEWED):
            b = MESH_UNIFORM + 1 + j
            _, _, st = route(b, skew_b[j])
            if "rebalance" in st:
                evals.append((b, st["rebalance"]))
        check(len(evals) == 2 and evals[0][1]["fired"]
              and evals[0][1]["moves"] > 0,
              f"no rebalance fired on the skewed placement: {evals}")
        check(not evals[1][1]["fired"] and evals[1][1]["moves"] == 0,
              f"the evaluation after the rebalance planned moves: {evals}")
        b_pre = evals[0][0]
        pre_i, pre_d, _ = routed[b_pre]
        ri, rd, _ = route(b_pre, skew_b[b_pre - MESH_UNIFORM - 1])
        gi_, gd_ = single_target(skew_b[b_pre - MESH_UNIFORM - 1])
        take("18 single-target reference")
        check(np.array_equal(ri, pre_i) and np.array_equal(rd, pre_d),
              "the pre-rebalance batch served again differs")
        check(np.array_equal(ri, gi_) and np.array_equal(rd, gd_),
              "the pre-rebalance batch differs from merge_topk after the "
              "rebalance")
        print(f"  rebalance fired at batch {b_pre} (skew "
              f"{evals[0][1]['skew']:.4f}, {evals[0][1]['moves']} moves -> "
              f"{evals[0][1]['placement']}); batch {evals[1][0]} planned 0 "
              f"moves (skew {evals[1][1]['skew']:.4f}); batch {b_pre} "
              f"served again after it: ids and dists equal, and equal to "
              f"merge_topk over the servers' own search")
        coord_r = QueryCoordinator([router])
        qb = skew_b[0]
        sync(device)
        ci, cd, cst = coord_r.search(qb, k=10)
        take("18 routed")
        check(np.array_equal(ci, routed[MESH_UNIFORM + 1][0])
              and np.array_equal(cd, routed[MESH_UNIFORM + 1][1])
              and cst["total_block_reads"] == router.last_stats.cache_misses
              and cst["segments_searched"] == 1,
              "the router behind a QueryCoordinator differs from route()")
        print(f"  behind a QueryCoordinator: the batch of routed batch "
              f"{MESH_UNIFORM + 1} again, ids and dists equal (across the "
              f"rebalance), total_block_reads {cst['total_block_reads']}")
        print(f"  routed batch ms median {np.median(route_ms):.3f} over "
              f"{len(route_ms)} batches of {BATCH} ({router.world} ranks, "
              f"one device_anns a segment shared by its replicas); "
              f"rebalances {router.rebalances}")
        del router, msrv, coord_r, routed

    with phase("19 search step"):
        # make_search_step on a one-rank group (NCCL on the card, gloo in
        # the rehearsal) and a (1, 1) ("data", "model") mesh: phase 3's
        # segment as the [1, ...] stack, phase 12's batch as the rows
        from torch.distributed.device_mesh import init_device_mesh
        store = tempfile.TemporaryDirectory(prefix="chip_smoke_step_")
        dist.init_process_group(
            "nccl" if on_card else "gloo",
            init_method=f"file://{store.name}/store", rank=0, world_size=1,
            timeout=datetime.timedelta(seconds=300),
            **({"device_id": torch.device(
                "cuda", torch.cuda.current_device())} if on_card else {}))
        try:
            mesh = init_device_mesh(device.type, (1, 1),
                                    mesh_dim_names=("data", "model"))
            prod = make_debug_mesh(16, 16)
            _, (pseg, pq_spec) = DS.make_search_step(prod, rules_for(prod))
            rank_b = {f.name: getattr(pseg, f.name).local_nbytes
                      for f in dataclasses.fields(DS.DeviceSegment)}
            print(f"  production specs (16 x 16 mesh, JAX's defaults: 2M "
                  f"vectors a model rank, eps 16, bf16 vectors; not "
                  f"allocated): each rank's segment "
                  f"{sum(rank_b.values())} B ({rank_b}), queries "
                  f"{pq_spec.local_nbytes} B of {pq_spec.shape}")
            fn, (sseg, _) = DS.make_search_step(mesh, rules_for(mesh),
                                                n_local=seg.num_vectors)
            step_p = DeviceSearchParams(candidates=64, max_hops=128)
            stacked = DS.stack_segments([ds])
            qbig = torch.as_tensor(big, device=device)
            K.reset_all_launches()
            sync(device)
            t0 = time.perf_counter()
            out = fn(stacked, qbig)
            sync(device)
            step_ms = (time.perf_counter() - t0) * 1e3
            got = take("19 search step")
            direct = DS.device_anns(ds, qbig, step_p)
            take("19 direct device_anns and checks")
            want = (direct.ids, direct.dists, direct.io, direct.hops,
                    direct.tier0_hits, direct.dedup_saved,
                    direct.dedup_cross, direct.spec_hits,
                    direct.spec_wasted)
            names = ("gid", "dists", "io", "hops", "tier0_hits",
                     "dedup_saved", "dedup_cross", "spec_hits",
                     "spec_wasted")
            for name, o, w in zip(names, out, want):
                o = o.reshape(w.shape)
                check(o.dtype == w.dtype and torch.equal(
                    o.view(torch.int32) if o.dtype == torch.float32 else o,
                    w.view(torch.int32) if w.dtype == torch.float32 else w),
                      f"the search step's {name} differs from device_anns")
            ids_s, d_s = out[0].cpu().numpy(), out[1].cpu().numpy()
            check_results(big, ids_s, d_s)
            if on_card:
                check(got["gather_union"] == direct.rounds > 0
                      and got["fused_round_rank"] == direct.rounds,
                      "the step's launches do not follow its rounds")
            print(f"  step on {BIG_BATCH} queries x {seg.num_vectors} "
                  f"vectors (Γ {step_p.candidates}, {step_p.max_hops} hops):"
                  f" {step_ms:.3f} ms, rounds {direct.rounds}, launches "
                  f"{got}; gid, dists and the 7 columns equal device_anns "
                  f"bit for bit; io {float(direct.io.float().mean()):.3f}"
                  f" a query; arg shapes {tuple(sseg.vecs.shape)} "
                  f"{sseg.vecs.dtype} (specs), {tuple(stacked.vecs.shape)}"
                  f" {stacked.vecs.dtype} (served)")

            # the int8 all-reduce over the group against the plain formula
            gen = torch.Generator(device=device).manual_seed(args.seed)
            grads = {"w": torch.randn(4096, 256, device=device,
                                      generator=gen),
                     "b": [torch.zeros(1024, device=device),
                           torch.randn(333, device=device,
                                       generator=gen) * 1e-3]}
            errs = {"w": torch.randn(4096, 256, device=device,
                                     generator=gen) * 1e-2,
                    "b": [torch.zeros(1024, device=device),
                          torch.zeros(333, device=device)]}
            mean, err = compressed_psum(grads, errs, "data", mesh)
            for g_, e_, m_, r_ in ((grads["w"], errs["w"], mean["w"],
                                    err["w"]),
                                   *zip(grads["b"], errs["b"], mean["b"],
                                        err["b"])):
                c_ = g_ + e_
                s_ = torch.maximum(c_.abs().max() / 127.0, torch.tensor(
                    1e-12, device=device))
                q_ = torch.clamp(torch.round(c_ / s_), -127, 127)
                check(torch.equal(m_, q_.to(torch.int32).to(torch.float32)
                                  * s_ / 1)
                      and torch.equal(r_, c_ - q_ * s_),
                      "compressed_psum differs from the plain formula")
            with use_rules(SINGLE_POD_RULES, mesh):
                xs_ = shard(torch.randn(64, 32, device=device,
                                        generator=gen), "batch", "embed")
            pl_ = placements(logical_spec((64, 32), ("batch", "embed"),
                                          SINGLE_POD_RULES, mesh), mesh)
            check(isinstance(xs_, DTensor)
                  and xs_.to_local().device.type == device.type
                  and tuple(xs_.placements) == pl_,
                  f"shard gave {type(xs_).__name__} {xs_.placements}")
            print(f"  compressed_psum over the {dist.get_backend()} group "
                  f"equals the plain formula bit for bit (3 leaves, one "
                  f"all zero); shard -> {type(xs_).__name__} on "
                  f"{xs_.to_local().device} with {tuple(xs_.placements)}")
            take("19 direct device_anns and checks")

            # the step against the direct device_anns, in alternating
            # order; then device_anns on the stack's own [0] views against
            # the direct one: it tells the segment's memory (a fresh
            # contiguous stack against phase 3's arrays) from the step's
            # own work (the gathers and the merge)
            views = DS.DeviceSegment(**{
                f.name: getattr(stacked, f.name)[0]
                for f in dataclasses.fields(DS.DeviceSegment)})
            arms = {"step": lambda: fn(stacked, qbig),
                    "direct": lambda: DS.device_anns(ds, qbig, step_p),
                    "views": lambda: DS.device_anns(views, qbig, step_p)}

            def alternate(a, b):
                times = {a: [], b: []}
                for i in range(STEP_PAIRS):
                    for which in ((a, b) if i % 2 == 0 else (b, a)):
                        sync(device)
                        t0 = time.perf_counter()
                        arms[which]()
                        sync(device)
                        times[which].append(
                            (time.perf_counter() - t0) * 1e3)
                return times

            for a, b in (("step", "direct"), ("views", "direct")):
                times = alternate(a, b)
                print(f"  {a} ms median {np.median(times[a]):.3f} "
                      f"({[round(v, 3) for v in times[a]]}), {b} "
                      f"device_anns ms median {np.median(times[b]):.3f} "
                      f"({[round(v, 3) for v in times[b]]}), {STEP_PAIRS} "
                      f"alternating pairs of {BIG_BATCH} queries; {card}")
            take("19 timing")
            del stacked, views, out, direct
        finally:
            dist.destroy_process_group()
            store.cleanup()

    with phase("20 lm serve"):
        lm_serve(device, on_card, card, args.seed)
        take("20 lm serve")

    with phase("21 lm train"):
        lm_train(device, on_card, card, args.seed)
        take("21 lm train")

    with phase("22 lm mesh"):
        lm_mesh(device, on_card, card, args.seed)
        take("22 lm mesh")

    with phase("23 examples"):
        examples(device, on_card, card, args.seed, take)

    total = {name: sum(c[name] for c in by_phase.values())
             for name in KERNELS}
    print("launches by phase (phase 5's comparisons not counted):")
    for window, counts in by_phase.items():
        print(f"  {window}: " + (", ".join(
            f"{name} {counts[name]}" for name in KERNELS if counts[name])
            or "none"))
    print("  total: " + ", ".join(f"{name} {total[name]}"
                                  for name in KERNELS))
    out = []
    for name, (src, replaces) in KERNELS.items():
        k = kern[name]
        out.append({"name": name, "route": "cuda", "source": CSRC + src,
                    "replaces": replaces,
                    "launches": total[name],
                    "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                    "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                    "bound_by": k["bound_by"],
                    "library_ms": k["library_ms"], "ok": True})
    print(json.dumps({"kernels": out}))
    print(card)
    if on_card:
        kind = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": torch.cuda.device_count()}
    else:
        kind = {"platform": "cpu", "kind": "cpu rehearsal", "count": 0}
    print(json.dumps({"ok": True, "device": kind}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
