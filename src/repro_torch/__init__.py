"""PyTorch + CUDA port of the Starling segment search (the JAX package
``repro`` is the reference it is tested against).

Five paths are ported, each down to hand-written CUDA kernels for
Hopper (each with a plain PyTorch version that runs for CPU tensors):
  * the segment build: ``core.segment.build_segment`` -> ``core.graph``
    (Vamana, NSG), ``core.layout`` (BNP, BNF, GP3), ``core.navgraph``,
    ``pq.pq``, ``core.blockstore``; its brute force (``core.distances``)
    runs on the ``l2_tile`` kernel;
  * the batched device search as a segment server serves it:
    ``serving.coordinator.SegmentServer.search`` -> ``core.device_search``
    (``from_segment``, ``device_anns``, the round loop) -> the round
    kernels in ``kernels.tier0_fetch``;
  * the serving plane on one card: ``serving.coordinator.
    QueryCoordinator`` over device and host segment servers, with a
    ``serving.batcher.RequestBatcher`` in front and a ``serving.
    scheduler.RepackScheduler`` steering the tier-0 pack; the host
    server's block search (``core.search``) reads through the block
    cache (``io.cached_store``, ``io.cache``, ``io.prefetch``,
    ``io.async_fetch``) and ranks its candidates by PQ-ADC through the
    ``pq_adc`` kernel; the observability plane (``obs``: spans on an
    injected clock, the metrics registry, the Chrome-trace export and
    the ``CostModel`` fit) reports through every layer of it;
  * the mesh router on one card: ``serving.router.MeshQueryRouter``
    fans a batch over W ranks (``launch.mesh.make_debug_mesh``), each
    taking its segment's ``device_anns`` (one a distinct segment, shared
    by its replicas) on the round kernels, merges the
    ranks' top-k (``core.device_search.merge_shard_topk``) and moves
    replicas between ranks (``distributed.elastic``);
  * the search step over the ranks of a ``torch.distributed`` process
    group: ``core.device_search.make_search_step`` (one segment a
    ``model`` rank, the batch split over ``data``, an all-gather of the
    k results), with ``distributed.sharding``'s logical-axis rules,
    ``distributed.compress``'s int8 all-reduce and ``launch.mesh``'s
    production mesh; ``configs`` holds the presets and the
    architectures' shapes.

Beside them, the language models (``models``, every family of
``configs``; no hand kernel, as JAX's have no Pallas one):
``launch.serve`` prefills and decodes, ``launch.train`` trains them with
``optim``'s AdamW on ``data.pipeline``'s token stream, ``ft``'s
checkpoints and remat where JAX has it.

Entry points take ``device=`` and default to ``"cuda"``; nothing falls
back to the CPU when there is no card.
"""
