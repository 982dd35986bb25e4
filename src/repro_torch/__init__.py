"""PyTorch + CUDA port of the Starling segment search (the JAX package
``repro`` is the reference it is tested against).

Two paths are ported, each down to hand-written CUDA kernels for Hopper
(each with a plain PyTorch version that runs for CPU tensors):
  * the segment build: ``core.segment.build_segment`` -> ``core.graph``
    (Vamana, NSG), ``core.layout`` (BNP, BNF, GP3), ``core.navgraph``,
    ``pq.pq``, ``core.blockstore``; its brute force (``core.distances``)
    runs on the ``l2_tile`` kernel;
  * the batched device search as a segment server serves it:
    ``serving.coordinator.SegmentServer.search`` -> ``core.device_search``
    (``from_segment``, ``device_anns``, the round loop) -> the round
    kernels in ``kernels.tier0_fetch``.
``kernels.ops.pq_adc_batch`` (the ``pq_adc`` kernel) is the batched ADC
of the kernel API.

Entry points take ``device=`` and default to ``"cuda"``; nothing falls
back to the CPU when there is no card.
"""
