"""PyTorch + CUDA port of the Starling segment search (the JAX package
``repro`` is the reference it is tested against).

Slice 1 carries the batched device search as a segment server serves it:
``serving.coordinator.SegmentServer.search`` -> ``core.device_search``
(``from_segment``, ``device_anns``, the round loop) -> the round kernels
in ``kernels.tier0_fetch`` (hand-written CUDA for Hopper, with a plain
PyTorch version of each that runs for CPU tensors).

Entry points take ``device=`` and default to ``"cuda"``; nothing falls
back to the CPU when there is no card.
"""
