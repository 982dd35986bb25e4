"""The batched PQ asymmetric-distance kernel (CUDA, ``csrc/pq_adc.cu``)
and its wrapper.

``pq_adc(codes, luts)`` gives ``out[b, n] = sum_m luts[b, m, codes[n,
m]]`` for codes [N, M] u8 and LUTs [B, M, K] f32, as the [B, N] f32
array of ``repro.kernels.ops.pq_adc_batch``, the M terms added in
numpy's pairwise order (``ref.pairwise_sum``: the order of the JAX host
search's ``adc_distance``, so the host search's keys equal its bits). It replaces ``repro.
kernels.pq_adc.pq_adc``: the TPU kernel's one-hot matmul becomes table
lookups in shared memory, the LUTs of 16 queries (8 or 4 where the
batch is smaller or the tables larger) staged query-interleaved. The
kernel is bound by the bytes of its output, see the note at the top of
the CUDA source. M is one of ``M_SUPPORTED``.

For CPU tensors the wrapper runs the plain version (``ref.pq_adc_ref``);
for CUDA tensors it launches the kernel, or raises. Each launch adds one
to ``LAUNCHES["pq_adc"]``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

LAUNCHES = {"pq_adc": 0}
SMEM_BYTES = 227 * 1024   # shared memory a CTA may hold on an H100
M_SUPPORTED = (2, 4, 8, 16, 32)   # the kernel's instances


def reset_launches() -> None:
    LAUNCHES["pq_adc"] = 0


def tile_queries(m: int, k: int, b: int) -> int:
    """The queries a CTA stages at once (16, 8 or 4): the fewest that
    cover a batch of ``b`` below 16, and no more than fit the shared
    memory (``bq·m·k·4`` bytes)."""
    for bq in (16, 8, 4):
        if bq * m * k * 4 <= SMEM_BYTES and (bq == 4 or b > bq // 2):
            return bq
    raise ValueError(f"pq_adc: the LUTs of 4 queries ({4 * m * k * 4} B) "
                     f"exceed the {SMEM_BYTES} B of shared memory")


def pq_adc(codes: torch.Tensor, luts: torch.Tensor) -> torch.Tensor:
    """codes [N, M] u8 x luts [B, M, K] f32 -> [B, N] f32."""
    if codes.dim() != 2 or luts.dim() != 3 or codes.shape[1] != luts.shape[1]:
        raise ValueError(f"pq_adc: shapes {tuple(codes.shape)} and "
                         f"{tuple(luts.shape)} do not pair")
    if codes.device.type == "cpu":
        return ref.pq_adc_ref(luts, codes)
    _build.require("pq_adc", codes=(codes, torch.uint8),
                   luts=(luts, torch.float32))
    n, m = codes.shape
    b, _, k = luts.shape
    if m not in M_SUPPORTED:
        raise ValueError(f"pq_adc: M = {m} is not one of {M_SUPPORTED}")
    bq = tile_queries(m, k, b)
    out = torch.empty((b, n), dtype=torch.float32, device=codes.device)
    lib = _build.load("pq_adc")
    _build.check(lib.pq_adc(codes.data_ptr(), luts.data_ptr(), n, m, k, b,
                            bq, out.data_ptr(), _build.stream()), "pq_adc")
    LAUNCHES["pq_adc"] += 1
    return out
