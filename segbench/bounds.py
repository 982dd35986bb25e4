"""The card's peaks and the least time of the round kernels' launches.

The bytes are those that a launch's inputs need, each input byte read
once and each output byte written once (the arithmetic behind the port's
kernel table, copied here so that the yardstick does not move with the
program), and the least time is the larger of bytes over the HBM rate
and operations over the f32 rate.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at its 700 W limit
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# the device kernels that the counted wrappers (``gather_union``,
# ``fused_round_rank``) launch, by their names in ``csrc/tier0_fetch.cu``
ROUND_KERNELS = ("union_gather_kernel", "mark_kernel", "rank_kernel")


def _least(nbytes: float, ops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


def gather_union_least_s(r: int, ndist: int, eps: int, d: int,
                         lam: int) -> float:
    """``t0_gather_union`` on ``r`` target slots with ``ndist`` distinct
    blocks: the keys read, each distinct block's vectors, ids and
    neighbour rows read once, uniq and the ranks written, and the R
    union rows written (rows past the distinct count hold block 0)."""
    payload = eps * (d + 1 + lam) * 4
    return _least(r * 4 + ndist * payload + 2 * r * 4 + r * payload, 0)


def rank_least_s(qn: int, f: int, live_rows: int, ndist: int, eps: int,
                 d: int, lam: int, n_expand: int) -> float:
    """``t0_rank`` (pass 2b) on ``qn`` rows of ``f`` picks each, of which
    ``live_rows`` lie in a query tile with work (an all-idle tile reads
    no query and no payload): u, rank2d and uniq read, the live rows'
    queries and each distinct block's payload read once, and every
    row's distances, ids, neighbour rows, hits and order written."""
    r = qn * f
    fe = f * eps
    payload = eps * (d + 1 + lam) * 4
    nbytes = (live_rows * d * 4 + 3 * r * 4 + ndist * (payload + 4)
              + qn * fe * (2 + lam) * 4 + qn * (f + n_expand) * 4)
    return _least(nbytes, 3 * live_rows * fe * d)
