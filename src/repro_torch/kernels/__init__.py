# The hand-written CUDA kernels for Hopper (csrc/*.cu), built by
# _build.py on first use, and their wrappers:
#   tier0_fetch — the round kernels of the device search: gather_union
#                 (batch union + one copy per distinct block),
#                 gather_unique (the copy alone) and fused_round_rank
#                 (tier-0 probe, broadcast, distances, stable
#                 top-n_expand order), chained by fused_round; and
#                 tier0_fetch_rank (the probe and distances alone)
#   l2_tile     — tiled exact distances, the build's brute force
#   pq_adc      — batched PQ asymmetric distances
#   block_topk  — one block's exact distances and top-m slots per query
#   dedup       — the sorted-unique / join-mask helpers the kernels'
#                 plain versions and the loop's accounting share
#   ref         — the plain PyTorch version of each kernel
#   ops         — pairwise_l2, pq_adc_batch, tier0_rank, block_rank,
#                 round_tile and the padding wrapper fused_round
from repro_torch.kernels import block_topk as _bt
from repro_torch.kernels import l2_tile as _l2
from repro_torch.kernels import pq_adc as _adc
from repro_torch.kernels import tier0_fetch as _t0
from repro_torch.kernels.dedup import join_mask, sorted_unique_ranks
from repro_torch.kernels.ops import (block_rank, fused_round, pairwise_l2,
                                     pq_adc_batch, round_tile, tier0_rank)
from repro_torch.kernels.tier0_fetch import LAUNCHES, reset_launches

_COUNTED = (_t0, _l2, _adc, _bt)


def launch_counts() -> dict:
    """Every kernel's launch count, by wrapper name."""
    return {k: v for mod in _COUNTED for k, v in mod.LAUNCHES.items()}


def reset_all_launches() -> None:
    for mod in _COUNTED:
        mod.reset_launches()
