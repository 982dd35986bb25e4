# Round kernels of the batched device search, hand-written in CUDA for
# Hopper (csrc/tier0_fetch.cu), built by _build.py on first use:
#   tier0_fetch — gather_union (batch union + one copy per distinct
#                 block), gather_unique (the copy alone) and
#                 fused_round_rank (tier-0 probe, broadcast, distances,
#                 stable top-n_expand order), chained by fused_round
#   dedup       — the sorted-unique / join-mask helpers the kernels'
#                 plain versions and the loop's accounting share
#   ref         — the plain PyTorch version of each kernel
#   ops         — round_tile and the padding wrapper fused_round
from repro_torch.kernels.dedup import join_mask, sorted_unique_ranks
from repro_torch.kernels.ops import fused_round, round_tile
from repro_torch.kernels.tier0_fetch import LAUNCHES, reset_launches
