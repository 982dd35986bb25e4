# Distribution substrate (port of ``repro.distributed``):
#   sharding — logical-axis rules -> PartitionSpec / DTensor placements,
#              the local-shard einsum and argument specs
#   hlo      — per-rank op trace (the counterpart of HLO text): FLOPs,
#              bytes and collective bytes
#   compress — int8 gradient all-reduce with error feedback
#   elastic  — re-mesh planner for node loss (shrink data axis, keep
#              batch) and the router's segment placement
from repro_torch.distributed.sharding import (AxisRules, SINGLE_POD_RULES,
                                              MULTI_POD_RULES, logical_spec,
                                              shard, set_rules,
                                              current_rules,
                                              param_sharding_tree)
from repro_torch.distributed.compress import (compress_with_feedback,
                                              compressed_psum, dequantize,
                                              ef_init, quantize)
