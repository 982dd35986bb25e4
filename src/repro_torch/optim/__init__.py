# AdamW and its schedules (port of ``repro.optim``): plain functions over
# the port's parameter trees, with JAX's state and order of operations.
from repro_torch.optim.adamw import (AdamW, adamw_init, adamw_update,
                                     cosine_schedule, linear_warmup,
                                     global_norm, clip_by_global_norm)
