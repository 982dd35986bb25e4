# Model zoo substrate (port of ``repro.models``). This slice holds the
# configuration alone:
#   config   — ModelConfig covering dense / MoE / VLM / audio / hybrid / SSM
# The ``lm`` names (init_params, param_specs, loss_fn, forward, prefill,
# decode_step, init_cache) come with the slice that ports
# ``models/{layers,lm,ssm}``.
from repro_torch.models.config import ModelConfig
