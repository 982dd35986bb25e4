# Model zoo substrate (port of ``repro.models``): every assigned
# architecture family in PyTorch.
#   config   — ModelConfig covering dense / MoE / VLM / audio / hybrid / SSM
#   layers   — attention (GQA+RoPE+window+QK-norm+softcap), SwiGLU, MoE
#   ssm      — Mamba2 chunked SSD scan, RWKV6 chunked WKV scan, decode steps
#   lm       — param specs/init, forward+loss, prefill, decode
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import (init_params, param_specs, loss_fn, forward,
                                   prefill, decode_step, init_cache)
