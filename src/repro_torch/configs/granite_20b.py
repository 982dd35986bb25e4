"""granite-20b — llama-arch code model, MQA [arXiv:2405.04324].

52L d_model=6144 48H (GQA kv=1) d_ff=24576 vocab=49152.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b", family="dense",
    num_layers=52, d_model=6144, num_heads=48, num_kv_heads=1,
    d_ff=24_576, vocab_size=49_152,
    rope_theta=10_000.0, act="silu", tie_embeddings=False,
    grad_accum=8,
)

SMOKE = ModelConfig(
    name="granite-20b-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=8, num_kv_heads=1,
    d_ff=256, vocab_size=512, tie_embeddings=False, remat=False,
)
