"""minitron-8b — width-pruned Nemotron dense decoder [arXiv:2407.14679].

32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=16384, vocab_size=256_000,
    rope_theta=10_000.0, act="silu", tie_embeddings=False,
    grad_accum=4,
)

SMOKE = ModelConfig(
    name="minitron-8b-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=192, vocab_size=512, tie_embeddings=False, remat=False,
)
