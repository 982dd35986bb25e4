"""zamba2-1.2b — hybrid Mamba2 trunk + shared attention block
[arXiv:2411.15242].

38 Mamba2 layers d_model=2048, ssm_state=64; one *shared* attention block
(32H, kv=32, d_ff=8192 SwiGLU) applied every 6 layers; vocab=32000.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    num_layers=38, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=32_000,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_conv=4,
    shared_attn_period=6,
    rope_theta=10_000.0, act="silu", tie_embeddings=True,
    grad_accum=4,   # §Perf: fits 16GB (25.1 -> 12.6 GiB/chip)
)

SMOKE = ModelConfig(
    name="zamba2-smoke", family="hybrid",
    num_layers=5, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=512,
    ssm_state=16, ssm_head_dim=16, ssm_expand=2, ssm_conv=4,
    shared_attn_period=2, remat=False,
)
