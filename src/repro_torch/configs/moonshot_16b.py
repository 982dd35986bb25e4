"""moonshot-v1-16b-a3b — Moonlight (DeepSeek-style) MoE, 64 experts top-6
with shared experts [hf:moonshotai/Moonlight-16B-A3B].

48L d_model=2048 16H (GQA kv=16) moe_d_ff=1408 vocab=163840.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    num_layers=48, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1408, vocab_size=163_840,
    num_experts=64, experts_per_token=6, moe_d_ff=1408,
    num_shared_experts=2,
    rope_theta=50_000.0, act="silu", tie_embeddings=False,
    grad_accum=4, moe_dispatch="capacity", mixed_state=True,
)

SMOKE = ModelConfig(
    name="moonshot-smoke", family="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=96, vocab_size=512, num_experts=8, experts_per_token=2,
    moe_d_ff=96, num_shared_experts=1, tie_embeddings=False, remat=False,
)
