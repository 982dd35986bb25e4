"""qwen3-moe-235b-a22b — MoE decoder, 128 experts top-8
[hf:Qwen/Qwen3-235B family].

94L d_model=4096 64H (GQA kv=4, head_dim=128) moe_d_ff=1536
vocab=151936; QK-norm.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    num_layers=94, d_model=4096, num_heads=64, num_kv_heads=4,
    head_dim=128, d_ff=1536, vocab_size=151_936,
    num_experts=128, experts_per_token=8, moe_d_ff=1536,
    qk_norm=True, rope_theta=1_000_000.0, act="silu",
    tie_embeddings=False, grad_accum=16,
    # §Perf iteration 5: shard_map EP capacity dispatch + bf16 state
    # (multi-pod runs use grad_accum=8 so the microbatch shards 32-way)
    moe_dispatch="capacity", mixed_state=True,
)

SMOKE = ModelConfig(
    name="qwen3-moe-smoke", family="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=96, vocab_size=512, num_experts=8, experts_per_token=2,
    moe_d_ff=96, qk_norm=True, tie_embeddings=False, remat=False,
)
