"""rwkv6-1.6b — Finch: attention-free, data-dependent decay
[arXiv:2404.05892].

24L d_model=2048 (32 WKV heads x 64) d_ff=7168 vocab=65536.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b", family="ssm",
    num_layers=24, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=7168, vocab_size=65_536,
    rwkv_head_dim=64, rwkv_lora=32, rwkv_decay_lora=64,
    act="silu", tie_embeddings=False, grad_accum=4,
)

SMOKE = ModelConfig(
    name="rwkv6-smoke", family="ssm",
    num_layers=2, d_model=64, num_heads=2, num_kv_heads=2,
    d_ff=128, vocab_size=512,
    rwkv_head_dim=32, rwkv_lora=8, rwkv_decay_lora=8,
    tie_embeddings=False, remat=False,
)
