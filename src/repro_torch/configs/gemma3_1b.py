"""gemma3-1b — dense decoder, 5:1 local:global attention
[hf:google/gemma-3-1b-pt].

26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144; sliding window 512
on local layers, every 6th layer global; QK-norm; scaled embeddings.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b", family="dense",
    num_layers=26, d_model=1152, num_heads=4, num_kv_heads=1,
    head_dim=256, d_ff=6912, vocab_size=262_144,
    window=512, global_every=6, qk_norm=True, scale_embed=True,
    rope_theta=1_000_000.0, act="gelu", tie_embeddings=True,
    grad_accum=2,
)

SMOKE = ModelConfig(
    name="gemma3-1b-smoke", family="dense",
    num_layers=4, d_model=64, num_heads=4, num_kv_heads=1, head_dim=16,
    d_ff=160, vocab_size=512, window=16, global_every=2, qk_norm=True,
    scale_embed=True, act="gelu", remat=False,
)
