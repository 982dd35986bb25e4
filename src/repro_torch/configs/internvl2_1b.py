"""internvl2-1b — VLM backbone (Qwen2-0.5B LM trunk) [arXiv:2404.16821].

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655. The InternViT
frontend is a STUB: ``input_specs`` supplies 256 precomputed patch
embeddings per image, prepended to the token sequence.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b", family="vlm",
    num_layers=24, d_model=896, num_heads=14, num_kv_heads=2,
    d_ff=4864, vocab_size=151_655, patch_tokens=256,
    rope_theta=1_000_000.0, act="silu", tie_embeddings=True,
    grad_accum=2,
)

SMOKE = ModelConfig(
    name="internvl2-smoke", family="vlm",
    num_layers=2, d_model=56, num_heads=7, num_kv_heads=1,
    d_ff=128, vocab_size=512, patch_tokens=8, remat=False,
)
