"""whisper-base — encoder-decoder ASR backbone [arXiv:2212.04356].

6L(enc)+6L(dec) d_model=512 8H d_ff=2048 vocab=51865; plain GELU MLP.
The conv frame frontend is a STUB: ``input_specs`` supplies 1500
precomputed frame embeddings.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="audio",
    num_layers=6, encoder_layers=6, num_mem_tokens=1500,
    d_model=512, num_heads=8, num_kv_heads=8,
    d_ff=2048, vocab_size=51_865,
    act="gelu", tie_embeddings=True, grad_accum=1,
)

SMOKE = ModelConfig(
    name="whisper-smoke", family="audio",
    num_layers=2, encoder_layers=2, num_mem_tokens=12,
    d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=512, act="gelu", remat=False,
)
