"""ModelConfig — one dataclass that spans the 10 assigned families (port
of ``repro.models.config``: the same fields, checks and derived values).

Families:
  dense   — decoder-only transformer (stablelm-3b, minitron-8b, gemma3-1b,
            granite-20b; internvl2-1b backbone is dense too)
  moe     — dense attention + mixture-of-experts FFN (qwen3-moe, moonshot)
  vlm     — dense backbone; patch embeddings are prepended (frontend = stub)
  audio   — encoder–decoder (whisper); conv frontend = stub frame embeddings
  hybrid  — Mamba2 trunk + a *shared* attention block every k layers (zamba2)
  ssm     — attention-free RWKV6 (Finch) trunk

Every dimension knob used by any arch lives here; the per-arch files in
``repro_torch/configs`` fill them in with the published numbers.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | vlm | audio | hybrid | ssm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // num_heads

    # --- attention flavour ---
    window: int = 0               # sliding-window size; 0 = global
    global_every: int = 0         # gemma3: every Nth layer is global (5:1)
    rope_theta: float = 10_000.0
    qk_norm: bool = False         # gemma3-style per-head RMS on q/k
    logit_softcap: float = 0.0    # final-logit soft capping
    tie_embeddings: bool = True

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0             # per-expert FFN width
    num_shared_experts: int = 0   # moonshot/deepseek-style shared expert
    router_aux_coef: float = 0.01
    moe_dispatch: str = "dense"   # dense | capacity (see layers.moe_block)
    moe_capacity_factor: float = 1.25

    # --- SSM (Mamba2) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 128

    # --- hybrid (zamba2) ---
    shared_attn_period: int = 0   # apply the shared attn block every k layers

    # --- RWKV6 ---
    rwkv_head_dim: int = 64
    rwkv_lora: int = 32           # ddlerp low-rank width
    rwkv_decay_lora: int = 64

    # --- encoder–decoder (whisper) ---
    encoder_layers: int = 0
    num_mem_tokens: int = 0       # encoder memory length (1500 audio frames)

    # --- VLM ---
    patch_tokens: int = 0         # prepended precomputed patch embeddings

    # --- numerics / training ---
    mixed_state: bool = False     # cast fp32 master -> sharded bf16 copy
    #                               inside train_step (bf16 collectives);
    #                               False = the recorded baseline
    scale_embed: bool = False     # gemma: multiply embeddings by sqrt(D)
    act: str = "silu"             # silu (SwiGLU) | gelu (GeGLU)
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"       # activation/compute dtype
    param_dtype: str = "float32"
    remat: bool = True
    grad_accum: int = 1           # microbatch count inside train_step
    scan_layers: bool = True

    def __post_init__(self):
        assert self.family in ("dense", "moe", "vlm", "audio", "hybrid",
                               "ssm")
        if self.family == "moe":
            assert self.num_experts > 0 and self.experts_per_token > 0
        if self.family == "hybrid":
            assert self.ssm_state > 0 and self.shared_attn_period > 0
        if self.family == "audio":
            assert self.encoder_layers > 0 and self.num_mem_tokens > 0
        if self.family == "vlm":
            assert self.patch_tokens > 0

    # ------------------------------------------------------- derived dims
    @property
    def padded_vocab(self) -> int:
        """Embedding rows padded to a 512 multiple so the vocab dim shards
        over any TP degree up to 512 (Megatron-style); loss and decode
        mask the padded columns."""
        return -(-self.vocab_size // 512) * 512

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.hd

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.hd

    @property
    def d_inner(self) -> int:
        """Mamba2 inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    def layer_windows(self) -> Tuple[int, ...]:
        """Per-layer sliding-window size (0 = global attention).

        gemma3 pattern: ``global_every``−1 local layers then 1 global,
        repeating (5 local : 1 global), final layer global.
        """
        if self.window == 0:
            return tuple(0 for _ in range(self.num_layers))
        if self.global_every <= 0:
            return tuple(self.window for _ in range(self.num_layers))
        out = []
        for i in range(self.num_layers):
            is_global = (i + 1) % self.global_every == 0
            out.append(0 if is_global else self.window)
        return tuple(out)

    def num_params(self) -> int:
        """Analytic parameter count (used by MODEL_FLOPS = 6·N·D)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        n = v * d                                   # embedding
        if not self.tie_embeddings:
            n += v * d
        if self.family in ("dense", "moe", "vlm"):
            attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
            if self.family == "moe":
                mlp = 3 * d * self.moe_d_ff * self.num_experts
                mlp += 3 * d * self.moe_d_ff * self.num_shared_experts
                mlp += d * self.num_experts      # router
            else:
                mlp = 3 * d * ff
            n += self.num_layers * (attn + mlp + 2 * d)
        elif self.family == "audio":
            attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
            mlp = 2 * d * ff                    # whisper MLP is non-gated
            n += self.encoder_layers * (attn + mlp + 2 * d)
            n += self.num_layers * (2 * attn + mlp + 3 * d)  # self+cross
        elif self.family == "hybrid":
            di, s, hh = self.d_inner, self.ssm_state, self.ssm_heads
            mamba = (d * (2 * di + 2 * s + hh)    # in_proj (z,x,B,C,dt)
                     + di * d + 3 * hh            # out_proj, A/D/dt_bias
                     + self.ssm_conv * (di + 2 * s))
            n += self.num_layers * (mamba + d)
            attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
            n += attn + 3 * d * ff + 2 * d        # one shared block
        elif self.family == "ssm":
            lora, dl = self.rwkv_lora, self.rwkv_decay_lora
            tmix = (4 * d * d                     # r,k,v,out
                    + d * d                       # gate
                    + 5 * (d * lora + lora * d)   # ddlerp loras
                    + d * dl + dl * d             # decay lora
                    + 2 * d + 6 * d)              # u, w0, mus
            cmix = d * ff + ff * d + d * d + 2 * d
            n += self.num_layers * (tmix + cmix + 2 * d)
        return n

    def active_params(self) -> int:
        """Active parameter count per token (MoE: only routed experts)."""
        if self.family != "moe":
            return self.num_params()
        d = self.d_model
        dense_experts = self.experts_per_token + self.num_shared_experts
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        mlp = 3 * d * self.moe_d_ff * dense_experts + d * self.num_experts
        n = self.vocab_size * d + self.num_layers * (attn + mlp + 2 * d)
        if not self.tie_embeddings:
            n += self.vocab_size * d
        return n
