"""Transformer primitives (port of ``repro.models.layers``): RMSNorm, RoPE,
GQA attention (sliding window, QK-norm, KV cache), SwiGLU/GeGLU MLP,
mixture-of-experts FFN.

All functions are pure in their parameters: ``params`` dicts in, tensors
out. A KV cache is the exception: its buffers are written in place (JAX
returns new ones, which a donated cache makes the same), and only at
positions the old cache's ``len`` masks, so an earlier cache dict stays
valid. ``shard`` annotations are no-ops outside ``use_rules``.

Where PyTorch's defaults differ from JAX's, the JAX behaviour is kept:
GeLU is the tanh approximation, top-k breaks ties by the lower index, a
cache write clamps its start as ``lax.dynamic_update_slice`` does, and
the attention logits are an f32 product of q and k upcast before it.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.sharding import (axis_names, axis_sizes,
                                              current_rules, shard)


@dataclasses.dataclass(frozen=True)
class P:
    """Parameter spec: shape + logical axes + init style."""
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"          # normal | zeros | ones | custom key
    scale: float = 1.0
    dtype: Any = torch.float32

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def remat(fn, on: bool = True):
    """``jax.checkpoint``'s counterpart: ``fn`` under a non-reentrant
    ``torch.utils.checkpoint``, which keeps none of its activations and
    recomputes them in the backward, when ``on`` and autograd records;
    ``fn`` itself otherwise, so serving under ``inference_mode`` pays
    nothing. No function it wraps draws random numbers, so the RNG state
    is not stashed. Values are the same either way."""
    if not (on and torch.is_grad_enabled()):
        return fn
    return functools.partial(checkpoint, fn, use_reentrant=False,
                             preserve_rng_state=False)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = (x * x).mean(-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + gamma)).to(dt)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def activation(cfg):
    return F.silu if cfg.act == "silu" else gelu


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest, descending,
    ties to the lower index (a stable sort; ``torch.topk`` fixes no tie
    order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


# ------------------------------------------------------------------- RoPE

def rope_table(positions: torch.Tensor, head_dim: int,
               theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions [*] -> (sin, cos) each [*, head_dim/2] float32."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    freq = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                  device=positions.device), exps)
    ang = positions.float()[..., None] * freq
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor,
               cos: torch.Tensor) -> torch.Tensor:
    """x [B, S, H, hd]; sin/cos [B?, S, hd/2] broadcast over heads."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    sin = sin[..., None, :].to(x.dtype)
    cos = cos[..., None, :].to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# -------------------------------------------------------------- attention

# Blockwise (flash-style) attention kicks in above this many score
# elements per head; the chunk sizes are JAX's.
_BLOCKWISE_THRESHOLD = 1 << 21
Q_CHUNK = 512
KV_CHUNK = 1024


def _attn_mask(q_pos, kv_pos, window: int, kv_len: Optional[int],
               causal: bool) -> torch.Tensor:
    """window: a host int (0 = global); kv_len: a host int or None."""
    dist = q_pos[:, None] - kv_pos[None, :]            # [Sq, Sk]
    mask = (dist >= 0 if causal
            else torch.ones(dist.shape, dtype=torch.bool,
                            device=dist.device))
    if window > 0:
        mask = mask & (dist < window)
    if kv_len is not None:
        mask = mask & (kv_pos[None, :] < kv_len)
    return mask


def _logits(q, k, scale: float) -> torch.Tensor:
    """[B, Q, Hkv, G, hd] x [B, S, Hkv, hd] -> f32 [B, Hkv, G, Q, S]:
    q and k upcast before the product, as JAX's
    ``preferred_element_type=float32`` takes the products exactly."""
    return torch.einsum("bqkgd,bskd->bkgqs", q.float(), k.float()) * scale


def _plain_attention(q, k, v, q_pos, kv_pos, kv_len, window, causal):
    b, sq, hkv, g, hd = q.shape
    logits = _logits(q, k, hd ** -0.5)
    mask = _attn_mask(q_pos, kv_pos, window, kv_len, causal)
    logits = logits.masked_fill(~mask[None, None, None], -1e30)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bkgqs,bskd->bqkgd", probs, v)


def _chunk_of(s: int, target: int) -> int:
    """Largest divisor of s that is <= target."""
    c = min(target, s)
    while s % c:
        c -= 1
    return c


def _kv_step(m, l, acc, qi, ki, vi, mask, scale):
    """One KV chunk of the online softmax: (m, l, acc) -> the next."""
    s = _logits(qi, ki, scale)
    s = s.masked_fill(~mask[None, None, None], -1e30)
    m_new = torch.maximum(m, s.amax(-1))
    corr = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l_new = l * corr + p.sum(-1)
    acc_new = (acc * corr[..., None]
               + torch.einsum("bkgqs,bskd->bkgqd", p.to(vi.dtype), vi))
    return m_new, l_new, acc_new


def _blockwise_attention(q, k, v, q_pos, kv_pos, kv_len, window, causal):
    """Online-softmax attention: a loop over KV chunks inside a loop over
    Q chunks; the live score tensor is [B, Hkv, G, Qc, KVc] only. Each KV
    chunk's step is rematerialized under autograd, as JAX's ``kv_body``
    is checkpointed, so the backward keeps only the carries. q and k are
    upcast once (``_logits`` takes f32 products either way) and each
    chunk pair's mask is made outside the step."""
    b, sq, hkv, g, hd = q.shape
    sk = k.shape[1]
    qc = _chunk_of(sq, Q_CHUNK)
    kc = _chunk_of(sk, KV_CHUNK)
    scale = hd ** -0.5
    kv_step = remat(_kv_step)
    qf, kf = q.float(), k.float()
    outs = []
    for i in range(0, sq, qc):
        qi, qpi = qf[:, i:i + qc], q_pos[i:i + qc]
        m = torch.full((b, hkv, g, qc), -math.inf, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, hkv, g, qc), dtype=torch.float32,
                        device=q.device)
        acc = torch.zeros((b, hkv, g, qc, hd), dtype=torch.float32,
                          device=q.device)
        for j in range(0, sk, kc):
            mask = _attn_mask(qpi, kv_pos[j:j + kc], window, kv_len, causal)
            m, l, acc = kv_step(m, l, acc, qi, kf[:, j:j + kc],
                                v[:, j:j + kc], mask, scale)
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4))       # [B, qc, Hkv, G, hd]
    return torch.cat(outs, dim=1).to(v.dtype)


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_pos: torch.Tensor, kv_pos: torch.Tensor,
                  kv_len: Optional[int], window: int,
                  causal: bool = True) -> torch.Tensor:
    """Grouped-query attention.

    q [B, Sq, H, hd]; k/v [B, Sk, Hkv, hd]; q_pos [Sq]; kv_pos [Sk];
    kv_len — number of valid cache entries (decode) or None (all valid);
    window — a host int: 0 = global, w = sliding window of size w.
    Softmax in f32. Dispatches to blockwise (flash-style) attention when
    the score tensor would be large. Returns [B, Sq, H, hd].
    """
    b, sq, h, hd = q.shape
    hkv = k.shape[2]
    g = h // hkv
    q = q.reshape(b, sq, hkv, g, hd)
    if sq * k.shape[1] > _BLOCKWISE_THRESHOLD and sq >= 64:
        out = _blockwise_attention(q, k, v, q_pos, kv_pos, kv_len, window,
                                   causal)
    else:
        out = _plain_attention(q, k, v, q_pos, kv_pos, kv_len, window,
                               causal)
    return out.reshape(b, sq, h, hd)


def write_cache(buf: torch.Tensor, new: torch.Tensor,
                start: int) -> torch.Tensor:
    """Write ``new`` [B, S, ...] into ``buf`` [B, Smax, ...] at sequence
    position ``start``, in place, placed as ``jax.lax.dynamic_update_slice``
    places it: a negative start counts from the end, and the start is
    clamped into [0, Smax - S] so that the update fits."""
    s, smax = new.shape[1], buf.shape[1]
    start = int(start) + (smax if start < 0 else 0)
    start = min(max(start, 0), smax - s)
    buf[:, start:start + s] = new.to(buf.dtype)
    return buf


def attention_block(params: Dict, x: torch.Tensor, positions: torch.Tensor,
                    cfg, window: int,
                    cache: Optional[Dict] = None,
                    memory: Optional[torch.Tensor] = None,
                    causal: bool = True) -> Tuple[torch.Tensor,
                                                  Optional[Dict]]:
    """Full attention sub-block: norm -> qkv -> rope -> attn -> out-proj.

    ``cache`` (decode): {"k": [B, Smax, Hkv, hd], "v": ..., "len": int};
    new tokens are written at positions [len, len+Sq) (in place) and the
    cache with the new ``len`` is returned. ``memory`` (cross-attention):
    K/V come from memory and RoPE is skipped.
    """
    b, sq, _ = x.shape
    hd = cfg.hd
    xn = rms_norm(x, params["ln"], cfg.norm_eps)
    q = shard(torch.einsum("bsd,dhe->bshe", xn, params["wq"]),
              "batch", None, "heads", None)
    src = xn if memory is None else memory.to(xn.dtype)
    k = torch.einsum("bsd,dhe->bshe", src, params["wk"])
    v = torch.einsum("bsd,dhe->bshe", src, params["wv"])

    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)

    if memory is None:
        sin_q, cos_q = rope_table(positions, hd, cfg.rope_theta)
        q = apply_rope(q, sin_q, cos_q)
        k = apply_rope(k, sin_q, cos_q)

    kv_len = None
    if cache is not None and memory is None:
        start = cache["len"]
        ck = write_cache(cache["k"], k, start)
        cv = write_cache(cache["v"], v, start)
        cache = {"k": ck, "v": cv, "len": start + sq}
        k, v = ck.to(q.dtype), cv.to(q.dtype)
        kv_pos = torch.arange(ck.shape[1], device=x.device)
        kv_len = cache["len"]
    else:
        kv_pos = (positions if memory is None
                  else torch.arange(memory.shape[1], device=x.device))

    out = gqa_attention(q, k, v, positions, kv_pos, kv_len, window,
                        causal=causal and memory is None)
    out = torch.einsum("bshe,hed->bsd", out, params["wo"])
    return shard(out, "batch", None, "embed"), cache


# -------------------------------------------------------------------- MLP

def mlp_block(params: Dict, x: torch.Tensor, cfg,
              gated: bool = True) -> torch.Tensor:
    """Gated (SwiGLU/GeGLU) or plain two-matrix FFN, pre-norm."""
    xn = rms_norm(x, params["ln"], cfg.norm_eps)
    act = activation(cfg)
    up = torch.einsum("bsd,df->bsf", xn, params["w_up"])
    if gated:
        gate = torch.einsum("bsd,df->bsf", xn, params["w_gate"])
        hidden = act(gate) * up
    else:
        hidden = act(up)
    hidden = shard(hidden, "batch", None, "ff")
    out = torch.einsum("bsf,fd->bsd", hidden, params["w_down"])
    return shard(out, "batch", None, "embed")


# -------------------------------------------------------------------- MoE

def _dense_dispatch(params: Dict, xn: torch.Tensor, combine: torch.Tensor,
                    cfg, act) -> torch.Tensor:
    """Every expert on every token, masked by combine [B, S, E]; the
    combine weights fold into the hidden before the down projection."""
    gate = torch.einsum("bsd,edf->bsef", xn, params["w_gate"])
    up = torch.einsum("bsd,edf->bsef", xn, params["w_up"])
    hidden = shard(act(gate) * up, "batch", None, "experts", None)
    hidden = hidden * combine[..., None]
    return torch.einsum("bsef,efd->bsd", hidden, params["w_down"])


def _capacity_dispatch(params: Dict, xn: torch.Tensor,
                       combine: torch.Tensor, cfg, act) -> torch.Tensor:
    """Capacity-based gather dispatch (GShard/Switch-style, dropping):
    per sequence, each expert takes its top-C tokens by combine weight
    (C = S*k*cf/E, ties to the lower token index)."""
    b, s, d = xn.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    cap = max(min(s, int(math.ceil(s * k * cfg.moe_capacity_factor / e))),
              1)
    w_te = combine.transpose(1, 2)                      # [B, E, S]
    top_w, top_s = top_k(w_te, cap)                     # [B, E, C]
    top_w = shard(top_w, "batch", "experts", None)
    top_s = shard(top_s, "batch", "experts", None)
    xn = shard(xn, "batch", None, None)
    rows = torch.arange(b, device=xn.device)[:, None, None].expand_as(top_s)
    xg = xn[rows, top_s]                                # [B, E, C, D]
    xg = shard(xg, "batch", "experts", None, None)
    gate = torch.einsum("becd,edf->becf", xg, params["w_gate"])
    up = torch.einsum("becd,edf->becf", xg, params["w_up"])
    hidden = shard(act(gate) * up, "batch", "experts", None, None)
    hidden = hidden * top_w[..., None].to(hidden.dtype)
    part = torch.einsum("becf,efd->becd", hidden, params["w_down"])
    out = torch.zeros((b, s, d), dtype=part.dtype, device=part.device)
    out.index_put_((rows, top_s), part, accumulate=True)
    return shard(out, "batch", None, "embed")


def _expert_parallel(cfg) -> bool:
    """JAX's condition for ``_capacity_dispatch_ep``: capacity dispatch
    under a mesh whose ``model`` axis divides the experts."""
    _, mesh = current_rules()
    return (cfg.moe_dispatch == "capacity" and mesh is not None
            and "model" in axis_names(mesh)
            and cfg.num_experts % axis_sizes(mesh)["model"] == 0)


def moe_block(params: Dict, x: torch.Tensor, cfg
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k routed mixture of experts. Dispatch: ``cfg.moe_dispatch`` =
    "dense" (all experts on all tokens) or "capacity" (gather top-C
    tokens per expert). Returns (out, aux_loss).

    JAX runs capacity dispatch under a mesh with a ``model`` axis as an
    expert-parallel ``shard_map`` (``_capacity_dispatch_ep``); that comes
    with the slice that ports ``launch/{specs,dryrun}``, and until then
    this raises rather than run the unsharded dispatch."""
    if _expert_parallel(cfg):
        raise NotImplementedError(
            "moe_block: capacity dispatch under a mesh with a 'model' axis "
            "is JAX's expert-parallel _capacity_dispatch_ep, which comes "
            "with the slice that ports launch/{specs,dryrun}")
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    xn = rms_norm(x, params["ln"], cfg.norm_eps)
    logits = torch.einsum("bsd,de->bse", xn.float(),
                          params["router"].float())
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = top_k(probs, k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    # combine weights as a dense [B, S, E] tensor (0 for unrouted experts)
    combine = torch.zeros((b, s, e), dtype=torch.float32, device=x.device)
    combine.scatter_(-1, top_i, top_p)
    combine = shard(combine.to(x.dtype), "batch", None, "experts")

    act = activation(cfg)
    if cfg.moe_dispatch == "capacity":
        out = _capacity_dispatch(params, xn, combine, cfg, act)
    else:
        out = _dense_dispatch(params, xn, combine, cfg, act)

    if cfg.num_shared_experts:
        sh_gate = torch.einsum("bsd,df->bsf", xn, params["shared_w_gate"])
        sh_up = torch.einsum("bsd,df->bsf", xn, params["shared_w_up"])
        out = out + torch.einsum("bsf,fd->bsd", act(sh_gate) * sh_up,
                                 params["shared_w_down"])

    # load-balancing aux loss (Switch-style): E * sum_e f_e * P_e
    frac_routed = (combine > 0).float().mean(dim=(0, 1))
    mean_prob = probs.mean(dim=(0, 1))
    aux = e * torch.sum(frac_routed * mean_prob)
    return shard(out, "batch", None, "embed"), aux


def dense_layer(params: Dict, x: torch.Tensor, positions: torch.Tensor,
                cfg, window: int, cache: Optional[Dict] = None,
                causal: bool = True) -> Tuple[torch.Tensor, Optional[Dict],
                                              torch.Tensor]:
    """One decoder layer: attention + FFN (residual, pre-norm).
    Returns (x, cache, aux_loss)."""
    a, cache = attention_block(params["attn"], x, positions, cfg, window,
                               cache=cache, causal=causal)
    x = x + a
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "moe" and "moe" in params:
        m, aux = moe_block(params["moe"], x, cfg)
    else:
        m = mlp_block(params["mlp"], x, cfg)
    return x + m, cache, aux
