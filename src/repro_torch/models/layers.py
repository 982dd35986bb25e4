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

Under ``use_rules`` on a ``DeviceMesh`` the parameters and activations
are DTensors: the contractions go through ``distributed.sharding.
einsum`` (each rank contracts its local shards), a KV cache is written
rank by rank into its local shard, and capacity dispatch under a mesh
with a ``model`` axis is JAX's expert-parallel ``_capacity_dispatch_ep``.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.sharding import (as_dtensor, axis_names,
                                              axis_sizes, batch_local,
                                              current_rules, einsum,
                                              from_local_shard, local_shard,
                                              logical_spec, placements,
                                              shard, unshard_dim, ways)


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
    return einsum("bqkgd,bskd->bkgqs", q.float(), k.float()) * scale


def _plain_attention(q, k, v, q_pos, kv_pos, kv_len, window, causal):
    b, sq, hkv, g, hd = q.shape
    logits = _logits(q, k, hd ** -0.5)
    mask = _attn_mask(q_pos, kv_pos, window, kv_len, causal)
    logits = logits.masked_fill(~mask[None, None, None], -1e30)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return einsum("bkgqs,bskd->bqkgd", probs, v)


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
               + einsum("bkgqs,bskd->bkgqd", p.to(vi.dtype), vi))
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
        # the carries are laid out as q's chunk (on a mesh: each rank's)
        acc = torch.zeros_like(qi.permute(0, 2, 3, 1, 4),   # [B,Hkv,G,qc,hd]
                               memory_format=torch.contiguous_format)
        m = torch.full_like(acc[..., 0], -math.inf,
                            memory_format=torch.contiguous_format)
        l = torch.zeros_like(m)
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
    if hkv % ways(q, 2):
        q = unshard_dim(q, 2)          # the mesh does not divide the kv heads
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
    clamped into [0, Smax - S] so that the update fits. A DTensor buffer
    is written rank by rank: ``new`` is laid out as the buffer but whole
    along the sequence, and each rank writes the part of [start, start +
    S) that its shard of the sequence holds (a ``kv_seq``-sharded cache
    takes each new token on one ``model`` rank)."""
    s, smax = new.shape[1], buf.shape[1]
    start = int(start) + (smax if start < 0 else 0)
    start = min(max(start, 0), smax - s)
    if not hasattr(buf, "placements"):
        buf[:, start:start + s] = new.to(buf.dtype)
        return buf
    from torch.distributed.tensor import Replicate
    mesh = buf.device_mesh
    pl = [Replicate() if (p.is_shard() and p.dim == 1) else p
          for p in buf.placements]
    loc = buf.to_local()
    upd = as_dtensor(new.to(buf.dtype), mesh).redistribute(mesh, pl)
    upd = upd.to_local()
    off = 0
    for k, p in enumerate(buf.placements):
        if p.is_shard() and p.dim == 1:
            off = off * mesh.size(k) + mesh.get_local_rank(k)
    off *= loc.shape[1]
    lo, hi = max(start, off), min(start + s, off + loc.shape[1])
    if lo < hi:
        loc[:, lo - off:hi - off] = upd[:, lo - start:hi - start]
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
    q = shard(einsum("bsd,dhe->bshe", xn, params["wq"]),
              "batch", None, "heads", None)
    src = xn if memory is None else memory.to(xn.dtype)
    k = einsum("bsd,dhe->bshe", src, params["wk"])
    v = einsum("bsd,dhe->bshe", src, params["wv"])

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
    out = einsum("bshe,hed->bsd", out, params["wo"])
    return shard(out, "batch", None, "embed"), cache


# -------------------------------------------------------------------- MLP

def mlp_block(params: Dict, x: torch.Tensor, cfg,
              gated: bool = True) -> torch.Tensor:
    """Gated (SwiGLU/GeGLU) or plain two-matrix FFN, pre-norm."""
    xn = rms_norm(x, params["ln"], cfg.norm_eps)
    act = activation(cfg)
    up = einsum("bsd,df->bsf", xn, params["w_up"])
    if gated:
        gate = einsum("bsd,df->bsf", xn, params["w_gate"])
        hidden = act(gate) * up
    else:
        hidden = act(up)
    hidden = shard(hidden, "batch", None, "ff")
    out = einsum("bsf,fd->bsd", hidden, params["w_down"])
    return shard(out, "batch", None, "embed")


# -------------------------------------------------------------------- MoE

def _dense_dispatch(params: Dict, xn: torch.Tensor, combine: torch.Tensor,
                    cfg, act) -> torch.Tensor:
    """Every expert on every token, masked by combine [B, S, E]; the
    combine weights fold into the hidden before the down projection."""
    gate = einsum("bsd,edf->bsef", xn, params["w_gate"])
    up = einsum("bsd,edf->bsef", xn, params["w_up"])
    hidden = shard(act(gate) * up, "batch", None, "experts", None)
    hidden = hidden * combine[..., None]
    return einsum("bsef,efd->bsd", hidden, params["w_down"])


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
    gate = einsum("becd,edf->becf", xg, params["w_gate"])
    up = einsum("becd,edf->becf", xg, params["w_up"])
    hidden = shard(act(gate) * up, "batch", "experts", None, None)
    hidden = hidden * top_w[..., None].to(hidden.dtype)
    part = einsum("becf,efd->becd", hidden, params["w_down"])
    out = torch.zeros((b, s, d), dtype=part.dtype, device=part.device)
    out.index_put_((rows, top_s), part, accumulate=True)
    return shard(out, "batch", None, "embed")


def _capacity_dispatch_ep(params: Dict, xn: torch.Tensor,
                          combine: torch.Tensor, cfg, act,
                          rules, mesh) -> torch.Tensor:
    """Expert parallelism, JAX's ``shard_map`` as a local function: every
    rank runs the capacity dispatch for ITS experts on ITS
    (replicated-over-``model``) rows; the weights arrive FSDP-sharded and
    are all-gathered explicitly; the only other collective is the sum of
    the [B, S, D] partial outputs over ``model``.

    The five inputs are laid out by JAX's ``in_specs`` and handed to the
    local function as their local shards (``to_local``); its output comes
    back as a DTensor that is ``Partial`` over ``model``, and the
    redistribute to JAX's ``out_specs`` is the sum. The all-gathers
    (minor axis first, so the tiles land major to minor;
    ``all_gather_tensor_autograd`` while autograd records) and the sum are
    differentiable, so the train step's backward runs the same path."""
    from torch.distributed._functional_collectives import (
        all_gather_tensor, all_gather_tensor_autograd)
    from torch.distributed.tensor import Partial

    b, s, d = xn.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    cap = max(min(s, int(math.ceil(s * k * cfg.moe_capacity_factor / e))),
              1)
    data_axes = tuple(a for a in axis_names(mesh) if a != "model")
    sizes = axis_sizes(mesh)
    wg, wu, wd = params["w_gate"], params["w_up"], params["w_down"]

    def spec(shape, axes):
        return placements(logical_spec(shape, axes, rules, mesh), mesh)

    # the autograd collective has no kernel outside autograd (inference
    # mode): the plain one there
    gather = (all_gather_tensor_autograd if torch.is_grad_enabled()
              else all_gather_tensor)

    def local_fn(xn_l, comb_l, wg_l, wu_l, wd_l):
        # FSDP gather of this rank's expert weights (w_gate/w_up shard
        # d_model; w_down shards d_model on its output dim)
        for a in reversed(data_axes):
            if sizes[a] == 1:          # a one-rank axis gathers nothing
                continue
            group = mesh.get_group(a)
            wg_l = gather(wg_l, 1, group)
            wu_l = gather(wu_l, 1, group)
            wd_l = gather(wd_l, 2, group)
        bl, sl, dl = xn_l.shape
        w_te = comb_l.transpose(1, 2)                 # [Bl, El, S]
        top_w, top_s = top_k(w_te, cap)               # [Bl, El, C]
        rows = torch.arange(bl, device=xn_l.device)[:, None, None]
        rows = rows.expand_as(top_s)
        xg = xn_l[rows, top_s]                        # [Bl, El, C, D]
        gate = torch.einsum("becd,edf->becf", xg, wg_l)
        up = torch.einsum("becd,edf->becf", xg, wu_l)
        hidden = act(gate) * up
        hidden = hidden * top_w[..., None].to(hidden.dtype)
        part = torch.einsum("becf,efd->becd", hidden, wd_l)
        out = torch.zeros((bl, sl, dl), dtype=part.dtype,
                          device=part.device)
        out.index_put_((rows, top_s), part, accumulate=True)
        return out

    ins = (xn, combine, wg, wu, wd)
    in_specs = (spec(xn.shape, ("batch", None, None)),
                spec(combine.shape, ("batch", None, "experts")),
                spec(wg.shape, ("experts", "fsdp", None)),
                spec(wu.shape, ("experts", "fsdp", None)),
                spec(wd.shape, ("experts", None, "fsdp")))
    out_spec = spec(xn.shape, ("batch", None, None))
    split = [True] * mesh.ndim
    locs = [local_shard(as_dtensor(t, mesh), pl, split)
            for t, pl in zip(ins, in_specs)]
    out = local_fn(*locs)
    names = axis_names(mesh)
    partial = [Partial() if names[i] == "model" else p
               for i, p in enumerate(out_spec)]
    out = from_local_shard(out, mesh, partial, (b, s, out.shape[2]))
    return out.redistribute(mesh, out_spec)


def _expert_parallel(cfg) -> bool:
    """JAX's condition for ``_capacity_dispatch_ep``: capacity dispatch
    under a mesh whose ``model`` axis divides the experts."""
    _, mesh = current_rules()
    return (cfg.moe_dispatch == "capacity" and mesh is not None
            and "model" in axis_names(mesh)
            and cfg.num_experts % axis_sizes(mesh)["model"] == 0)


def _route(logits: torch.Tensor, k: int, e: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Router logits [B, S, E] -> (probs, combine [B, S, E] f32: the
    renormalized top-k probabilities, 0 for unrouted experts)."""
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = top_k(probs, k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    b, s, _ = logits.shape
    combine = torch.zeros((b, s, e), dtype=torch.float32,
                          device=logits.device)
    combine.scatter_(-1, top_i, top_p)
    return probs, combine


def moe_block(params: Dict, x: torch.Tensor, cfg
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k routed mixture of experts; experts sharded over ``model``
    (EP). Dispatch: ``cfg.moe_dispatch`` = "dense" (all experts on all
    tokens) or "capacity" (gather top-C tokens per expert; under a mesh
    whose ``model`` axis divides the experts, the expert-parallel
    ``_capacity_dispatch_ep``). The routing runs on each rank's rows
    (``batch_local``). Returns (out, aux_loss)."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    xn = rms_norm(x, params["ln"], cfg.norm_eps)
    logits = einsum("bsd,de->bse", xn.float(), params["router"].float())
    probs, combine = batch_local(_route, logits, k, e, batch=(0, None, None))
    combine = shard(combine.to(x.dtype), "batch", None, "experts")

    act = activation(cfg)
    if _expert_parallel(cfg):
        rules, mesh = current_rules()
        out = _capacity_dispatch_ep(params, xn, combine, cfg, act, rules,
                                    mesh)
    elif cfg.moe_dispatch == "capacity":
        out = _capacity_dispatch(params, xn, combine, cfg, act)
    else:
        out = _dense_dispatch(params, xn, combine, cfg, act)

    if cfg.num_shared_experts:
        sh_gate = einsum("bsd,df->bsf", xn, params["shared_w_gate"])
        sh_up = einsum("bsd,df->bsf", xn, params["shared_w_up"])
        out = out + einsum("bsf,fd->bsd", act(sh_gate) * sh_up,
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
