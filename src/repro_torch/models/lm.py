"""Model assembly (port of ``repro.models.lm``): parameter specs/init,
forward + loss, prefill and decode for every architecture family.

Layers are stacked as in JAX (one tensor a parameter with a leading
``layers`` axis), and each ``lax.scan`` over them becomes a loop that
indexes the stacked tensors. Decode threads per-layer KV caches / SSM
states through the same loops.

Param trees are nested dicts of ``layers.P`` specs; ``init_params``
materializes them on a device from an explicit ``torch.Generator``.
``params_from_jax`` carries a JAX parameter tree (or cache) across as
numpy, so the two packages can be held equal on the same weights.

With ``cfg.remat`` each layer body that JAX wraps in ``_maybe_remat``
(the decoder, RWKV, Mamba2, encoder and encoder-decoder layers; the
hybrid's shared attention block is not) runs under ``layers.remat`` when
no cache is passed, and ``_chunked_ce`` rematerializes each of its
chunks, as JAX's ``jax.checkpoint`` sites do.

Under ``use_rules`` on a ``DeviceMesh`` the parameters and token rows
are DTensors: the embedding is a vocab-parallel lookup (``_lookup``), the
CE gathers the vocab before its logsumexp, and ``prefill`` lays the cache
out as ``launch.specs.cache_specs`` describes it.

Differences from JAX that change no result: ``cache["len"]`` is a host
int, not a 0-d device array (a device scalar would cost a host sync in
every layer); ``init_cache`` allocates every buffer on its own (JAX binds
one zeros array to K and V, and broadcasts the SSM states); KV buffers are
written in place (see ``layers``); remat applies only while autograd
records (``layers.remat``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed.sharding import (as_dtensor, einsum,
                                              from_local_shard, local_shard,
                                              shard, tree_map, unshard_dim)
from repro_torch.models import ssm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (P, attention_block, dense_layer,
                                       mlp_block, remat, rms_norm)

Tree = Dict[str, Any]


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _is_p(x) -> bool:
    return isinstance(x, P)


# =====================================================================
# Parameter specs
# =====================================================================

def _attn_specs(cfg: ModelConfig) -> Tree:
    d, h, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    s = {"ln": P((d,), (None,), init="zeros"),
         "wq": P((d, h, hd), ("fsdp", "heads", None), scale=d ** -0.5),
         "wk": P((d, hkv, hd), ("fsdp", "kv_heads", None), scale=d ** -0.5),
         "wv": P((d, hkv, hd), ("fsdp", "kv_heads", None), scale=d ** -0.5),
         "wo": P((h, hd, d), ("heads", None, "fsdp"),
                 scale=(h * hd) ** -0.5)}
    if cfg.qk_norm:
        s["q_norm"] = P((hd,), (None,), init="zeros")
        s["k_norm"] = P((hd,), (None,), init="zeros")
    return s


def _mlp_specs(cfg: ModelConfig, gated: bool = True) -> Tree:
    d, f = cfg.d_model, cfg.d_ff
    s = {"ln": P((d,), (None,), init="zeros"),
         "w_up": P((d, f), ("fsdp", "ff"), scale=d ** -0.5),
         "w_down": P((f, d), ("ff", "fsdp"), scale=f ** -0.5)}
    if gated:
        s["w_gate"] = P((d, f), ("fsdp", "ff"), scale=d ** -0.5)
    return s


def _moe_specs(cfg: ModelConfig) -> Tree:
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    s = {"ln": P((d,), (None,), init="zeros"),
         "router": P((d, e), (None, "experts"), scale=d ** -0.5),
         "w_gate": P((e, d, f), ("experts", "fsdp", None), scale=d ** -0.5),
         "w_up": P((e, d, f), ("experts", "fsdp", None), scale=d ** -0.5),
         "w_down": P((e, f, d), ("experts", None, "fsdp"),
                     scale=f ** -0.5)}
    if cfg.num_shared_experts:
        fs = f * cfg.num_shared_experts
        s["shared_w_gate"] = P((d, fs), ("fsdp", "ff"), scale=d ** -0.5)
        s["shared_w_up"] = P((d, fs), ("fsdp", "ff"), scale=d ** -0.5)
        s["shared_w_down"] = P((fs, d), ("ff", "fsdp"), scale=fs ** -0.5)
    return s


def _mamba_specs(cfg: ModelConfig) -> Tree:
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    proj = 2 * di + 2 * n + h
    conv_c = di + 2 * n
    return {"ln": P((d,), (None,), init="zeros"),
            "in_proj": P((d, proj), ("fsdp", "inner"), scale=d ** -0.5),
            "conv_w": P((cfg.ssm_conv, conv_c), (None, "inner"),
                        scale=cfg.ssm_conv ** -0.5),
            "dt_bias": P((h,), (None,), init="ones", scale=0.01),
            "a_log": P((h,), (None,), init="ones", scale=0.5),
            "d_skip": P((h,), (None,), init="ones"),
            "gate_ln": P((di,), (None,), init="zeros"),
            "out_proj": P((di, d), ("inner", "fsdp"), scale=di ** -0.5)}


def _rwkv_specs(cfg: ModelConfig) -> Tree:
    d, f = cfg.d_model, cfg.d_ff
    lo, dl = cfg.rwkv_lora, cfg.rwkv_decay_lora
    tm = {"ln": P((d,), (None,), init="zeros"),
          "mu_base": P((d,), (None,), scale=0.5),
          "mu": P((5, d), (None, None), scale=0.5),
          "mix_wa": P((d, 5, lo), (None, None, None), scale=d ** -0.5),
          "mix_wb": P((5, lo, d), (None, None, None), scale=lo ** -0.5),
          "decay_wa": P((d, dl), (None, None), scale=d ** -0.5),
          "decay_wb": P((dl, d), (None, None), scale=dl ** -0.5),
          "w0": P((d,), (None,), init="ones", scale=0.5),
          "u": P((d,), (None,), scale=0.5),
          "wr": P((d, d), ("fsdp", "inner"), scale=d ** -0.5),
          "wk": P((d, d), ("fsdp", "inner"), scale=d ** -0.5),
          "wv": P((d, d), ("fsdp", "inner"), scale=d ** -0.5),
          "wg": P((d, d), ("fsdp", "inner"), scale=d ** -0.5),
          "gn_g": P((d,), (None,), init="zeros"),
          "gn_b": P((d,), (None,), init="zeros"),
          "wo": P((d, d), ("inner", "fsdp"), scale=d ** -0.5)}
    cm = {"ln": P((d,), (None,), init="zeros"),
          "mu_k": P((d,), (None,), scale=0.5),
          "mu_r": P((d,), (None,), scale=0.5),
          "wk": P((d, f), ("fsdp", "ff"), scale=d ** -0.5),
          "wv": P((f, d), ("ff", "fsdp"), scale=f ** -0.5),
          "wr": P((d, d), ("fsdp", "inner"), scale=d ** -0.5)}
    return {"tm": tm, "cm": cm}


def _stack(tree: Tree, n: int) -> Tree:
    """Prepend a stacked ``layers`` axis of length n to every spec."""
    def one(p: P) -> P:
        return P((n,) + p.shape, (None,) + p.axes, init=p.init,
                 scale=p.scale, dtype=p.dtype)
    return tree_map(one, tree, is_leaf=_is_p)


def param_specs(cfg: ModelConfig) -> Tree:
    d, v = cfg.d_model, cfg.padded_vocab
    specs: Tree = {
        "embed": P((v, d), ("vocab", "fsdp"), scale=0.02),
        "final_ln": P((d,), (None,), init="zeros"),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = P((d, v), ("fsdp", "vocab"), scale=d ** -0.5)

    if cfg.family in ("dense", "vlm"):
        layer = {"attn": _attn_specs(cfg), "mlp": _mlp_specs(cfg)}
        specs["layers"] = _stack(layer, cfg.num_layers)
    elif cfg.family == "moe":
        layer = {"attn": _attn_specs(cfg), "moe": _moe_specs(cfg)}
        specs["layers"] = _stack(layer, cfg.num_layers)
    elif cfg.family == "ssm":
        specs["layers"] = _stack(_rwkv_specs(cfg), cfg.num_layers)
    elif cfg.family == "hybrid":
        g, tail = _hybrid_groups(cfg)
        specs["groups"] = _stack(_stack(_mamba_specs(cfg),
                                        cfg.shared_attn_period), g)
        if tail:
            specs["tail"] = _stack(_mamba_specs(cfg), tail)
        specs["shared_attn"] = {"attn": _attn_specs(cfg),
                                "mlp": _mlp_specs(cfg)}
    elif cfg.family == "audio":
        enc = {"attn": _attn_specs(cfg), "mlp": _mlp_specs(cfg, gated=False)}
        dec = {"attn": _attn_specs(cfg), "cross": _attn_specs(cfg),
               "mlp": _mlp_specs(cfg, gated=False)}
        specs["enc_layers"] = _stack(enc, cfg.encoder_layers)
        specs["enc_final_ln"] = P((d,), (None,), init="zeros")
        specs["layers"] = _stack(dec, cfg.num_layers)
    if cfg.family == "vlm":
        specs["patch_proj"] = P((d, d), ("fsdp", None), scale=d ** -0.5)
    return specs


def _hybrid_groups(cfg: ModelConfig) -> Tuple[int, int]:
    """(num_groups, tail_layers): groups of ``shared_attn_period`` mamba
    layers each followed by the shared attention block; remainder = tail."""
    g = cfg.num_layers // cfg.shared_attn_period
    return g, cfg.num_layers - g * cfg.shared_attn_period


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> Tree:
    """Materialize parameters on ``device``: normal leaves draw from
    ``generator`` (on its own device, in the specs' sorted-key order), so
    the values are seeded but are not JAX's."""
    dtype = _dtype(cfg.param_dtype)

    def one(p: P) -> torch.Tensor:
        if p.init == "zeros":
            return torch.zeros(p.shape, dtype=dtype, device=device)
        if p.init == "ones":
            return torch.full(p.shape, p.scale, dtype=dtype, device=device)
        w = torch.randn(p.shape, generator=generator, dtype=dtype,
                        device=generator.device)
        return w.mul_(p.scale).to(device)     # in place: no second copy

    return tree_map(one, param_specs(cfg), is_leaf=_is_p)


def params_from_jax(tree, device="cuda"):
    """A tree of numpy arrays (``jax.tree.map(np.asarray, params)``, or a
    JAX cache) -> the same tree of tensors on ``device``; bf16 keeps its
    bits, and a cache's ``len`` becomes a host int."""
    def one(a):
        a = np.array(a, order="C")          # a writable copy
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.int16)).view(
                torch.bfloat16).to(device)
        return torch.from_numpy(a).to(device)

    def walk(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: (int(np.asarray(v)) if k == "len" else walk(v))
                    for k, v in t.items()}
        return one(t)
    return walk(tree)


# =====================================================================
# Forward (training / prefill / decode share the layer bodies)
# =====================================================================

def _cast_params(cfg: ModelConfig, params: Tree) -> Tree:
    """Master weights are fp32; compute runs in cfg.dtype. Norm scales and
    SSM decay/dt parameters are explicitly upcast at their use sites.
    Leaves already in another dtype are returned as they are."""
    dt = _dtype(cfg.dtype)
    return tree_map(lambda p: p.to(dt) if p.dtype == torch.float32 else p,
                    params)


def _layer(tree: Tree, i: int) -> Tree:
    """Layer ``i`` of a stacked tree (views)."""
    return tree_map(lambda t: t[i], tree)


def _unstack(tree: Tree) -> list:
    """Every layer of a stacked parameter tree, as trees of ``unbind``
    views: their backward stacks the layers' gradients in one op a leaf,
    where a view per index would fill a zeroed copy of the whole stack
    for each layer."""
    leaves = []
    tree_map(leaves.append, tree)
    per = tree_map(lambda t: t.unbind(0), tree)
    return [tree_map(lambda views: views[i], per,
                     is_leaf=lambda x: isinstance(x, tuple))
            for i in range(leaves[0].shape[0])]


def _stack_trees(trees) -> Optional[Tree]:
    """A list of equal-shaped trees -> one tree of stacked leaves."""
    if trees[0] is None:
        return None
    if isinstance(trees[0], dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``. On a DTensor table (vocab rows sharded over
    ``model``, the FSDP columns gathered) each rank looks up the ids its
    vocab shard holds and zeros for the rest, a sum pending over the mesh
    dims that shard the vocab (Megatron's vocab-parallel embedding);
    exactly one rank adds a row, so the sum is the row."""
    if not hasattr(table, "placements"):
        return table[tokens]
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = table.device_mesh
    tok = as_dtensor(tokens, mesh)
    vocab = [p.is_shard() and p.dim == 0 for p in table.placements]
    rows = [p.is_shard() and p.dim == 0 and not v
            for p, v in zip(tok.placements, vocab)]
    t_l = local_shard(table, [Shard(0) if v else Replicate() for v in vocab],
                      rows)
    k_l = local_shard(tok, [Shard(0) if r else Replicate() for r in rows],
                      rows)
    off = 0
    for k, v in enumerate(vocab):
        if v:
            off = off * mesh.size(k) + mesh.get_local_rank(k)
    off *= t_l.shape[0]
    idx = k_l.long() - off
    hit = (idx >= 0) & (idx < t_l.shape[0])
    got = t_l[idx.clamp(0, t_l.shape[0] - 1)]
    got = torch.where(hit[..., None], got, torch.zeros_like(got))
    pl = [Partial() if v else Shard(0) if r else Replicate()
          for v, r in zip(vocab, rows)]
    return from_local_shard(got, mesh, pl,
                            tuple(tokens.shape) + (table.shape[1],))


def _embed(cfg: ModelConfig, params: Tree, tokens: torch.Tensor
           ) -> torch.Tensor:
    x = _lookup(params["embed"].to(_dtype(cfg.dtype)), tokens)
    if cfg.scale_embed:
        # sqrt(D) rounded to the compute dtype first, as JAX's asarray
        x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=x.dtype).item()
    return shard(x, "batch", None, "embed")


def _vocab_mask(cfg: ModelConfig, logits: torch.Tensor) -> torch.Tensor:
    """Neutralize padded vocab columns (they carry random init rows)."""
    if cfg.padded_vocab == cfg.vocab_size:
        return logits
    cols = torch.arange(logits.shape[-1], device=logits.device)
    return logits.masked_fill(cols >= cfg.vocab_size, -1e30)


def _unembed_weight(cfg: ModelConfig, params: Tree, dtype) -> torch.Tensor:
    w = (params["embed"].T if cfg.tie_embeddings else params["lm_head"])
    return w.to(dtype)


def _softcap(cfg: ModelConfig, logits: torch.Tensor) -> torch.Tensor:
    if cfg.logit_softcap > 0:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits


def _unembed(cfg: ModelConfig, params: Tree, x: torch.Tensor
             ) -> torch.Tensor:
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    logits = _softcap(cfg, einsum("bsd,dv->bsv", x,
                                  _unembed_weight(cfg, params, x.dtype)))
    return shard(_vocab_mask(cfg, logits), "batch", None, "vocab")


def _maybe_remat(fn, cfg: ModelConfig):
    return remat(fn, cfg.remat)


def _no_aux(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _transformer_trunk(cfg: ModelConfig, params: Tree, x: torch.Tensor,
                       positions: torch.Tensor,
                       cache: Optional[Tree] = None
                       ) -> Tuple[torch.Tensor, Optional[Tree],
                                  torch.Tensor]:
    """Dense/moe/vlm decoder layers. cache: {"k": [L,B,S,Hkv,hd],
    "v": ..., "len": int} or None."""
    aux = _no_aux(x)
    layer = _maybe_remat(dense_layer, cfg) if cache is None else dense_layer
    layers = _unstack(params["layers"])
    for i, w in enumerate(cfg.layer_windows()):
        lc = (None if cache is None else
              {"k": cache["k"][i], "v": cache["v"][i], "len": cache["len"]})
        x, _, a = layer(layers[i], x, positions, cfg, w, cache=lc)
        aux = aux + a
    if cache is None:
        return x, None, aux
    new_cache = {"k": cache["k"], "v": cache["v"],
                 "len": cache["len"] + x.shape[1]}
    return x, new_cache, aux


def _rwkv_trunk(cfg, params, x, cache):
    layer = (_maybe_remat(ssm.rwkv_layer, cfg) if cache is None
             else ssm.rwkv_layer)
    states = []
    for i, lp in enumerate(_unstack(params["layers"])):
        x, ns = layer(lp, x, cfg, None if cache is None else _layer(cache, i))
        states.append(ns)
    return x, (None if cache is None else _stack_trees(states)), _no_aux(x)


def _mamba_residual(lp, h, cfg, st):
    h2, ns = ssm.mamba_mix(lp, h, cfg, st)
    return h + h2, ns


def _mamba_stack(cfg, h, lp_stack, st_stack):
    """The mamba layers of one stacked tree (residual around each)."""
    layer = (_maybe_remat(_mamba_residual, cfg) if st_stack is None
             else _mamba_residual)
    states = []
    for i, lp in enumerate(_unstack(lp_stack)):
        h, ns = layer(lp, h, cfg,
                      None if st_stack is None else _layer(st_stack, i))
        states.append(ns)
    return h, (None if st_stack is None else _stack_trees(states))


def _hybrid_trunk(cfg, params, x, positions, cache):
    """Zamba2: groups of mamba layers, the shared attn block after each.

    cache: {"mamba_g": [G, period, ...] states, "mamba_t": [T, ...],
            "attn_k"/"attn_v": [G, B, S, Hkv, hd], "len": int}."""
    g, tail = _hybrid_groups(cfg)
    shared = params["shared_attn"]
    group_states = []
    groups = _unstack(params["groups"]) if g else []
    for gi in range(g):
        st = None if cache is None else _layer(cache["mamba_g"], gi)
        x, ns = _mamba_stack(cfg, x, groups[gi], st)
        group_states.append(ns)
        lc = (None if cache is None else
              {"k": cache["attn_k"][gi], "v": cache["attn_v"][gi],
               "len": cache["len"]})
        a, _ = attention_block(shared["attn"], x, positions, cfg, 0,
                               cache=lc)
        x = x + a
        x = x + mlp_block(shared["mlp"], x, cfg)
    n_mt = None
    if tail:
        x, n_mt = _mamba_stack(cfg, x, params["tail"],
                               None if cache is None else cache["mamba_t"])
    if cache is None:
        return x, None, _no_aux(x)
    new_cache = {"mamba_g": _stack_trees(group_states) if g else
                 cache["mamba_g"], "mamba_t": n_mt,
                 "attn_k": cache["attn_k"], "attn_v": cache["attn_v"],
                 "len": cache["len"] + x.shape[1]}
    return x, new_cache, _no_aux(x)


def _encoder_layer(lp, h, pos, cfg):
    a, _ = attention_block(lp["attn"], h, pos, cfg, 0, causal=False)
    h = h + a
    return h + mlp_block(lp["mlp"], h, cfg, gated=False)


def _encoder(cfg, params, frames):
    """Whisper encoder over stub frame embeddings [B, T, D] (bidir attn)."""
    pos = torch.arange(frames.shape[1], device=frames.device)
    x = shard(frames.to(_dtype(cfg.dtype)), "batch", None, "embed")
    layer = _maybe_remat(_encoder_layer, cfg)
    for lp in _unstack(params["enc_layers"]):
        x = layer(lp, x, pos, cfg)
    return rms_norm(x, params["enc_final_ln"], cfg.norm_eps)


def _decoder_layer(lp, h, positions, memory, cfg, lc):
    """Self-attn (cached) + cross-attn + plain MLP; (h, the layer cache)."""
    a, lc = attention_block(lp["attn"], h, positions, cfg, 0, cache=lc)
    h = h + a
    c, _ = attention_block(lp["cross"], h, positions, cfg, 0, memory=memory)
    h = h + c
    return h + mlp_block(lp["mlp"], h, cfg, gated=False), lc


def _encdec_trunk(cfg, params, x, positions, memory, cache):
    """Whisper decoder: self-attn (cached) + cross-attn + plain MLP."""
    layer = (_maybe_remat(_decoder_layer, cfg) if cache is None
             else _decoder_layer)
    for i, lp in enumerate(_unstack(params["layers"])):
        lc = (None if cache is None else
              {"k": cache["k"][i], "v": cache["v"][i], "len": cache["len"]})
        x, _ = layer(lp, x, positions, memory, cfg, lc)
    if cache is None:
        return x, None, _no_aux(x)
    new_cache = {"k": cache["k"], "v": cache["v"],
                 "len": cache["len"] + x.shape[1],
                 "memory": cache["memory"]}
    return x, new_cache, _no_aux(x)


def _forward_hidden(cfg: ModelConfig, params: Tree, tokens: torch.Tensor,
                    patch_embeds: Optional[torch.Tensor] = None,
                    frames: Optional[torch.Tensor] = None,
                    cache: Optional[Tree] = None,
                    positions: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Optional[Tree], torch.Tensor]:
    """Trunk output before final norm/unembed (VLM patch rows dropped)."""
    params = _cast_params(cfg, params)
    x = _embed(cfg, params, tokens)
    if cfg.family == "vlm" and patch_embeds is not None:
        pe = einsum("bpd,de->bpe", patch_embeds.to(x.dtype),
                    params["patch_proj"])
        x = torch.cat([shard(pe, "batch", None, "embed"), x], dim=1)
    if positions is None:
        start = cache.get("len", 0) if cache is not None else 0
        positions = start + torch.arange(x.shape[1], device=x.device)

    if cfg.family in ("dense", "moe", "vlm"):
        x, cache, aux = _transformer_trunk(cfg, params, x, positions, cache)
    elif cfg.family == "ssm":
        x, cache, aux = _rwkv_trunk(cfg, params, x, cache)
    elif cfg.family == "hybrid":
        x, cache, aux = _hybrid_trunk(cfg, params, x, positions, cache)
    elif cfg.family == "audio":
        memory = (cache["memory"] if cache is not None
                  else _encoder(cfg, params, frames))
        x, cache, aux = _encdec_trunk(cfg, params, x, positions, memory,
                                      cache)
    else:
        raise ValueError(cfg.family)

    if cfg.family == "vlm" and patch_embeds is not None:
        x = x[:, patch_embeds.shape[1]:]
    return x, cache, aux


def forward(cfg: ModelConfig, params: Tree, tokens: torch.Tensor,
            patch_embeds: Optional[torch.Tensor] = None,
            frames: Optional[torch.Tensor] = None,
            cache: Optional[Tree] = None,
            positions: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Optional[Tree], torch.Tensor]:
    """Token logits for any family. Returns (logits, cache', aux_loss)."""
    x, cache, aux = _forward_hidden(cfg, params, tokens,
                                    patch_embeds=patch_embeds,
                                    frames=frames, cache=cache,
                                    positions=positions)
    return _unembed(cfg, params, x), cache, aux


def _ce_chunks(seq_len: int, vocab: int) -> int:
    """Sequence-chunked CE: keep live logits ~<= 2^24 elements per call."""
    if vocab < 16384:
        return 1
    target = max(1, (seq_len * vocab) // (1 << 24))
    nc = 1
    while nc < target and seq_len % (nc * 2) == 0:
        nc *= 2
    return nc


def _chunked_ce(cfg: ModelConfig, params: Tree, x: torch.Tensor,
                labels: torch.Tensor) -> torch.Tensor:
    """Next-token CE without materializing full [B, S, V] logits: the
    unembed + logsumexp run per sequence chunk under remat, so the live
    working set is [B, S/nc, V]. Labels < 0 are masked."""
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    w = _unembed_weight(cfg, params, x.dtype)
    s = x.shape[1]
    nc = _ce_chunks(s, w.shape[1])

    def chunk_ce(xc, lc):
        logits = _vocab_mask(cfg, _softcap(cfg, einsum("bsd,dv->bsv",
                                                        xc, w)))
        # the logsumexp and the gold logit read whole rows: on a mesh the
        # vocab shards are gathered first
        logits = unshard_dim(shard(logits, "batch", None, "vocab").float(),
                             -1)
        logz = torch.logsumexp(logits, dim=-1)
        idx = lc.clamp(min=0).long()[..., None]
        gold = torch.take_along_dim(logits, idx, dim=-1)[..., 0]
        mask = (lc >= 0).float()
        return torch.sum((logz - gold) * mask), torch.sum(mask)

    if nc == 1:
        tot, cnt = chunk_ce(x, labels)
    else:
        ce = remat(chunk_ce)
        tot = torch.zeros((), dtype=torch.float32, device=x.device)
        cnt = torch.zeros((), dtype=torch.float32, device=x.device)
        for xc, lc in zip(x.chunk(nc, dim=1), labels.chunk(nc, dim=1)):
            tot = tot + ce(xc, lc)[0]
            cnt = cnt + (lc >= 0).sum().float()
    return tot / torch.clamp(cnt, min=1.0)


def loss_fn(cfg: ModelConfig, params: Tree, batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token cross-entropy (+ MoE aux)."""
    x, _, aux = _forward_hidden(
        cfg, params, batch["tokens"],
        patch_embeds=batch.get("patch_embeds"),
        frames=batch.get("frames"))
    ce = _chunked_ce(cfg, params, x, batch["labels"])
    loss = ce + cfg.router_aux_coef * aux
    return loss, {"ce": ce, "aux": aux}


# =====================================================================
# Serving: cache init / prefill / decode
# =====================================================================

def _zeros_like_stacked(state: Tree, lead: Tuple[int, ...]) -> Tree:
    """Fresh zeros of ``lead + shape`` for every leaf of ``state``."""
    return tree_map(lambda t: t.new_zeros(lead + tuple(t.shape)), state)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> Tree:
    """Zeroed KV buffers / SSM states, each allocated on its own (an
    in-place write to one must not reach another); ``len`` a host int."""
    def kv(n):
        return torch.zeros((n, batch, max_len, cfg.num_kv_heads, cfg.hd),
                           dtype=dtype, device=device)

    if cfg.family in ("dense", "moe", "vlm"):
        return {"k": kv(cfg.num_layers), "v": kv(cfg.num_layers), "len": 0}
    if cfg.family == "ssm":
        st = ssm.init_rwkv_state(cfg, batch, dtype, device)
        return _zeros_like_stacked(st, (cfg.num_layers,))
    if cfg.family == "hybrid":
        g, tail = _hybrid_groups(cfg)
        mst = ssm.init_mamba_state(cfg, batch, dtype, device)
        return {"mamba_g": _zeros_like_stacked(
                    mst, (g, cfg.shared_attn_period)),
                "mamba_t": (_zeros_like_stacked(mst, (tail,)) if tail
                            else None),
                "attn_k": kv(g), "attn_v": kv(g), "len": 0}
    if cfg.family == "audio":
        mem = torch.zeros((batch, cfg.num_mem_tokens, cfg.d_model),
                          dtype=dtype, device=device)
        return {"k": kv(cfg.num_layers), "v": kv(cfg.num_layers), "len": 0,
                "memory": mem}
    raise ValueError(cfg.family)


def prefill(cfg: ModelConfig, params: Tree, tokens: torch.Tensor,
            max_len: int, patch_embeds=None, frames=None,
            cache_dtype=torch.bfloat16) -> Tuple[torch.Tensor, Tree]:
    cache = init_cache(cfg, tokens.shape[0], max_len, cache_dtype,
                       device=tokens.device)
    if hasattr(tokens, "placements"):
        # on a mesh the cache is laid out as ``launch.specs.cache_specs``
        # describes it
        from repro_torch.launch.specs import shard_cache
        cache = shard_cache(cfg, cache, tokens.shape[0])
    if cfg.family == "audio":
        cache["memory"] = _encoder(cfg, _cast_params(cfg, params),
                                   frames).to(cache_dtype)
    logits, cache, _ = forward(cfg, params, tokens,
                               patch_embeds=patch_embeds, cache=cache)
    return logits, cache


def decode_step(cfg: ModelConfig, params: Tree, cache: Tree,
                tokens: torch.Tensor) -> Tuple[torch.Tensor, Tree]:
    """One decode step: tokens [B, 1] -> (logits [B, 1, V], cache')."""
    logits, cache, _ = forward(cfg, params, tokens, cache=cache)
    return logits, cache
