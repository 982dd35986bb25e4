"""AOT input specs (port of ``repro.launch.specs``): ``ArgSpec`` stand-ins
(shape, dtype, spec, DTensor placements, per-rank shape) for every model
input, sharded by the logical rules, with no allocation.

``step_specs(cfg, shape, mesh)`` returns (kind, args-of-ArgSpec) for the
function the dry run runs:
  train_*    -> train_step(params, opt_state, batch)
  prefill_*  -> prefill_fn(params, batch)
  decode_*   -> serve_step(params, cache, tokens)

The counterpart of JAX's sharded ``ShapeDtypeStruct`` is
``distributed.sharding.ArgSpec``; a mesh is a ``DeviceMesh`` or anything
with a ``shape`` dict and ``axis_names`` (JAX's ``AbstractMesh`` plays
that part in JAX). The cache's shapes come from the port's own
``lm.init_cache`` on the ``meta`` device (JAX: ``jax.eval_shape``).
The port's ``cache["len"]`` is a host int; its spec is the ``()`` int32
that JAX's 0-d array has, so the argument bytes agree.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.shapes import Shape
from repro_torch.distributed.sharding import (AxisRules, PartitionSpec,
                                              arg_spec, axis_sizes,
                                              logical_spec,
                                              spec_tree_to_shape_dtype,
                                              tree_map)
from repro_torch.launch.mesh import rules_for
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig

Tree = Any


def _sds(shape, dtype, mesh, rules, axes):
    return arg_spec(shape, dtype, logical_spec(shape, axes, rules, mesh),
                    mesh)


def params_specs(cfg: ModelConfig, mesh,
                 rules: Optional[AxisRules] = None) -> Tree:
    rules = rules or rules_for(mesh)
    return spec_tree_to_shape_dtype(lm.param_specs(cfg), rules, mesh)


def opt_specs(cfg: ModelConfig, mesh,
              rules: Optional[AxisRules] = None) -> Tree:
    """AdamW m/v mirror the parameter sharding; fp32. ``step`` is a
    replicated int32 scalar."""
    rules = rules or rules_for(mesh)
    p = spec_tree_to_shape_dtype(lm.param_specs(cfg), rules, mesh,
                                 dtype=torch.float32)
    step = arg_spec((), torch.int32, PartitionSpec(), mesh)
    return {"m": p, "v": tree_map(lambda x: x, p), "step": step}


def batch_specs(cfg: ModelConfig, shape: Shape, mesh,
                rules: Optional[AxisRules] = None) -> Dict[str, Any]:
    rules = rules or rules_for(mesh)
    b, s = shape.global_batch, shape.seq_len
    out: Dict[str, Any] = {}
    tok_len = s
    if cfg.family == "vlm":
        tok_len = s - cfg.patch_tokens
        out["patch_embeds"] = _sds((b, cfg.patch_tokens, cfg.d_model),
                                   torch.bfloat16, mesh, rules,
                                   ("batch", None, None))
    if cfg.family == "audio":
        out["frames"] = _sds((b, cfg.num_mem_tokens, cfg.d_model),
                             torch.bfloat16, mesh, rules,
                             ("batch", None, None))
    out["tokens"] = _sds((b, tok_len), torch.int32, mesh, rules,
                         ("batch", None))
    out["labels"] = _sds((b, tok_len), torch.int32, mesh, rules,
                         ("batch", None))
    return out


def _cache_axes(cfg: ModelConfig, path: Tuple[str, ...], ndim: int,
                mesh) -> Tuple[Optional[str], ...]:
    """Logical axes for a cache leaf (leading dim = stacked layers).

    KV tensors [L, B, S, Hkv, hd]: shard heads over model when divisible,
    else shard the cache sequence axis (decode sequence-parallelism for
    MQA archs). SSM states: none here (``cache_axes`` gives their batch
    dim the ``batch`` axis).
    """
    name = path[-1] if path else ""
    model_size = axis_sizes(mesh)["model"]
    if name in ("k", "v", "attn_k", "attn_v"):
        if cfg.num_kv_heads % model_size == 0:
            return (None, "batch", None, "kv_heads", None)
        return (None, "batch", "kv_seq", "kv_heads", None)
    if name == "memory":
        return ("batch", None, None)
    if name == "len":
        return ()
    return (None,) * ndim


def cache_axes(cfg: ModelConfig, path: Tuple[str, ...],
               shape: Tuple[int, ...], batch: int,
               mesh) -> Tuple[Optional[str], ...]:
    """``_cache_axes``, then JAX's default for SSM state leaves: the dim
    whose size == batch gets the ``batch`` axis."""
    axes = list(_cache_axes(cfg, path, len(shape), mesh))
    if all(a is None for a in axes):
        for i, d in enumerate(shape):
            if d == batch:
                axes[i] = "batch"
                break
    return tuple(axes)


def _walk(tree, fn, path=()):
    """Map ``fn(path, leaf)`` over a cache tree (dicts; None stays)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _walk(v, fn, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def shard_cache(cfg: ModelConfig, cache: Tree, batch: int) -> Tree:
    """Lay a cache's tensors out as ``cache_specs`` describes them, on the
    current rules and mesh (``len`` stays a host int)."""
    from repro_torch.distributed.sharding import current_rules, shard
    _, mesh = current_rules()

    def one(path, leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        return shard(leaf, *cache_axes(cfg, path, tuple(leaf.shape), batch,
                                       mesh))
    return _walk(cache, one)


def cache_specs(cfg: ModelConfig, shape: Shape, mesh,
                rules: Optional[AxisRules] = None,
                cache_dtype=torch.bfloat16) -> Tree:
    """ArgSpecs for the decode cache (shapes from ``lm.init_cache`` on the
    ``meta`` device)."""
    rules = rules or rules_for(mesh)
    b = shape.global_batch
    shapes = lm.init_cache(cfg, b, shape.seq_len, cache_dtype,
                           device="meta")

    def annotate(path, leaf):
        if not isinstance(leaf, torch.Tensor):        # len: 0-d int32
            return _sds((), torch.int32, mesh, rules, ())
        return _sds(tuple(leaf.shape), leaf.dtype, mesh, rules,
                    cache_axes(cfg, path, tuple(leaf.shape), b, mesh))
    return _walk(shapes, annotate)


def step_specs(cfg: ModelConfig, shape: Shape, mesh) -> Tuple[str, Tuple]:
    """(kind, args-of-ArgSpec) for the function the dry run runs."""
    rules = rules_for(mesh)
    p = params_specs(cfg, mesh, rules)
    if shape.kind == "train":
        return "train", (p, opt_specs(cfg, mesh, rules),
                         batch_specs(cfg, shape, mesh, rules))
    if shape.kind == "prefill":
        bs = batch_specs(cfg, shape, mesh, rules)
        bs.pop("labels")
        return "prefill", (p, bs)
    if shape.kind == "decode":
        tok = _sds((shape.global_batch, 1), torch.int32, mesh, rules,
                   ("batch", None))
        return "decode", (p, cache_specs(cfg, shape, mesh, rules), tok)
    raise ValueError(shape.kind)
