"""Gradient compression: int8 quantized all-reduce with error feedback
(port of ``repro.distributed.compress``).

Per-leaf symmetric int8 quantization (per-tensor scale = max|g|/127);
the residual (g - dequant(q)) is carried in an error-feedback buffer and
added to the next step's gradient, making the compressed SGD unbiased in
the long run (Karimireddy et al., 2019). It cuts the gradient
all-reduce's bytes 4x (f32) / 2x (bf16).

``compressed_psum`` is the collective path: the scale is an
``all_reduce(MAX)`` and the int8 payload an ``all_reduce(SUM)`` over the
process group of one mesh axis. The f32 operations run in JAX's order
(``torch.round`` rounds half to even, as ``jnp.round`` does), so the
outputs equal JAX's bit for bit. Trees are dicts, lists and tuples.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import current_rules, tree_map

Tree = Any

_FLOOR = 1e-12


def _floor(scale: torch.Tensor) -> torch.Tensor:
    return torch.maximum(scale, torch.tensor(_FLOOR, dtype=torch.float32,
                                             device=scale.device))


def quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = _floor(g.abs().max().to(torch.float32) / 127.0)
    q = torch.clamp(torch.round(g.to(torch.float32) / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def ef_init(params: Tree) -> Tree:
    return tree_map(lambda p: torch.zeros(tuple(p.shape), dtype=torch.float32,
                                          device=p.device), params)


def _leaves(tree: Tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def _unflatten(tree: Tree, values: list) -> Tree:
    it = iter(values)
    return tree_map(lambda _: next(it), tree)


def compress_with_feedback(grads: Tree, errors: Tree
                           ) -> Tuple[Tree, Tree, Tree]:
    """Returns (int8 tree, scales tree, new error tree)."""
    out = []
    for g, e in zip(_leaves(grads), _leaves(errors)):
        corrected = g.to(torch.float32) + e
        q, s = quantize(corrected)
        out.append((q, s, corrected - dequantize(q, s)))
    return tuple(_unflatten(grads, [o[i] for o in out]) for i in range(3))


def compressed_psum(grads: Tree, errors: Tree, axis_name: str,
                    mesh=None) -> Tuple[Tree, Tree]:
    """All-reduce int8 gradients across the ranks of mesh axis
    ``axis_name`` (``mesh`` defaults to the one ``use_rules``
    installed). Every rank calls it with its own leaves, in the same
    tree.

    The scale is max-reduced first so every rank dequantizes
    identically; int8 payloads are summed as int32 (no overflow up to
    2^24 ranks). Returns (mean gradients f32, new error feedback)."""
    if mesh is None:
        mesh = current_rules()[1]
    if mesh is None:
        raise ValueError("compressed_psum needs a mesh: pass mesh= or "
                         "call it under use_rules")
    group = mesh.get_group(axis_name)
    n = dist.get_world_size(group)
    means, errs = [], []
    for g, e in zip(_leaves(grads), _leaves(errors)):
        corrected = g.to(torch.float32) + e
        scale = (corrected.abs().max() / 127.0).reshape(1)
        dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
        scale = _floor(scale[0])
        q = torch.clamp(torch.round(corrected / scale), -127, 127)
        errs.append(corrected - q * scale)
        summed = q.to(torch.int32).contiguous()
        dist.all_reduce(summed, op=dist.ReduceOp.SUM, group=group)
        means.append(summed.to(torch.float32) * scale / n)
    return _unflatten(grads, means), _unflatten(errors, errs)
