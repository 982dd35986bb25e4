"""AdamW with global-norm clipping and LR schedules (port of
``repro.optim.adamw``).

Plain functions over the port's parameter trees (nested dicts of
tensors, leaves in sorted-key order as JAX flattens them), not
``torch.optim.AdamW``, which orders its arithmetic differently. The
state is JAX's: f32 moments ``m`` and ``v`` shaped like the parameters,
and ``step``, a 0-d int32 tensor. Every value a step computes (the
schedule's ``lr``, the norm, the clip scale) stays a device tensor, so
an update makes no host sync. ``adamw_update`` returns new trees and
leaves its inputs as they were.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Tuple

import torch

from repro_torch.distributed.sharding import tree_map

Tree = Any


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable[[torch.Tensor], torch.Tensor]
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def tree_leaves(tree: Tree) -> List[torch.Tensor]:
    """The leaves in JAX's order (sorted dict keys; ``None`` is empty)."""
    out: List[torch.Tensor] = []
    tree_map(out.append, tree)
    return out


def tree_like(tree: Tree, leaves) -> Tree:
    """``tree``'s structure with ``leaves`` (in ``tree_leaves`` order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def cosine_schedule(peak: float, warmup: int, total: int,
                    floor: float = 0.1) -> Callable:
    def lr(step):
        step = step.float()
        warm = peak * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1),
                           0.0, 1.0)
        cos = peak * (floor + (1 - floor) * 0.5
                      * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup, warm, cos)
    return lr


def linear_warmup(peak: float, warmup: int) -> Callable:
    def lr(step):
        return peak * torch.clamp(step.float() / warmup, max=1.0)
    return lr


def global_norm(tree: Tree) -> torch.Tensor:
    leaves = tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(l.float()))
                          for l in leaves))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """min(1, max_norm / max(norm, 1e-9)) as a true division (a Python
    number over a tensor is a reciprocal times the number in torch)."""
    return torch.clamp(torch.div(torch.full_like(norm, max_norm),
                                 torch.clamp(norm, min=1e-9)), max=1.0)


def clip_by_global_norm(tree: Tree, max_norm: float
                        ) -> Tuple[Tree, torch.Tensor]:
    norm = global_norm(tree)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g * scale.to(g.dtype), tree), norm


def adamw_init(params: Tree) -> Dict:
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else "cpu"
    return {"m": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                device=p.device), params),
            "v": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                device=p.device), params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def adamw_update(opt: AdamW, grads: Tree, state: Dict, params: Tree
                 ) -> Tuple[Tree, Dict, Dict]:
    """One AdamW step in JAX's order of operations. The clip is
    ``clip_by_global_norm``'s, applied leaf by leaf inside the update, so
    no clipped copy of the whole gradient tree is held at once."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, opt.clip_norm)
    step = state["step"] + 1
    lr = opt.lr(step)
    b1, b2 = opt.b1, opt.b2
    c1 = 1.0 - b1 ** step.float()
    c2 = 1.0 - b2 ** step.float()

    def upd(p, g, m, v):
        g = (g * scale.to(g.dtype)).float()
        m2 = b1 * m + (1 - b1) * g
        v2 = b2 * v + (1 - b2) * g * g
        delta = (m2 / c1) / (torch.sqrt(v2 / c2) + opt.eps)
        p2 = p.float() * (1.0 - lr * opt.weight_decay) - lr * delta
        return p2.to(p.dtype), m2, v2

    out = [upd(p, g, m, v) for p, g, m, v in zip(
        tree_leaves(params), tree_leaves(grads), tree_leaves(state["m"]),
        tree_leaves(state["v"]))]
    new_p = tree_like(params, [o[0] for o in out])
    new_m = tree_like(params, [o[1] for o in out])
    new_v = tree_like(params, [o[2] for o in out])
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_p, {"m": new_m, "v": new_v, "step": step}, metrics
