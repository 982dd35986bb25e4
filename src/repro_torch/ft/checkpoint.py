"""Step-granular checkpointing with atomic rename + retention (port of
``repro.ft.checkpoint``).

Layout: <dir>/step_<N>/ {params.npz, opt.npz, meta.json}; a checkpoint
is visible only after the atomic directory rename, so a crash mid-save
never corrupts the latest restore point. ``keep`` most-recent steps are
retained. Restore resumes params, optimizer state and the exact data
pipeline position.

The npz keys are JAX's (``"layers/attn/wq"``, ``"m/embed"``, ``"step"``:
the dict keys of a leaf's path joined by ``/``, in sorted order), so a
checkpoint written by either package restores in the other. Leaves are
f32 or int32 (every configuration keeps ``param_dtype="float32"``);
numpy has no bfloat16 here, so a bf16 leaf raises a ``TypeError`` that
names it.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed.sharding import tree_map

Tree = Any


def _paths(tree: Tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(key, leaf) in JAX's flattening order: dict keys sorted, list and
    tuple items by index, ``None`` an empty subtree."""
    if tree is None:
        return
    if isinstance(tree, dict):
        items = ((str(k), tree[k]) for k in sorted(tree))
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        yield prefix, tree
        return
    for k, v in items:
        yield from _paths(v, f"{prefix}/{k}" if prefix else k)


def _check_dtype(key: str, dtype: torch.dtype) -> None:
    if dtype == torch.bfloat16:
        raise TypeError(f"checkpoint leaf {key!r} is bfloat16, which numpy "
                        f"cannot hold here; keep param_dtype='float32'")


def _flatten(tree: Tree) -> Dict[str, np.ndarray]:
    flat = {}
    for key, leaf in _paths(tree):
        if torch.is_tensor(leaf):
            _check_dtype(key, leaf.dtype)
            leaf = leaf.detach().cpu().numpy()
        flat[key] = np.asarray(leaf)
    return flat


def _unflatten_into(tree: Tree, flat: Dict[str, np.ndarray]) -> Tree:
    """``tree``'s structure with each leaf read from ``flat``, as a tensor
    on the leaf's device in the leaf's dtype."""
    def restore(key, like):
        _check_dtype(key, like.dtype)
        arr = flat[key]
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"checkpoint leaf {key!r}: shape {arr.shape}, "
                             f"expected {tuple(like.shape)}")
        return torch.from_numpy(arr.copy(order="C")).to(
            device=like.device, dtype=like.dtype)
    leaves = iter([restore(key, like) for key, like in _paths(tree)])
    return tree_map(lambda _: next(leaves), tree)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def save(self, step: int, params: Tree, opt_state: Tree,
             pipeline_state: Dict) -> str:
        final = self._step_dir(step)
        flat_p, flat_o = _flatten(params), _flatten(opt_state)
        tmp = tempfile.mkdtemp(dir=self.dir,
                               prefix=f"step_{step:08d}.tmp.")
        np.savez(os.path.join(tmp, "params.npz"), **flat_p)
        np.savez(os.path.join(tmp, "opt.npz"), **flat_o)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"step": step, "pipeline": pipeline_state}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)                      # atomic publish
        self._gc()
        return final

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[: max(len(steps) - self.keep, 0)]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def restore(self, params_like: Tree, opt_like: Tree,
                step: Optional[int] = None
                ) -> Tuple[Tree, Tree, Dict, int]:
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = self._step_dir(step)
        with np.load(os.path.join(d, "params.npz")) as z:
            pz = dict(z)
        with np.load(os.path.join(d, "opt.npz")) as z:
            oz = dict(z)
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        return (_unflatten_into(params_like, pz),
                _unflatten_into(opt_like, oz),
                meta["pipeline"], meta["step"])
