"""Logical-axis sharding rules (MaxText-style) -> DTensor placements (port
of ``repro.distributed.sharding``).

Model code annotates tensors with *logical* axis names; the launcher picks
a rule set mapping logical names to mesh axes. A dim is sharded only if
its size is divisible by the product of the mapped mesh axes; otherwise
that dim falls back to replication (e.g. gemma3's 4 heads on a 16-way
``model`` axis).

Rule sets:
  SINGLE_POD_RULES — mesh ("data", "model") = (16, 16)
    batch/fsdp -> data   (DP + ZeRO-style param/optimizer sharding)
    heads/ff/experts/vocab/inner -> model  (Megatron TP / EP)
    kv_seq -> model      (sequence-sharded KV cache for long-context decode)
  MULTI_POD_RULES  — mesh ("pod", "data", "model") = (2, 16, 16)
    batch/fsdp -> (pod, data); everything else as single-pod.

``logical_spec`` returns JAX's result as a ``PartitionSpec`` tuple (one
entry per tensor dim: ``None``, a mesh axis name, or a tuple of names);
``placements`` turns it into DTensor placements in mesh-dimension order
(``Shard(i)`` on every mesh dim that tensor dim ``i`` rides, else
``Replicate()``). A mesh is a ``torch.distributed`` ``DeviceMesh``
(``mesh_dim_names``), a ``launch.mesh.RankLayout`` or any object with a
``shape`` dict and ``axis_names``. ``torch.distributed.tensor`` is
imported where it is used (it adds ~1 s to an import).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Sequence, Tuple

import torch

AxisRules = Dict[str, Tuple[str, ...]]

SINGLE_POD_RULES: AxisRules = {
    "batch": ("data",),
    "fsdp": ("data",),            # weight dim sharded ZeRO-style
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "ff": ("model",),
    "experts": ("model",),
    "inner": ("model",),          # mamba/rwkv inner width
    "kv_seq": ("model",),         # KV-cache sequence axis (decode SP)
    "seq": (),                    # activation sequence axis: replicated
    "embed": (),
    "head_dim": (),
    "state": (),
}

MULTI_POD_RULES: AxisRules = dict(
    SINGLE_POD_RULES,
    batch=("pod", "data"),
    fsdp=("pod", "data"),
)

# Serving-plane placement rules (DESIGN.md §7): the leading ``segment``
# axis of a stacked DeviceSegment tree shards one sub-segment (or
# replica) per ``model`` rank — the Fig. 1(b) segments <-> ranks layout
# ``make_search_step`` and the MeshQueryRouter fan out over — while the
# ``query`` batch axis rides ``data`` and everything else (block,
# vertex, neighbor dims) replicates within a rank's shard.
SEGMENT_SERVE_RULES: AxisRules = {
    "segment": ("model",),
    "query": ("data",),
    "block": (),
    "vertex": (),
    "dim": (),
}


class PartitionSpec(tuple):
    """One entry per tensor dim: ``None`` (replicated), a mesh axis name,
    or a tuple of mesh axis names (major to minor). A one-name tuple
    is stored as the bare name, as JAX's ``PartitionSpec`` does, so the
    two compare equal as tuples."""

    def __new__(cls, *entries):
        norm = tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                     for e in entries)
        return super().__new__(cls, norm)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def axis_names(mesh) -> Tuple[str, ...]:
    """The mesh's axis names, in mesh-dimension order."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def axis_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size."""
    if getattr(mesh, "mesh_dim_names", None) is not None:
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


_local = threading.local()


def set_rules(rules: Optional[AxisRules], mesh) -> None:
    _local.rules = rules
    _local.mesh = mesh


def current_rules() -> Tuple[Optional[AxisRules], object]:
    return getattr(_local, "rules", None), getattr(_local, "mesh", None)


@contextlib.contextmanager
def use_rules(rules: AxisRules, mesh):
    """Install ``rules`` on ``mesh`` for the block (and enter the mesh
    where it is a context manager, as JAX enters ``with mesh:``); the
    previous rules come back on exit, also when the block raises."""
    prev = current_rules()
    set_rules(rules, mesh)
    try:
        with (mesh if hasattr(mesh, "__enter__")
              else contextlib.nullcontext()):
            yield
    finally:
        set_rules(*prev)


def _mesh_axis_size(sizes: Dict[str, int], axes: Sequence[str]) -> int:
    size = 1
    for a in axes:
        size *= sizes[a]
    return size


def logical_spec(shape: Sequence[int], axes: Sequence[Optional[str]],
                 rules: AxisRules, mesh) -> PartitionSpec:
    """Map logical axis names to a PartitionSpec, honouring divisibility;
    no mesh axis is used twice."""
    if len(shape) != len(axes):
        raise ValueError(f"shape {tuple(shape)} has {len(shape)} dims, "
                         f"axes {tuple(axes)} name {len(axes)}")
    sizes = axis_sizes(mesh)
    spec = []
    used: set = set()
    for dim, name in zip(shape, axes):
        mesh_axes = rules.get(name, ()) if name else ()
        mesh_axes = tuple(a for a in mesh_axes if a not in used)
        if mesh_axes and dim % _mesh_axis_size(sizes, mesh_axes) == 0:
            used.update(mesh_axes)
            spec.append(mesh_axes if len(mesh_axes) > 1 else mesh_axes[0])
        else:
            spec.append(None)
    return PartitionSpec(*spec)


def placements(spec: Sequence, mesh) -> tuple:
    """A spec -> DTensor placements in mesh-dimension order: ``Shard(i)``
    on each mesh dim that tensor dim ``i``'s entry names (a dim over two
    mesh axes shards on both), ``Replicate()`` on the rest."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    out = [Replicate() for _ in names]
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            out[names.index(a)] = Shard(i)
    return tuple(out)


def shard(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """Lay ``x`` out by logical names on the current mesh: a ``DTensor``
    is redistributed, a plain tensor distributed (every rank passes the
    same full tensor); a no-op without rules."""
    rules, mesh = current_rules()
    if rules is None or mesh is None:
        return x
    from torch.distributed.tensor import DTensor, distribute_tensor
    pl = placements(logical_spec(x.shape, axes, rules, mesh), mesh)
    if isinstance(x, DTensor):
        return x.redistribute(mesh, pl)
    return distribute_tensor(x, mesh, pl)


def tree_map(fn, tree, is_leaf=None):
    """Map ``fn`` over the leaves of nested dicts, lists and tuples
    (``None`` stays ``None``, as an empty JAX subtree); ``is_leaf``
    stops the descent."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree)
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], is_leaf) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, is_leaf) for v in tree]
        return type(tree)(out) if isinstance(tree, list) else tuple(out)
    return fn(tree)


def param_sharding_tree(spec_tree, rules: AxisRules, mesh):
    """Map a tree of ``ParamSpec``-likes (``.shape``/``.axes``) to
    placements on ``mesh`` (the DTensor counterpart of JAX's
    NamedShardings)."""
    return tree_map(
        lambda ps: placements(logical_spec(ps.shape, ps.axes, rules, mesh),
                              mesh),
        spec_tree, is_leaf=lambda x: hasattr(x, "axes"))
