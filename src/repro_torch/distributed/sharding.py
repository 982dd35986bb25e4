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

Under a ``DeviceMesh`` the model runs on DTensors, and the operators
whose placements DTensor would pick by a tie (it prices a slice of a
replicated operand at 0, so ``einsum``'s views may shard a dim that does
not divide) are decided here instead, as a dot partitioner decides them:
``einsum`` runs each rank's contraction on its local shards, and
``batch_local`` runs a function (a scan, the router) on each rank's rows.
Both hand back DTensors whose placements say what each rank holds, and
both are differentiable (``to_local`` / ``from_local`` with the gradient
placements of the split). ``use_rules`` on a ``DeviceMesh`` also treats
a plain tensor that meets a DTensor as replicated, as ``jit`` treats a
constant (``implicit_replication``).

``ArgSpec`` and ``spec_tree_to_shape_dtype`` describe sharded arguments
without allocating them: the counterpart of JAX's ``ShapeDtypeStruct``
with a ``NamedSharding`` (AOT lowering inputs).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
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
    previous rules come back on exit, also when the block raises. On a
    ``DeviceMesh`` a plain tensor that meets a DTensor in the block is
    taken as replicated (``implicit_replication``)."""
    prev = current_rules()
    set_rules(rules, mesh)
    try:
        with contextlib.ExitStack() as stack:
            if hasattr(mesh, "__enter__"):
                stack.enter_context(mesh)
            if hasattr(mesh, "get_group"):
                from torch.distributed.tensor.experimental import (
                    implicit_replication)
                stack.enter_context(implicit_replication())
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
    is redistributed, a plain tensor taken as replicated (every rank
    holds the same full tensor) and sliced; a no-op without rules."""
    rules, mesh = current_rules()
    if rules is None or mesh is None:
        return x
    pl = placements(logical_spec(x.shape, axes, rules, mesh), mesh)
    return as_dtensor(x, mesh).redistribute(mesh, pl)


# ------------------------------------------- local compute on a mesh

def _mesh_of(xs):
    """The mesh of the first DTensor among ``xs``, or None."""
    from torch.distributed.tensor import DTensor
    for x in xs:
        if isinstance(x, DTensor):
            return x.device_mesh
    return None


def as_dtensor(x: torch.Tensor, mesh):
    """A DTensor as it is; a plain tensor as a replicated one."""
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def local_shard(x, want, split):
    """``x`` laid out as ``want``, then its local shard. Its gradient
    comes back ``Partial`` on each mesh dim where the local work is
    ``split`` and ``x`` is replicated: each rank's share of it is one
    term of the sum."""
    from torch.distributed.tensor import Partial
    grad = tuple(Partial() if (p.is_replicate() and s) else p
                 for p, s in zip(want, split))
    return x.redistribute(x.device_mesh, want).to_local(grad_placements=grad)


def from_local_shard(t: torch.Tensor, mesh, pl, shape):
    """A DTensor of global ``shape`` (contiguous strides) from each
    rank's contiguous local ``t``."""
    from torch.distributed.tensor import DTensor
    shape = tuple(shape)
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(t, mesh, pl, run_check=False, shape=shape,
                              stride=stride)


def einsum(eq: str, *operands: torch.Tensor) -> torch.Tensor:
    """``torch.einsum``; on DTensors each rank contracts its local shards.

    For each mesh dim the first operand sharded on it names the *lead*
    index letter (the activation's, as the model passes it first). Every
    operand holding that letter is sharded on it (a replicated operand is
    sliced, at no cost), every other operand is gathered on that mesh
    dim, and the output is sharded on the letter, or ``Partial`` (a sum
    pending) where the letter is contracted. A mesh dim that shards no
    operand leaves the output replicated there. So an FSDP weight meeting
    batch-sharded rows is all-gathered, a heads- or vocab-sharded weight
    shards the output, and a row-parallel product is a pending sum."""
    mesh = _mesh_of(operands)
    if mesh is None:
        return torch.einsum(eq, *operands)
    from torch.distributed.tensor import Partial, Replicate, Shard
    ins, out = eq.replace(" ", "").split("->")
    subs = ins.split(",")
    ops = [as_dtensor(o, mesh) for o in operands]
    want = [[Replicate()] * mesh.ndim for _ in ops]
    out_pl = []
    for k in range(mesh.ndim):
        lead = next((sub[o.placements[k].dim] for sub, o in zip(subs, ops)
                     if o.placements[k].is_shard()), None)
        if lead is None:
            out_pl.append(Replicate())
            continue
        for i, sub in enumerate(subs):
            if lead in sub:
                want[i][k] = Shard(sub.index(lead))
        out_pl.append(Shard(out.index(lead)) if lead in out else Partial())
    split = [not p.is_replicate() for p in out_pl]
    size = {c: n for sub, o in zip(subs, ops) for c, n in zip(sub, o.shape)}
    res = torch.einsum(eq, *[local_shard(o, w, split)
                             for o, w in zip(ops, want)])
    return from_local_shard(res.contiguous(), mesh, out_pl,
                            [size[c] for c in out])


def batch_local(fn, *args, batch: Sequence[Optional[int]]):
    """``fn(*args)``; on DTensors each rank runs ``fn`` on its own rows.

    ``batch[i]`` is the batch dim of ``args[i]`` (None: the argument has
    none and is replicated whole; an argument that is not a tensor passes
    as it is). The batch dims keep the first batched DTensor's sharding
    of its rows; every other dim is replicated. The
    outputs, a tensor or a tuple / list / dict tree of them (None leaves
    pass), have their batch dim first and come back sharded like the
    rows. For work that is independent per row and that DTensor has no
    strategy for (the scans' chunk loops, the router's sort)."""
    mesh = _mesh_of(args)
    if mesh is None:
        return fn(*args)
    from torch.distributed.tensor import Replicate, Shard
    pl, d0 = next((a.placements, d) for a, d in zip(args, batch)
                  if d is not None and hasattr(a, "placements"))
    rows = [p.is_shard() and p.dim == d0 for p in pl]

    def want(d):
        return [Shard(d) if (r and d is not None) else Replicate()
                for r in rows]
    locs = [local_shard(as_dtensor(a, mesh), want(d), rows)
            if isinstance(a, torch.Tensor) else a
            for a, d in zip(args, batch)]
    b = next(a.shape[d] for a, d in zip(args, batch)
             if d is not None and isinstance(a, torch.Tensor))
    res = fn(*locs)

    def back(t):
        if t is None:
            return None
        return from_local_shard(t.contiguous(), mesh, want(0),
                                (b,) + tuple(t.shape[1:]))
    return tree_map(back, res)


def ways(x: torch.Tensor, dim: int) -> int:
    """Into how many shards the mesh splits tensor dim ``dim`` of ``x``
    (1 for a plain tensor)."""
    pl = getattr(x, "placements", ())
    return math.prod(x.device_mesh.size(k) for k, p in enumerate(pl)
                     if p.is_shard() and p.dim == dim % x.ndim)


def unshard_dim(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` with tensor dim ``dim`` gathered on every mesh dim that
    shards it (a plain tensor as it is): for a reshape that splits that
    dim into pieces the mesh does not divide."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor):
        return x
    dim = dim % x.ndim
    pl = [Replicate() if (p.is_shard() and p.dim == dim) else p
          for p in x.placements]
    return x.redistribute(x.device_mesh, pl)


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


# ------------------------------------------------------ argument specs

@dataclasses.dataclass(frozen=True)
class ArgSpec:
    """A sharded argument described without allocating it (the
    counterpart of JAX's sharded ``ShapeDtypeStruct``): the global
    ``shape`` and ``dtype``, the ``spec`` (``PartitionSpec``), its
    DTensor ``placements`` on the mesh and the ``local_shape`` each rank
    holds."""
    shape: tuple
    dtype: torch.dtype
    spec: tuple
    placements: tuple
    local_shape: tuple

    @property
    def local_nbytes(self) -> int:
        """One rank's bytes of this argument."""
        return (math.prod(self.local_shape)
                * torch.empty((), dtype=self.dtype).element_size())


def arg_spec(shape: Sequence[int], dtype: torch.dtype, spec: Sequence,
             mesh) -> ArgSpec:
    """The ``ArgSpec`` of a ``shape`` / ``dtype`` laid out by ``spec``
    on ``mesh`` (each sharded dim divided by its mesh axes' sizes)."""
    sizes = axis_sizes(mesh)
    local = list(shape)
    for i, entry in enumerate(spec):
        for a in (() if entry is None else entry
                  if isinstance(entry, tuple) else (entry,)):
            local[i] //= sizes[a]
    return ArgSpec(tuple(shape), dtype, PartitionSpec(*spec),
                   placements(spec, mesh), tuple(local))


def spec_tree_to_shape_dtype(spec_tree, rules: AxisRules, mesh, dtype=None):
    """ParamSpec tree -> ``ArgSpec`` tree laid out by the logical axes
    (``dtype`` overrides each spec's own; AOT inputs: no allocation)."""
    def one(ps):
        return arg_spec(ps.shape, dtype or ps.dtype,
                        logical_spec(ps.shape, ps.axes, rules, mesh), mesh)
    return tree_map(one, spec_tree, is_leaf=lambda x: hasattr(x, "axes"))
