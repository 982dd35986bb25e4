"""Per-rank op-trace analyzer, the roofline's data source (port of
``repro.distributed.hlo``).

JAX reads the compiled HLO text; torch has none. The port keeps the
analyzer's contract and replaces its parser with a recorder:

  * ``OpTrace`` (a ``TorchDispatchMode``) records every op one rank runs
    on its local shards: name, local input and output shapes and dtypes,
    and a collective's group size. An op on DTensors is handed back to
    DTensor first (``NotImplemented``), so the trace holds what DTensor
    turns it into, the local op and the collectives of its
    redistributions, as an SPMD module's per-device HLO holds them. Ops
    that DTensor runs under its own fake mode to propagate shapes are
    not recorded (under a fake mode the trace gives them a second one of
    their own), nor ops that return no tensor. It works under
    ``FakeTensorMode``: nothing is allocated.
  * ``analyze_trace(trace)`` sums it into JAX's ``Totals``:
      - dot FLOPs: 2 x prod(result dims) x prod(contracted dims), for the
        matmul family only (``mm``, ``bmm``, ``addmm``, ``baddbmm``,
        ``addbmm``, ``mv``, ``dot``);
      - ``bytes_accessed``: operands plus result of every op;
      - ``bytes_fused``: the same less the view ops, which move nothing.
        Eager PyTorch fuses nothing, so this is the traffic it pays (JAX's
        is a TPU-fusion estimate below its raw count);
      - collective bytes per kind: an all-gather counts its result / g, a
        reduce-scatter its result x g, the rest their result.

Counts are per rank, on the local shards: replicated work is paid on
every rank, as JAX's per-device HLO pays it. JAX multiplies a ``while``
body by its trip count; a Python loop here runs every iteration, so the
trace needs no trip count. A trace saves to and loads from gzipped JSON
lines (``save_trace`` / ``load_trace``), the counterpart of the saved HLO.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gzip
import json
import weakref
from collections import defaultdict
from typing import Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather", "allgather_": "all-gather",
    "_allgather_base_": "all-gather", "all_gather_into_tensor_out":
    "all-gather", "all_reduce": "all-reduce", "allreduce_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter", "_reduce_scatter_base_":
    "reduce-scatter", "reduce_scatter_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "broadcast": "broadcast", "broadcast_": "broadcast",
}
_DOTS = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "mv", "dot"}
_VIEWS = {"view", "_unsafe_view", "reshape", "expand", "t", "transpose",
          "permute", "slice", "select", "unsqueeze", "squeeze", "as_strided",
          "alias", "detach", "unbind", "split", "split_with_sizes",
          "chunk", "narrow", "diagonal", "unfold", "view_as_real",
          "view_as_complex", "_reshape_alias", "lift_fresh", "movedim",
          "expand_as", "view_as", "flatten", "unflatten"}
_SKIP = {"wait_tensor", "_wrap_tensor_autograd", "empty", "empty_strided",
         "empty_like", "new_empty", "new_empty_strided", "set_",
         "record_stream", "_local_scalar_dense"}


@dataclasses.dataclass
class Op:
    """One recorded op: ``name`` (the aten or c10d overload packet),
    operands and results as (shape, dtype) pairs, a collective's group
    size (1 for the rest)."""
    name: str
    ins: List[Tuple[Tuple[int, ...], str]]
    outs: List[Tuple[Tuple[int, ...], str]]
    group: int = 1

    def to_json(self) -> str:
        return json.dumps([self.name, self.ins, self.outs, self.group])

    @staticmethod
    def from_json(line: str) -> "Op":
        name, ins, outs, group = json.loads(line)
        return Op(name, [(tuple(s), d) for s, d in ins],
                  [(tuple(s), d) for s, d in outs], group)


def _tensors(x, out):
    if isinstance(x, torch.Tensor):
        out.append((tuple(x.shape), str(x.dtype).replace("torch.", "")))
    elif isinstance(x, (list, tuple)):
        for v in x:
            _tensors(v, out)
    return out


def _group_size(func, args) -> int:
    """A collective's group size: its ``group_size`` argument, else the
    size of the group it names or carries."""
    import torch.distributed as dist
    schema = func._schema.arguments
    for a, v in zip(schema, args):
        if a.name == "group_size":
            return int(v)
    for a, v in zip(schema, args):
        if a.name == "group_name":
            from torch.distributed.distributed_c10d import (
                _resolve_process_group)
            return _resolve_process_group(v).size()
        if a.name == "process_group":
            return int(v.size())
    return dist.get_world_size()


class OpTrace(TorchDispatchMode):
    """Records one rank's local ops (see the module docstring);
    ``self.ops`` is the trace. It also keeps the rank's memory: each
    storage a recorded op creates counts from then until it is freed, as
    do the storages handed to ``track`` (the arguments); ``live`` and
    ``peak`` are bytes. (``MemTracker`` of torch 2.11 counts the ops of
    DTensor's shape propagation too, at global shapes.)"""

    def __init__(self):
        super().__init__()
        self.ops: List[Op] = []
        self.live = self.peak = 0
        self._storages: Dict[int, int] = {}

    def track(self, *tensors: torch.Tensor) -> None:
        """Count these tensors' storages (once each) until freed."""
        for t in tensors:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._storages:
                continue
            self._storages[key] = st.nbytes()
            self.live += st.nbytes()
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._storages.pop(key, 0)

    def __enter__(self):
        from torch._guards import TracingContext, active_fake_mode, tracing
        from torch._subclasses.fake_tensor import FakeTensorMode
        self._fake = active_fake_mode()
        self._ctx = contextlib.ExitStack()
        if self._fake is not None and TracingContext.try_get() is None:
            # DTensor propagates shapes under the TracingContext's fake
            # mode: a second one, so its ops are told from the rank's
            self._ctx.enter_context(tracing(TracingContext(
                FakeTensorMode(allow_non_fake_inputs=True))))
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._ctx.close()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._guards import active_fake_mode
        from torch.distributed.tensor import DTensor
        if any(t is DTensor for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        outs = _tensors(out, [])
        if active_fake_mode() is self._fake and outs and name not in _SKIP:
            kind = _COLLECTIVES.get(name)
            self.ops.append(Op(
                name, _tensors(list(args) + list((kwargs or {}).values()),
                               []),
                outs, _group_size(func, args) if kind else 1))
            self.track(*[t for t in (out if isinstance(out, (list, tuple))
                                     else [out])
                         if isinstance(t, torch.Tensor)])
        return out


_DTYPE_BYTES: Dict[str, int] = {}


def _nbytes(shape, dtype: str) -> int:
    if dtype not in _DTYPE_BYTES:
        _DTYPE_BYTES[dtype] = torch.empty(
            (), dtype=getattr(torch, dtype)).element_size()
    n = 1
    for d in shape:
        n *= d
    return n * _DTYPE_BYTES[dtype]


@dataclasses.dataclass
class Totals:
    flops: float = 0.0
    bytes_accessed: float = 0.0      # every recorded op
    bytes_fused: float = 0.0         # less the views (eager: no fusion)
    collective_bytes: float = 0.0
    per_collective: Dict[str, Dict] = dataclasses.field(
        default_factory=lambda: defaultdict(
            lambda: {"count": 0.0, "bytes": 0.0}))
    bytes_by_op: Dict[str, float] = dataclasses.field(
        default_factory=lambda: defaultdict(float))


def _dot_flops(op: Op) -> float:
    """2 x prod(result) x the contracted size (the last dim of the
    left operand: ``addmm``'s and ``baddbmm``'s bias comes first)."""
    ins = [s for s, _ in op.ins if len(s) >= 1]
    lhs = ins[1] if op.name in ("addmm", "baddbmm", "addbmm") else ins[0]
    result = 1.0
    for d in op.outs[0][0]:
        result *= d
    return 2.0 * result * lhs[-1]


def _collective(op: Op, t: Totals) -> None:
    kind = _COLLECTIVES[op.name]
    result = sum(_nbytes(*o) for o in op.outs)
    if kind == "all-gather":
        b = result // max(op.group, 1)
    elif kind == "reduce-scatter":
        b = result * op.group
    else:
        b = result
    t.per_collective[kind]["count"] += 1
    t.per_collective[kind]["bytes"] += b
    t.collective_bytes += b


def analyze_trace(trace: List[Op]) -> Totals:
    t = Totals()
    for op in trace:
        if op.name in _DOTS:
            t.flops += _dot_flops(op)
        if op.name in _COLLECTIVES:
            _collective(op, t)
        b = float(sum(_nbytes(*x) for x in op.ins + op.outs))
        t.bytes_accessed += b
        if op.name not in _VIEWS:
            t.bytes_fused += b
            t.bytes_by_op[op.name] += b
    return t


def save_trace(path: str, trace: List[Op]) -> None:
    with gzip.open(path, "wt") as f:
        for op in trace:
            f.write(op.to_json() + "\n")


def load_trace(path: str) -> List[Op]:
    with gzip.open(path, "rt") as f:
        return [Op.from_json(line) for line in f if line.strip()]


# ------------------------------------------------ JAX's flat interfaces

def collective_bytes(trace: List[Op]) -> Tuple[int, Dict[str, Dict]]:
    """Total collective bytes, and per kind {count, bytes}."""
    t = analyze_trace(trace)
    per = {k: {"count": int(v["count"]), "bytes": int(v["bytes"])}
           for k, v in t.per_collective.items()}
    return int(t.collective_bytes), per


def collective_summary(trace: List[Op]) -> str:
    total, per = collective_bytes(trace)
    lines = [f"collective operand bytes: {total:,}"]
    for op, d in sorted(per.items()):
        lines.append(f"  {op:20s} x{d['count']:<6d} {d['bytes']:,} B")
    return "\n".join(lines)


def count_ops(trace: List[Op], opcode: str) -> int:
    """Ops of one name (an aten name, or a collective kind such as
    ``"all-gather"``)."""
    return sum(op.name == opcode or _COLLECTIVES.get(op.name) == opcode
               for op in trace)
