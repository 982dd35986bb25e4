"""Multi-pod dry run (port of ``repro.launch.dryrun``): every (arch x
shape x mesh) cell run once on fake tensors, as one rank sees it.

JAX lowers and compiles each cell for 256 or 512 forced host devices and
reads XLA's memory and cost analyses and the compiled HLO. Here, per cell:

  * a ``fake`` process group of 256 (single pod) or 512 (multi-pod) ranks
    is opened, as rank 0, with the production ``DeviceMesh`` on it. It is
    opened by ``run_cells`` / ``starling_cells`` for each cell and
    destroyed after it, never at import. One process holds one default
    group, so a caller that has a real group runs the dry run as a
    subprocess;
  * each ``ArgSpec`` of ``launch.specs.step_specs`` becomes a DTensor
    whose local shard is a ``FakeTensor``: nothing is allocated;
  * the step (``make_train_step`` / ``make_prefill`` / ``make_serve_step``)
    runs once under ``use_rules``, recording the rank's op trace
    (``distributed.hlo.OpTrace``, the counterpart of the compiled HLO,
    saved gzipped beside the records) and its memory (the trace counts
    each storage a recorded op creates until it is freed; torch's
    ``MemTracker`` is not used, as torch 2.11's counts DTensor's shape
    propagation at global shapes).

``bytes_per_device``: ``argument`` is the sum of one rank's
``ArgSpec.local_nbytes`` (the decode cache's ``len``, a host int, counted
as JAX's 4-byte int32); ``output`` the bytes of the returned tensors that
are not arguments; ``alias`` those that are (the decode step writes the
cache in place; the train step returns new trees and its caller drops
the old ones after it, where JAX donates them, so its alias is 0 and its
peak holds both); ``peak`` the trace's peak over the rank's storages,
the arguments included; ``temp`` = peak - argument - output; ``total`` =
argument + temp - alias, JAX's formula. The port has no XLA cost
analysis, so JAX's ``xla_*_once`` keys are absent; ``hlo_chars`` is the
length of the saved trace's text.

The roofline uses the NVIDIA H100 80GB HBM3's peaks at its 700 W limit:
989e12 FLOP/s dense bf16, 3.35e12 B/s HBM, 450e9 B/s NVLink a direction.

Results stream to a JSONL (one record per cell) under the git-ignored
``build/dryrun/``; completed cells are skipped on re-run:

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-1b \\
      --shape decode_32k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --starling
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback

import torch

from repro_torch.configs import ARCH_IDS, SHAPES, get_config, skip_reason
from repro_torch.distributed.hlo import (OpTrace, analyze_trace,
                                         load_trace, save_trace)
from repro_torch.distributed.sharding import ArgSpec, tree_map, use_rules
from repro_torch.launch.mesh import make_production_mesh, rules_for
from repro_torch.launch.specs import step_specs
from repro_torch.launch.serve import make_prefill, make_serve_step
from repro_torch.launch.train import default_optimizer, make_train_step

DEFAULT_OUT = os.path.join(os.path.dirname(__file__),
                           "../../../build/dryrun/dryrun.jsonl")

# NVIDIA H100 80GB HBM3 (SXM, 700 W power limit) constants (roofline)
PEAK_FLOPS = 989e12          # dense bf16 / card
HBM_BW = 3.35e12             # B/s / card
LINK_BW = 450e9              # B/s / direction (NVLink 4)


def _mesh_tag(multi_pod: bool) -> str:
    return "pod2x16x16" if multi_pod else "pod16x16"


@contextlib.contextmanager
def fake_world(size: int):
    """A ``fake`` default process group of ``size`` ranks, this process
    rank 0, destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry run opens its own fake process group; "
                           "run it in a process without one (a "
                           "subprocess)")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _save_hlo(arch: str, shape: str, multi_pod: bool, tag: str,
              trace, out_path: str) -> str:
    """Persist the op trace (gzip) so the roofline is re-runnable without
    re-running the step (see ``reanalyze``)."""
    d = os.path.join(os.path.dirname(os.path.abspath(out_path)), "hlo")
    os.makedirs(d, exist_ok=True)
    name = f"{arch}_{shape}_{_mesh_tag(multi_pod)}"
    if tag:
        name += f"_{tag}"
    path = os.path.join(d, name + ".trace.gz")
    save_trace(path, trace)
    return path


def _roofline(rec: dict, tot) -> None:
    rec["hlo_flops"] = tot.flops
    rec["hlo_bytes_raw"] = tot.bytes_accessed    # every op
    rec["hlo_bytes"] = tot.bytes_fused           # less the views
    rec["collective_bytes"] = int(tot.collective_bytes)
    rec["collectives"] = {
        k: {"count": int(v["count"]), "bytes": int(v["bytes"])}
        for k, v in tot.per_collective.items()}
    # roofline terms (per card, seconds); the trace is per rank
    rec["roofline"] = {
        "compute_s": tot.flops / PEAK_FLOPS,
        "memory_s": tot.bytes_fused / HBM_BW,
        "collective_s": tot.collective_bytes / LINK_BW,
    }
    rec["memory_s_raw"] = tot.bytes_accessed / HBM_BW
    rec["dominant"] = max(rec["roofline"], key=rec["roofline"].get)
    total = tot.flops * rec["chips"]
    rec["model_flops_ratio"] = (rec["model_flops"] / total if total
                                else 0.0)


def reanalyze(out_path: str) -> None:
    """Rebuild the roofline fields of every record from its saved
    trace."""
    recs = []
    with open(out_path) as f:
        for line in f:
            recs.append(json.loads(line))
    for rec in recs:
        p = rec.get("hlo_path")
        if rec.get("status") != "OK" or not p or not os.path.exists(p):
            continue
        _roofline(rec, analyze_trace(load_trace(p)))
    with open(out_path, "w") as f:
        for rec in recs:
            f.write(json.dumps(rec) + "\n")
    print(f"reanalyzed {len(recs)} records")


def _fake_args(tree, mesh, cache_len: int):
    """ArgSpec tree -> DTensors of fake local shards (a cache's ``len``
    -> the host int ``cache_len``)."""
    from torch.distributed.tensor import DTensor

    def one(a: ArgSpec):
        local = torch.zeros(a.local_shape, dtype=a.dtype)
        stride = tuple(math.prod(a.shape[i + 1:])
                       for i in range(len(a.shape)))
        return DTensor.from_local(local, mesh, a.placements,
                                  run_check=False, shape=a.shape,
                                  stride=stride)

    def walk(t):
        if isinstance(t, dict):
            return {k: (cache_len if k == "len" else walk(v))
                    for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        return None if t is None else one(t)
    return walk(tree)


def _locals(tree) -> list:
    out = []

    def leaf(t):
        if isinstance(t, torch.Tensor):
            out.append(t.to_local() if hasattr(t, "to_local") else t)
    tree_map(leaf, tree)
    return out


def _storage_bytes(tensors) -> dict:
    """storage key -> bytes, each storage once."""
    seen = {}
    for t in tensors:
        st = t.untyped_storage()
        seen[st._cdata] = st.nbytes()
    return seen


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               extra_tag: str = "", step_override=None,
               overrides: dict = None, out_path: str = DEFAULT_OUT, *,
               cfg=None, shape=None, mesh=None) -> dict:
    """Run one cell once on fake tensors in the open fake group; returns
    the JSONL record. ``cfg``, ``shape`` and ``mesh`` replace the arch's
    config, the named shape and the production mesh (a smoke cell on a
    small group)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = cfg or get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = shape or SHAPES[shape_name]
    mesh = mesh or make_production_mesh(multi_pod=multi_pod,
                                        device_type="cpu")
    rules = rules_for(mesh)
    rec = {"arch": arch, "shape": shape_name, "mesh": _mesh_tag(multi_pod),
           "kind": shape.kind, "tag": extra_tag}

    kind, specs = step_specs(cfg, shape, mesh)
    if step_override is not None:
        fn = step_override
    elif kind == "train":
        fn = make_train_step(cfg, default_optimizer())
    elif kind == "prefill":
        fn = make_prefill(cfg, shape.seq_len)
    else:
        fn = make_serve_step(cfg)

    argument = 0
    for a in _spec_leaves(specs):
        argument += a.local_nbytes
    t0 = time.time()
    trace = OpTrace()
    with FakeTensorMode(allow_non_fake_inputs=True):
        args = _fake_args(specs, mesh, shape.seq_len - 1)
        arg_locals = _locals(args)
        trace.track(*arg_locals)
        with use_rules(rules, mesh), trace:
            out = fn(*args)
        peak = trace.peak
        outs = _storage_bytes(_locals(out))
        ins = _storage_bytes(arg_locals)
    rec["lower_s"] = round(time.time() - t0, 1)
    rec["compile_s"] = 0.0
    alias = sum(b for k, b in outs.items() if k in ins)
    output = sum(b for k, b in outs.items() if k not in ins)
    rec["bytes_per_device"] = {
        "argument": argument, "output": output,
        "temp": max(peak - argument - output, 0), "alias": alias,
        "peak": peak}
    bpd = rec["bytes_per_device"]
    bpd["total"] = bpd["argument"] + bpd["temp"] - bpd["alias"]

    rec["hlo_path"] = _save_hlo(arch, shape_name, multi_pod, extra_tag,
                                trace.ops, out_path)
    rec["hlo_chars"] = sum(len(op.to_json()) + 1 for op in trace.ops)
    rec["chips"] = mesh.size()
    # MODEL_FLOPS = 6 N D (dense) / 6 N_active D (MoE); D = tokens
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        rec["model_flops"] = 6.0 * cfg.active_params() * tokens
    else:
        tokens = (shape.global_batch * shape.seq_len
                  if shape.kind == "prefill" else shape.global_batch)
        rec["model_flops"] = 2.0 * cfg.active_params() * tokens
    _roofline(rec, analyze_trace(trace.ops))
    return rec


def _spec_leaves(tree) -> list:
    out = []

    def walk(t):
        if isinstance(t, ArgSpec):
            out.append(t)
        elif isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
    walk(tree)
    return out


def _load_done(path: str) -> set:
    done = set()
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                try:
                    r = json.loads(line)
                    done.add((r["arch"], r["shape"], r["mesh"],
                              r.get("tag", "")))
                except Exception:
                    pass
    return done


def run_cells(cells, out_path: str, force: bool = False,
              tag: str = "", overrides: dict = None) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    done = set() if force else _load_done(out_path)
    for arch, shape_name, multi_pod in cells:
        key = (arch, shape_name, _mesh_tag(multi_pod), tag)
        if key in done:
            print(f"[skip-done] {key}")
            continue
        reason = skip_reason(arch, shape_name)
        rec = {"arch": arch, "shape": shape_name,
               "mesh": _mesh_tag(multi_pod), "tag": tag}
        if reason is not None:
            rec["status"] = "SKIP"
            rec["skip_reason"] = reason
            print(f"[SKIP] {key}: {reason}")
        else:
            print(f"[lower] {key} ...", flush=True)
            try:
                with fake_world(512 if multi_pod else 256):
                    rec.update(lower_cell(arch, shape_name, multi_pod,
                                          extra_tag=tag,
                                          overrides=overrides,
                                          out_path=out_path))
                rec["status"] = "OK"
                r = rec["roofline"]
                print(f"  OK lower={rec['lower_s']}s "
                      f"mem={rec['bytes_per_device']['total']/2**30:.2f}GiB "
                      f"comp={r['compute_s']*1e3:.2f}ms "
                      f"hbm={r['memory_s']*1e3:.2f}ms "
                      f"coll={r['collective_s']*1e3:.2f}ms "
                      f"dom={rec['dominant']}", flush=True)
            except Exception as e:
                rec["status"] = "FAIL"
                rec["error"] = f"{type(e).__name__}: {e}"
                rec["traceback"] = traceback.format_exc()[-2000:]
                print(f"  FAIL {rec['error']}", flush=True)
        with open(out_path, "a") as f:
            f.write(json.dumps(rec) + "\n")


def starling_cells(out_path: str, force: bool = False) -> None:
    """The Starling segment ``search_step`` on the production mesh.

    The round loop syncs to the host every round, which fake tensors
    cannot answer, so the step is not run: the argument bytes come from
    ``make_search_step``'s ``ArgSpec``s, and the collectives are the
    step's two all-gathers over ``model`` (``core/device_search.
    make_search_step``'s ``fn``: the [Q_local, k] int32 global ids and
    the [Q_local, k] f32 dists of every ``model`` rank), counted from
    their shapes. No FLOPs or HBM bytes are recorded."""
    from repro_torch.core.device_search import (DeviceSegment,
                                                make_search_step)
    from repro_torch.core.params import DeviceSearchParams
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    for multi_pod in (False, True):
        key = ("starling-search", "segment", _mesh_tag(multi_pod), "")
        done = set() if force else _load_done(out_path)
        if key in done:
            print(f"[skip-done] {key}")
            continue
        rec = {"arch": "starling-search", "shape": "segment",
               "mesh": _mesh_tag(multi_pod), "tag": ""}
        try:
            t0 = time.time()
            with fake_world(512 if multi_pod else 256):
                mesh = make_production_mesh(multi_pod=multi_pod,
                                            device_type="cpu")
                rules = rules_for(mesh)
                fn, (seg, q) = make_search_step(mesh, rules)
                g = mesh.size(mesh.mesh_dim_names.index("model"))
                chips = mesh.size()
            rec["lower_s"] = round(time.time() - t0, 1)
            leaves = [getattr(seg, f.name)
                      for f in dataclasses.fields(DeviceSegment)] + [q]
            rec["bytes_per_device"] = {
                "argument": sum(a.local_nbytes for a in leaves),
                "temp": None}
            k = DeviceSearchParams().k          # the step's default
            q_local = q.local_shape[0]
            gather = q_local * k * 4            # ids int32, dists f32
            rec["hlo_flops"] = None
            rec["hlo_bytes"] = None
            rec["collectives"] = {"all-gather": {"count": 2,
                                                 "bytes": 2 * gather}}
            rec["collective_bytes"] = 2 * gather
            rec["chips"] = chips
            rec["model_group"] = g
            rec["status"] = "OK"
            print(f"[starling] {key} OK "
                  f"arg={rec['bytes_per_device']['argument']:,}B "
                  f"coll={rec['collective_bytes']:,}B")
        except Exception as e:
            rec["status"] = "FAIL"
            rec["error"] = f"{type(e).__name__}: {e}"
            rec["traceback"] = traceback.format_exc()[-2000:]
            print(f"[starling] FAIL {rec['error']}")
        with open(out_path, "a") as f:
            f.write(json.dumps(rec) + "\n")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--starling", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--reanalyze", action="store_true",
                    help="recompute roofline fields from stored traces")
    ap.add_argument("--tag", default="")
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=value (repeatable)")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)

    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        if v in ("True", "False"):
            v = v == "True"
        overrides[k] = v

    if args.reanalyze:
        reanalyze(args.out)
        return
    if args.starling:
        starling_cells(args.out, force=args.force)
        return

    pods = {"single": (False,), "multi": (True,),
            "both": (False, True)}[args.mesh]
    if args.all:
        cells = [(a, s, mp) for a in ARCH_IDS for s in SHAPES
                 for mp in pods]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape, mp) for mp in pods]
    run_cells(cells, args.out, force=args.force, tag=args.tag,
              overrides=overrides)


if __name__ == "__main__":
    main()
