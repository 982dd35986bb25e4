"""One run of one cell: set-up, the measured window, the metrics and the
comparison that decides ``correct``.

Everything that belongs to one configuration, traffic mix or metric is
found by its name: ``configs/<config>.json`` (which names its
``system`` and ``reference``, and in its ``data`` group its
``generator``), ``traffic/<traffic>.json`` (which names its ``loop``),
``systems/<system>.py``, ``generators/<generator>.py``,
``loops/<loop>.py``, ``references/<reference>.py`` and
``metrics/<metric>.py``.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from segbench import ROOT, data, devtrace

HERE = pathlib.Path(__file__).resolve().parent


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def plugin(kind: str, name: str):
    """The module ``segbench/<kind>/<name>.py``, loaded by path."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    mod_name = f"segbench.{kind}.{name.replace('.', '_').replace('-', '_')}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def data_source(spec: dict):
    """The generator that a configuration's ``data`` group names."""
    if "generator" not in spec:
        raise KeyError('the configuration\'s "data" group names no '
                       '"generator" (segbench/generators/<name>.py)')
    return plugin("generators", spec["generator"])


def rows(cfg: dict, seed: int, pool_n: int, warm_n: int, device):
    """(base [N, D], pool [pool_n, D], warm [warm_n, D]) f32 numpy: the
    configuration's base rows, and the run's query pool and warm-up
    rows, from the generator its ``data`` group names."""
    spec = cfg["data"]
    gen = data_source(spec)
    base = gen.base(spec, sum(cfg["segments"]), device).cpu().numpy()
    pool = gen.queries(spec, pool_n, seed, "queries", device).cpu().numpy()
    warm = gen.queries(spec, warm_n, seed, "warmup", device).cpu().numpy()
    return base, pool, warm


@dataclasses.dataclass
class Cell:
    """A workload of ``BENCHMARK.json`` with its files read."""
    name: str
    chips: int
    config: dict
    traffic: dict
    metrics: List[dict]         # this cell's end-to-end and per-layer


def load_cell(name: str, bench: Optional[dict] = None) -> Cell:
    bench = bench if bench is not None else load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = load_json(ROOT / conf["file"])
    traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    metrics = []
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            if name in m.get("workloads", [name]):
                metrics.append(dict(m, kind=kind))
    return Cell(name, w["chips"], config, traffic, metrics)


class Recorder:
    """The window's requests and batches, on the host's clock (seconds
    after the window's start)."""

    def __init__(self, pool_n: int, k: int, tracer=None, hooks=None):
        self.ids = np.full((pool_n, k), -1, np.int64)
        self.dists = np.full((pool_n, k), np.inf, np.float32)
        self.arrival = np.full(pool_n, np.nan)
        self.dispatch = np.full(pool_n, np.nan)
        self.done = np.full(pool_n, np.nan)
        self.batches: List[dict] = []
        self.tracer = tracer
        self.hooks = hooks
        self.t0 = None
        self.t_end = None           # when the loop (and its drain) ended

    def begin(self, arrivals: Optional[np.ndarray]) -> None:
        if arrivals is not None:
            self.arrival[:len(arrivals)] = arrivals
        self.t0 = time.perf_counter()
        if self.tracer is not None:
            self.tracer.clear()

    def now(self) -> float:
        return time.perf_counter() - self.t0

    def arrive(self, idx: np.ndarray) -> None:
        self.arrival[idx] = self.now()

    def serve(self, node, q: np.ndarray, idx: np.ndarray, n_valid: int,
              k: int) -> None:
        t_disp = self.now()
        if self.hooks is not None:
            self.hooks.before(self, t_disp)
        e0 = len(self.tracer.events) if self.tracer is not None else 0
        if self.hooks is not None:
            with torch.profiler.record_function("segbench.search"):
                ids, dists = node.search(q, k)
        else:
            ids, dists = node.search(q, k)
        t_done = self.now()
        e1 = len(self.tracer.events) if self.tracer is not None else 0
        idx = idx[:n_valid]
        self.ids[idx] = ids[:n_valid]
        self.dists[idx] = dists[:n_valid]
        self.dispatch[idx] = t_disp
        self.done[idx] = t_done
        b = dict(t_dispatch=t_disp, t_done=t_done, n_valid=int(n_valid),
                 bucket=int(q.shape[0]), spans=(e0, e1), in_sub=False,
                 **node.batch_counts(n_valid))
        self.batches.append(b)
        if self.hooks is not None:
            self.hooks.after(self, b)


class SubWindow:
    """The traced run's device sub-window: whole batches, from the first
    dispatched after 0.6 of the window until a quarter of the window has
    passed (at least one batch), all inside the window. The host-side
    metrics read the batches before it, which the profiler does not
    slow."""

    def __init__(self, seconds: float):
        self.start_at = 0.6 * seconds
        self.length = 0.25 * seconds
        self.end_by = seconds
        self.window = devtrace.DeviceWindow()
        self.launches = devtrace.KernelLaunches()
        self.state = "waiting"
        self.t_start = None

    def before(self, rec, t: float) -> None:
        if self.state == "waiting" and t >= self.start_at:
            self.state = "open"
            self.t_start = t
            self.launches.__enter__()
            self.window.start()

    def after(self, rec, b: dict) -> None:
        if self.state != "open":
            return
        b["in_sub"] = True
        if (b["t_done"] - self.t_start >= self.length
                or b["t_done"] >= self.end_by):
            self.close()

    def close(self) -> None:
        if self.state == "open":
            self.window.stop()
            self.launches.__exit__(None, None, None)
            self.state = "closed"


@dataclasses.dataclass
class Run:
    """What the metric readers read (``metrics/<name>.py: read(run)``)."""
    cell: Cell
    seconds: float
    setup_s: float
    build_times: List[dict]
    rec: Recorder
    spans: list = dataclasses.field(default_factory=list)
    device: Optional[dict] = None      # the sub-window's trace
    check: Dict[str, float] = dataclasses.field(default_factory=dict)

    def window_batches(self) -> List[dict]:
        """Batches dispatched inside the window."""
        return [b for b in self.rec.batches if b["t_dispatch"] < self.seconds]

    def host_batches(self) -> List[dict]:
        """The window's batches before the traced sub-window (all of
        them in an untraced run)."""
        out = []
        for b in self.window_batches():
            if b["in_sub"]:
                break
            out.append(b)
        return out

    def window_requests(self) -> np.ndarray:
        """Pool indices of the requests due inside the window."""
        a = self.rec.arrival
        return np.nonzero(np.isfinite(a) & (a < self.seconds))[0]

    def batch_spans(self, b: dict) -> list:
        return self.spans[b["spans"][0]:b["spans"][1]]


class BuildCache:
    """Builds each configuration once per base set and hands the same
    query node to every run (with the run's tracer): for scripts and
    tests that make many runs of one cell in one process."""

    def __init__(self):
        self.nodes = {}

    def __call__(self, cfg, base, device, tracer):
        key = (cfg["name"], base.tobytes()[:4096], base.shape)
        if key not in self.nodes:
            self.nodes[key] = plugin("systems", cfg["system"]).build(
                cfg, base, device)
        node = self.nodes[key]
        node.coordinator.tracer = tracer
        return node


def device_reading(sub: SubWindow, rec: Recorder) -> Optional[dict]:
    if sub.state != "closed":
        return None
    dev, host, (lo, hi) = sub.window.events()
    n_all = len(dev)
    dev = devtrace.clip(dev, lo, hi)
    busy = devtrace.busy_intervals(dev)
    gaps = devtrace.idle_gaps(busy, lo, hi)
    by_name: Dict[str, float] = {}
    kernels = 0
    for n, a, b in dev:
        n = devtrace.short_name(n)
        by_name[n] = by_name.get(n, 0.0) + (b - a) / 1e6
        if not n.startswith(("Memcpy", "Memset")):
            kernels += 1
    return {"busy_s": sum(b - a for a, b in busy) / 1e6,
            "window_s": (hi - lo) / 1e6,
            "kernel_s": by_name, "kernels": kernels,
            "rounds": sum(b["rounds"] for b in rec.batches if b["in_sub"]),
            "idle_by_host": devtrace.label_gaps(gaps, host),
            "least_s": sub.launches.least_s(),
            "events_outside": n_all - len(dev)}


def device_info(chips: int, device) -> dict:
    if torch.device(device).type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": chips,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
    return {"platform": "cpu", "kind": "cpu", "count": chips,
            "memory_peak_bytes": 0}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, build_node: Optional[Callable] = None,
             drain_s: float = 60.0, log=print) -> dict:
    """One run; returns the result line's object. ``build_node(cfg,
    base, device, tracer)`` replaces the configuration's system (the
    control puts the reference there)."""
    cfg, traffic = cell.config, cell.traffic
    loop = plugin("loops", traffic["loop"])
    ref = plugin("references", cfg["reference"])
    k = traffic["k"]
    dev = torch.device(device)

    # set-up: data, the system, warm-up of the traffic's shapes
    pool_n = loop.pool_size(traffic, seconds)
    shapes = loop.warm_shapes(traffic, cfg["data"]["dim"])
    base, pool, warm = rows(cfg, seed, pool_n, max(shapes), dev)
    tracer = None
    if trace:
        from repro_torch.obs import Tracer, WallClock
        tracer = Tracer(WallClock())
    build = build_node or plugin("systems", cfg["system"]).build
    node = build(cfg, base, dev, tracer)
    for b in shapes:
        node.search(warm[:b], k)
    if trace:
        devtrace.DeviceWindow.prepare()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s; build {node.build_times}")

    # the window
    sub = SubWindow(seconds) if trace else None
    rec = Recorder(pool_n, k, tracer=tracer, hooks=sub)
    loop.run(node, traffic, pool, seconds, seed, rec, drain_s=drain_s)
    rec.t_end = rec.now()
    if sub is not None:
        sub.close()
    ms = [1e3 * (b["t_done"] - b["t_dispatch"]) for b in rec.batches
          if b["t_dispatch"] < seconds]
    log(f"window: {len(ms)} batches, ms min {min(ms):.1f} median "
        f"{float(np.median(ms)):.1f} max {max(ms):.1f}" if ms else
        "window: no batch")
    result_device = device_info(cell.chips, dev)
    run = Run(cell, float(seconds), setup_s, node.build_times, rec,
              spans=list(tracer.events) if tracer is not None else [])
    if trace:
        run.device = device_reading(sub, rec)
        if run.device is not None:
            log(f"sub-window: {run.device['window_s']:.3f} s, device busy "
                f"{run.device['busy_s']:.3f} s, {run.device['kernels']} "
                f"kernels, {run.device['rounds']} rounds, "
                f"{run.device['events_outside']} device events outside")
    del node
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the comparison, over every request due in the window
    due = run.window_requests()
    answered = due[np.isfinite(rec.done[due])]
    rng = np.random.default_rng(data.stream_seed(seed, "sample"))
    sample = np.sort(rng.choice(len(answered), min(cfg["recall_sample"],
                                                   len(answered)),
                                replace=False))
    got = ref.judge(base, pool[answered], rec.ids[answered],
                    rec.dists[answered], sample, k, dev)
    got["unanswered"] = int(len(due) - len(answered))
    got["recall_miss"] = 1.0 - got["recall"]
    run.check = got
    limits = cfg["limits"]
    checks = {name: {"value": got[name], "limit": lim}
              for name, lim in limits.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    metrics, unread = {}, []
    for m in cell.metrics:
        if (m["kind"] == "per_layer") != trace:
            continue
        value = plugin("metrics", m["name"]).read(run)
        if value is None:
            unread.append(m["name"])
            continue
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    if unread:
        log(f"metrics with nothing to read: {unread}")
    out = {"correct": bool(correct), "attempted": int(len(due)),
           "failed": int(got["unanswered"] + got["bad_answers"]),
           "metrics": metrics, "device": result_device}
    if trace and run.device is not None:
        d = run.device
        out["device"]["busy_s"] = d["busy_s"]
        out["device"]["window_s"] = d["window_s"]
        top = sorted(d["kernel_s"].items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(d["idle_by_host"].items(), key=lambda kv: -kv[1])[:10]
        out["breakdown"] = {"device_ops": [list(t) for t in top],
                            "idle_gaps": [list(g) for g in gaps]}
    out["checks"] = checks
    return out
