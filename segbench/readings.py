"""The readings that a cell's limits are set from: the program's
compared numbers over many seeds, then the same with each planted fault
(``segbench.plant``), at the cell's own size and load with a short
window. One process builds the cell's query node once.

    python3 -m segbench.readings --workload bigann-1m.stream \
        --seeds 11,12,13 --faults graph_shuffled,pq_zeroed \
        --fault-seeds 3 --seconds 8

Prints one JSON line a run: the seed, the fault (null for the program),
``correct`` under the configuration's limits, and each compared number.
Not run by the benchmark.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m segbench.readings")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=8.0)
    args = ap.parse_args(argv)

    import torch
    from segbench import harness, plant
    if not torch.cuda.is_available():
        print("segbench.readings: no CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    builds = harness.BuildCache()
    runs = [(None, s) for s in seeds]
    for f in filter(None, args.faults.split(",")):
        runs += [(f, s) for s in seeds[:args.fault_seeds]]
    for fault, seed in runs:
        def build(cfg, base, device, tracer, fault=fault, seed=seed):
            node = builds(cfg, base, device, tracer)
            if fault is not None:
                node.planted = plant.FAULTS[fault](node, seed)
                node.planted.__enter__()
            return node
        out = harness.run_cell(cell, seed, args.seconds, False, "cuda",
                               time.perf_counter(), build_node=build,
                               log=lambda m: None)
        for node in builds.nodes.values():
            if getattr(node, "planted", None) is not None:
                node.planted.__exit__(None, None, None)
                node.planted = None
        print(json.dumps({"seed": seed, "fault": fault,
                          "correct": out["correct"],
                          "checks": out["checks"],
                          "metrics": out["metrics"]}), flush=True)
    print(json.dumps({"seconds": time.perf_counter() - T_START,
                      "card": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
