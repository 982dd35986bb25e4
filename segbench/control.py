"""The control: the reference put in the program's place, one precision
down (bfloat16), run through the harness at a cell's own size and load.
Its answers must come out as not correct.

    python3 -m segbench.control --workload bigann-1m.stream \
        --seeds 11,12,13 --seconds 10

Prints one JSON line a seed with the compared numbers. Not run by the
benchmark; the limits in the configuration files are set from its
readings and the program's (PERF.md).
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402


class ControlNode:
    """A query node whose search is ``references.<ref>.control`` over
    the whole base set."""

    def __init__(self, ref, base: np.ndarray, device):
        self.ref = ref
        self.base = torch.as_tensor(base, device=device)
        self.build_times = [{}]

    def search(self, queries: np.ndarray, k: int):
        q = torch.as_tensor(queries, device=self.base.device)
        return self.ref.control(self.base, q, k)

    def batch_counts(self, n_valid: int) -> dict:
        return {"rounds": 0, "io": 0}


def control_builder(ref):
    def build(cfg, base, device, tracer):
        return ControlNode(ref, base, device)
    return build


def size_closed_loop(cell, ref, device) -> None:
    """A closed loop's query pool is sized by ``max_qps``: set it to
    twice the control's own rate on one of the traffic's batches over a
    stand-in base set of the cell's size."""
    if "max_qps" not in cell.traffic:
        return
    b, dim = cell.traffic["batch"], cell.config["data"]["dim"]
    node = ControlNode(ref, np.zeros((sum(cell.config["segments"]), dim),
                                     np.float32), device)
    q = np.zeros((b, dim), np.float32)
    node.search(q, cell.traffic["k"])
    t = time.perf_counter()
    node.search(q, cell.traffic["k"])
    cell.traffic["max_qps"] = 2 * b / (time.perf_counter() - t)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m segbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)

    from segbench import harness
    if not torch.cuda.is_available():
        print("segbench.control: no CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    ref = harness.plugin("references", cell.config["reference"])
    size_closed_loop(cell, ref, "cuda")
    for seed in [int(s) for s in args.seeds.split(",")]:
        out = harness.run_cell(cell, seed, args.seconds, False, "cuda",
                               time.perf_counter(),
                               build_node=control_builder(ref),
                               log=lambda m: None)
        print(json.dumps({"seed": seed, "precision": "bf16",
                          "correct": out["correct"],
                          "checks": out["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
