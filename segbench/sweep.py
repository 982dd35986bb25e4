"""Find an open-loop cell's knee: the highest arrival rate at which the
backlog does not grow over a window. One process builds the cell's
system once and runs the open loop at each rate in turn, each for
``--seconds`` with fresh queries, without a drain.

    python3 -m segbench.sweep --workload bigann-1m.stream --seeds 7,8 \
        --seconds 30 --rates 3000,4000,5000,6000

Prints one JSON line a seed and rate: the rate offered and served, the backlog
(requests due but not dispatched) at the half and at the end of the
window, the mean batch, and the 50th and 95th percentile latency. Not
run by the benchmark; its result is written into the traffic file.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m segbench.sweep")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)

    import torch
    from segbench import harness
    if not torch.cuda.is_available():
        print("segbench.sweep: no CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    cfg, traffic = cell.config, cell.traffic
    loop = harness.plugin("loops", traffic["loop"])
    dev = torch.device("cuda")
    spec = cfg["data"]
    shapes = loop.warm_shapes(traffic, spec["dim"])
    seeds = [int(x) for x in args.seeds.split(",")]
    base, _, warm = harness.rows(cfg, seeds[0], 0, max(shapes), dev)
    node = harness.plugin("systems", cfg["system"]).build(cfg, base, dev)
    for b in shapes:
        node.search(warm[:b], traffic["k"])
    print(json.dumps({"setup_s": time.perf_counter() - T_START,
                      "card": torch.cuda.get_device_name(0)}), flush=True)
    s = args.seconds
    for seed, rate in [(sd, float(r)) for sd in seeds
                       for r in args.rates.split(",")]:
        tr = dict(traffic, rate_qps=rate)
        n = loop.pool_size(tr, s)
        pool = harness.data_source(spec).queries(
            spec, n, seed, f"queries-{rate}", dev).cpu().numpy()
        rec = harness.Recorder(n, traffic["k"])
        loop.run(node, tr, pool, s, seed, rec, drain_s=0.0)
        a, d, done = rec.arrival, rec.dispatch, rec.done
        due = np.isfinite(a) & (a < s)

        def backlog(t):
            return int((due & (a <= t) & ~(d <= t)).sum())
        ok = due & (done <= s)
        lat = np.where(ok, done - a, s - a)[due]
        bs = [b["n_valid"] for b in rec.batches if b["t_dispatch"] < s]
        print(json.dumps({
            "seed": seed, "rate": rate, "served_qps": float(ok.sum() / s),
            "backlog_half": backlog(s / 2), "backlog_end": backlog(s),
            "batches": len(bs), "mean_batch": float(np.mean(bs)),
            "p50_ms": float(np.percentile(lat, 50) * 1e3),
            "p95_ms": float(np.percentile(lat, 95) * 1e3)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
