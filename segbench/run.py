"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m segbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Exits non-zero, printing no result, without as many CUDA cards as the
cell asks for, or if JAX or the JAX package was loaded into the process.
The last lines on standard error give each compared number beside its
limit; the last line of standard output is the result.
"""
import time

T_START = time.perf_counter()   # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m segbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from segbench import harness
    import torch

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"segbench: {args.workload} needs {cell.chips} CUDA card(s), "
              f"found {n}", file=sys.stderr)
        return 2

    def log(msg):
        print(f"segbench: {msg}", file=sys.stderr, flush=True)

    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           "cuda", T_START, log=log)
    found = forbidden_modules()
    if found:
        print(f"segbench: the process loaded {found}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
