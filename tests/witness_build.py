"""The port's disk-graph builds beside the JAX package's at a size both
can run on the CPU (not a pytest module: it takes minutes).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/witness_build.py \
        --n 20000 --algos vamana,nsg

For each algorithm, both packages build the graph of
``clustered_vectors(n, 128, seed)`` with the bench segment's graph knobs
(Λ=24, L=64, α=1.2); the script prints, per package, the build seconds,
the average degree, how many vertices were unreachable before the
connectivity fix and how many summed over its rounds (for the port also
the attachments it reports making), and recall@10 of the JAX beam search (beam L) from the graph's entry
on ``--queries`` queries against the exact neighbours. It also prints
the share of adjacency rows the two graphs have equal. One JSON line per
algorithm. ``--packages jax`` builds with one package alone (e.g. at a
size where the port's CPU build is not wanted).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def _counting_reachable(mod, log):
    """Wrap ``mod._reachable`` so each call logs its unreachable count
    (the connectivity fix calls it once per round)."""
    orig = mod._reachable

    def wrapped(g):
        seen = orig(g)
        log.append(int((~seen).sum()))
        return seen
    mod._reachable = wrapped
    return orig


def _graph_stats(g, x, queries, truth, beam):
    from repro.core import graph as JG
    ids, _, _ = JG.greedy_search_batch(x, g.adj, g.deg, int(g.entry),
                                       queries, beam=beam)
    hits = sum(len(set(r[:10].tolist()) & set(t.tolist()))
               for r, t in zip(ids, truth))
    return {"avg_degree": float(g.deg.mean()),
            "recall_at_10": hits / truth.size}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--queries", type=int, default=200)
    ap.add_argument("--algos", default="vamana,nsg")
    ap.add_argument("--packages", default="jax,port",
                    help="one of them alone where the other takes too long")
    args = ap.parse_args()

    import repro.core  # noqa: F401  (before repro.pq: import order)
    from repro.core import graph as JG
    from repro.core.params import GraphParams as JGP
    from repro.data.vectors import clustered_vectors, query_set
    from repro_torch.core import graph as TG
    from repro_torch.core.params import GraphParams as TGP

    x = clustered_vectors(args.n, args.dim, seed=args.seed)
    queries = query_set(x, args.queries, seed=args.seed + 1)
    d = (np.sum(queries ** 2, 1)[:, None] + np.sum(x ** 2, 1)[None]
         - 2.0 * queries @ x.T)
    truth = np.argsort(d, axis=1, kind="stable")[:, :10]
    knobs = dict(max_degree=24, build_beam=64, alpha=1.2)
    for algo in args.algos.split(","):
        out = {"n": args.n, "dim": args.dim, "seed": args.seed,
               "algo": algo, **knobs}
        graphs = {}
        for name, mod, gp, kw in (
                ("jax", JG, JGP(algo=algo, **knobs), {}),
                ("port", TG, TGP(algo=algo, **knobs),
                 {"device": "cpu", "stats": {}})):
            if name not in args.packages.split(","):
                continue
            log: list = []
            orig = _counting_reachable(mod, log)
            try:
                t0 = time.perf_counter()
                g = mod.build_graph(x, gp, **kw)
                secs = time.perf_counter() - t0
            finally:
                mod._reachable = orig
            graphs[name] = g
            out[name] = {"build_s": secs,
                         "unreachable_before_fix": log[0] if log else 0,
                         "unreachable_over_rounds": sum(log),
                         **_graph_stats(g, x, queries, truth,
                                        knobs["build_beam"])}
            if "stats" in kw:       # the port's own count of attachments
                out[name]["fix_attachments"] = kw["stats"]["attached"]
            print(f"  {algo} {name}: {out[name]}", flush=True)
        if len(graphs) == 2:
            ja, pa = graphs["jax"], graphs["port"]
            out["adj_rows_equal"] = float(
                ((ja.adj == pa.adj).all(1) & (ja.deg == pa.deg)).mean())
            out["entry_equal"] = int(ja.entry) == int(pa.entry)
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    torch.set_num_threads(4)
    main()
