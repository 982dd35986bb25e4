"""Recall@10 of one 1M segment on two data sets, on the card: the port's
``data.vectors.clustered_vectors`` (isotropic clusters, 5% background)
and this benchmark's SIFT-shaped generator, each built with the
``bigann-1m`` configuration and searched at its Γ. Prints, for each,
the build's stage seconds, the vertices the connectivity fix attached,
recall@10 against the exact top-10 and block reads a query.

    python3 -m segbench.rehearsal --seed 7 --queries 4096
"""
import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m segbench.rehearsal")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--queries", type=int, default=4096)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from repro_torch.data.vectors import clustered_vectors, query_set
    from segbench import harness

    cfg = harness.load_cell("bigann-1m.stream").config
    system = harness.plugin("systems", cfg["system"])
    ref = harness.plugin("references", cfg["reference"])
    dev = torch.device("cuda")
    n, k = cfg["n"], cfg["search"]["k"]
    sets = {
        "clustered_vectors": lambda: (
            clustered_vectors(n, cfg["data"]["dim"], seed=args.seed),
            None),
        "segbench": lambda: harness.rows(cfg, args.seed, args.queries, 0,
                                         dev)[:2]}
    for name, make in sets.items():
        x, q = make()
        if q is None:
            q = query_set(x, args.queries, seed=args.seed + 1)
        node = system.build(cfg, x, dev)
        ids = np.concatenate([node.search(q[s:s + 1024], k)[0]
                              for s in range(0, len(q), 1024)])
        io = node.servers[0].batch_stats()["io"].mean()
        got = ref.judge(x, q, ids, np.zeros(ids.shape, np.float32),
                        np.arange(len(q)), k, dev)
        print(json.dumps({"data": name, "build": node.build_times[0],
                          "info": node.build_info[0],
                          "recall_at_10": got["recall"],
                          "io_per_query_last_batch": float(io)}),
              flush=True)
        del node
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
