"""One segment of ``text2image`` rows (its ``DATA_GROUP``) built and
searched under the inner product, through the benchmark's system
(``systems/query_node.build``):
the ``bigann-1m`` configuration's ``index`` and ``search`` groups with
``metric`` "ip" and the graph degree and block of Starling's Tab. 16 for
Text-to-Image (Λ 54 at η 4 KB, so ε 4 for 200-d f32 rows). Not run by
the benchmark.

    python3 -m segbench.rehearsal_ip --seed 7 --queries 4096

Prints one JSON line: the build's stage seconds and counters and the
card's peak memory, then, for the generated queries and for held-out
base rows used as queries, recall@10 against the exact inner-product
top-10 (float64 brute force, here), block reads a query, answers with an
id out of range or twice, and the largest gap of a returned key to the
exact negated inner product. A build or search that fails prints where,
with its error, in place of the figures it could not give.
"""
import argparse
import copy
import json
import sys
import time
import traceback

MAX_DEGREE = 54     # Starling's Tab. 16, Text-to-Image: Λ 54 at η 4 KB


def exact_ip_topk(base, queries, k: int, block: int = 1 << 17):
    """(ids [Q, k], ips [Q, k] float64): the k base rows of largest inner
    product with each query, in float64, in blocks of base rows."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    q = queries.to(torch.float64)
    best_v = torch.empty((q.shape[0], 0), dtype=torch.float64,
                         device=q.device)
    best_i = torch.empty((q.shape[0], 0), dtype=torch.int64, device=q.device)
    for s in range(0, base.shape[0], block):
        v = q @ base[s:s + block].to(torch.float64).T
        bv, bi = torch.topk(v, min(k, v.shape[1]), dim=1)
        best_v, o = torch.topk(torch.cat([best_v, bv], 1),
                               min(k, best_v.shape[1] + bv.shape[1]), dim=1)
        best_i = torch.gather(torch.cat([best_i, bi + s], 1), 1, o)
    return best_i, best_v


def judge_ip(base, queries, ids, keys, k: int) -> dict:
    """Recall@k of ``ids`` [Q, k] against the exact inner-product top-k
    (a slot counts when its row's inner product reaches the exact k-th:
    ties count as found), the answers with an id out of range or twice,
    and the largest |returned key + exact inner product| over
    max(1, |inner product|)."""
    import numpy as np
    import torch
    n = base.shape[0]
    ids = np.asarray(ids, np.int64)
    valid = (ids >= 0) & (ids < n)
    srt = np.sort(np.where(valid, ids, -1 - np.arange(k)[None, :]), 1)
    dup = (srt[:, 1:] == srt[:, :-1]).any(1)
    bad = int(((~valid.all(1)) | dup).sum())
    found, gap = 0, 0.0
    for s in range(0, len(ids), 1024):
        q = queries[s:s + 1024]
        _, tv = exact_ip_topk(base, q, k)
        i = torch.as_tensor(ids[s:s + 1024], device=base.device).clamp(
            0, n - 1)
        v = torch.as_tensor(valid[s:s + 1024] & ~dup[s:s + 1024, None],
                            device=base.device)
        got = (base[i].to(torch.float64)
               * q.to(torch.float64)[:, None, :]).sum(-1)
        kth = tv[:, -1:]
        found += int(((got >= kth - 1e-12 * kth.abs()) & v).sum())
        key = torch.as_tensor(np.asarray(keys[s:s + 1024], np.float64),
                              device=base.device)
        rel = ((key + got).abs() / got.abs().clamp_min(1.0)).masked_fill(
            ~v, 0.0)
        gap = max(gap, float(rel.nan_to_num(nan=float("inf")).max()))
    return {"recall_at_10": found / (len(ids) * k), "bad_answers": bad,
            "key_gap": gap}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m segbench.rehearsal_ip")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--queries", type=int, default=4096)
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from segbench import harness

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("segbench.rehearsal_ip: no CUDA card", file=sys.stderr)
        return 2
    cfg = copy.deepcopy(harness.load_cell("bigann-1m.stream").config)
    spec = copy.deepcopy(harness.plugin("generators",
                                        "text2image").DATA_GROUP)
    cfg.update(n=args.n, segment_n=args.n, segments=[args.n], data=spec)
    cfg["index"]["metric"] = "ip"
    cfg["index"]["graph"]["max_degree"] = MAX_DEGREE
    k = cfg["search"]["k"]
    out = {"generator": spec["generator"], "n": args.n, "seed": args.seed,
           "index": cfg["index"], "search": cfg["search"], "ran": False}
    if dev.type == "cuda":
        out["card"] = torch.cuda.get_device_name(0)
    # the base rows and, after them, as many held-out ones; the queries
    source = harness.data_source(spec)
    rows = source.base(spec, args.n + args.queries, dev)
    held = rows[args.n:].clone()
    x = rows[:args.n].contiguous()
    del rows
    q = source.queries(spec, args.queries, args.seed, "queries", dev)
    out["data"] = {"negative_share": float((x < 0).float().mean()),
                   "norm_median": float(x.norm(dim=1).median())}

    stage = "build"
    try:
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        node = harness.plugin("systems", cfg["system"]).build(
            cfg, x.cpu().numpy(), dev)
        out["build_s"] = time.perf_counter() - t0
        out["build"] = node.build_times[0]
        out["info"] = node.build_info[0]
        if dev.type == "cuda":
            out["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated())
        for name, qs in (("queries", q), ("held_out_base", held)):
            stage = f"search {name}"
            ids, keys, io = [], [], 0
            t0 = time.perf_counter()
            for s in range(0, len(qs), 1024):
                batch = qs[s:s + 1024].cpu().numpy()
                i, d = node.search(batch, k)
                ids.append(i[:len(batch)])
                keys.append(d[:len(batch)])
                io += node.batch_counts(len(batch))["io"]
            secs = time.perf_counter() - t0
            stage = f"judge {name}"
            got = judge_ip(x, qs, np.concatenate(ids), np.concatenate(keys),
                           k)
            out[name] = dict(got, io_per_query=io / len(qs),
                             search_s=secs)
        out["ran"] = True
    except Exception as e:  # the failure point is the finding
        out["failed_at"] = stage
        out["error"] = f"{type(e).__name__}: {e}"
        out["traceback"] = traceback.format_exc()[-4000:]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
