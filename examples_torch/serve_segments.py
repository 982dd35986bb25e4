"""End-to-end serving example (the paper's kind of workload): a machine
hosting multiple Starling segments behind a query coordinator + request
batcher, serving batched ANNS requests with the batched device search
(the PyTorch port of ``examples/serve_segments.py``).

  PYTHONPATH=src python examples_torch/serve_segments.py            # card
  PYTHONPATH=src python examples_torch/serve_segments.py --device cpu

On the card every round runs the fused CUDA round kernels
(``gather_union`` + ``t0_rank``); on the CPU their plain versions.
"""
import argparse
import dataclasses
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "src"))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402

from _card import check_device, device_line  # noqa: E402
from repro_torch.configs.starling_segment import SEGMENT_BENCH  # noqa: E402
from repro_torch.core import device_search as DS  # noqa: E402
from repro_torch.core import distances as D  # noqa: E402
from repro_torch.core.search import recall_at_k  # noqa: E402
from repro_torch.core.segment import build_segment  # noqa: E402
from repro_torch.data.vectors import clustered_vectors, query_set  # noqa: E402
from repro_torch.serving import (QueryCoordinator, RequestBatcher,  # noqa: E402
                                 SegmentServer)
from repro_torch.serving.coordinator import SERVE_DEVICE_SEARCH  # noqa: E402

NUM_SEGMENTS, N_PER, DIM = 3, 2000, 48


def build(device):
    """The three host segments and their vectors."""
    segs, xs = [], []
    for s in range(NUM_SEGMENTS):
        x = clustered_vectors(N_PER, DIM, num_clusters=16, seed=s)
        print(f"building segment {s} ({N_PER} vectors) ...")
        segs.append(build_segment(x, SEGMENT_BENCH, device=device))
        xs.append(x)
    return segs, xs


def make_servers(segs, device, fetch_impl: str = "fused"):
    """One ``SegmentServer`` a segment at consecutive id offsets
    (``fetch_impl="ref"``: the plain round instead of the kernels)."""
    servers, off = [], 0
    for seg in segs:
        servers.append(SegmentServer(
            segment=DS.from_segment(seg, device=device), offset=off,
            num_vectors=seg.num_vectors,
            params=dataclasses.replace(SERVE_DEVICE_SEARCH, candidates=48,
                                       fetch_impl=fetch_impl),
            device=str(device)))
        off += seg.num_vectors
    return servers


def serve(servers, queries) -> dict:
    """The queries as single requests through a ``RequestBatcher`` into a
    ``QueryCoordinator``: each batch's request ids, ids, dists and stats
    dict, the ids and dists in request order, and the wall seconds."""
    coord = QueryCoordinator(servers)
    batcher = RequestBatcher(dim=DIM, buckets=(8, 32))
    rids = [batcher.submit(qq) for qq in queries]
    print(f"submitted {len(rids)} requests")

    results, batches = {}, []
    t0 = time.perf_counter()
    while batcher.queue:
        qbatch, ids, n = batcher.next_batch()
        gi, gd, stats = coord.search(qbatch[:n], k=10)
        for i, rid in enumerate(ids):
            results[rid] = (gi[i], gd[i])
        batches.append({"rids": list(ids), "ids": gi, "dists": gd,
                        "stats": stats})
        print(f"  served batch of {n} "
              f"(segments={stats['segments_searched']}, "
              f"mean block reads/query="
              f"{stats['mean_block_reads_per_query']:.1f})")
    wall = time.perf_counter() - t0
    return {"batches": batches, "wall_s": wall,
            "ids": np.stack([results[r][0] for r in rids]),
            "dists": np.stack([results[r][1] for r in rids])}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = check_device(args.device, "serve_segments")
    card = device_line(device)

    print("== multi-segment serving demo ==")
    segs, xs = build(device)
    union = np.concatenate(xs, axis=0)
    queries = query_set(union, 24, seed=9)
    out = serve(make_servers(segs, device), queries)

    truth = D.brute_force_knn(union, queries, 10, device=device)
    out["recall"] = recall_at_k(out["ids"], truth)
    print(f"recall@10 over {NUM_SEGMENTS} segments: {out['recall']:.3f}")
    kernels = ("fused CUDA round kernels" if device.type == "cuda"
               else "plain round")
    print(f"wall ({card}, {kernels}): {out['wall_s']:.2f}s")
    out.update(segs=segs, queries=queries)
    return out


if __name__ == "__main__":
    main()
