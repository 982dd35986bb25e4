"""Quickstart: build a Starling segment, search it, compare against the
DiskANN-style baseline and brute force (the PyTorch port of
``examples/quickstart.py``).

  PYTHONPATH=src python examples_torch/quickstart.py                # card
  PYTHONPATH=src python examples_torch/quickstart.py --device cpu

The modeled latencies are ``NVME_SEGMENT``'s: an NVMe cost model of the
counted block reads and distances, not a time of the card. The search's
own wall clock is printed beside the device it ran on.
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
from repro_torch.core import baseline as B  # noqa: E402
from repro_torch.core import distances as D  # noqa: E402
from repro_torch.core.iostats import NVME_SEGMENT  # noqa: E402
from repro_torch.core.search import (anns, average_precision,  # noqa: E402
                                     range_search, recall_at_k)
from repro_torch.core.segment import build_segment  # noqa: E402
from repro_torch.data.vectors import clustered_vectors, query_set  # noqa: E402


def data(device):
    """The corpus, its 20 queries and their brute-force top-10."""
    x = clustered_vectors(5000, 64, num_clusters=32, seed=0)
    q = query_set(x, 20, seed=1)
    return x, q, D.brute_force_knn(x, q, 10, device=device)


def search(seg, x, q, truth, device) -> dict:
    """Starling's ANNS, the baseline's and the range search on ``seg``:
    the per-query ids and ``IOStats`` of each, and what the example
    prints of them."""
    t0 = time.perf_counter()
    ids, _, stats = anns(seg.view, q, 10, seg.params.search, device=device)
    out = {"search_s": time.perf_counter() - t0, "ids": ids,
           "stats": stats, "recall": recall_at_k(ids, truth),
           "mean_io": float(np.mean([s.block_reads for s in stats])),
           "xi": float(np.mean([s.vertex_utilization for s in stats])),
           "latency_us": float(np.mean([
               NVME_SEGMENT.latency_us(s, pipeline=True) for s in stats]))}

    p_base = dataclasses.replace(seg.params.search,
                                 use_block_search=False,
                                 use_nav_graph=False)
    ids_b, _, stats_b = B.vertex_anns(seg.view, q, 10, p_base,
                                      device=device)
    out.update(
        base_ids=ids_b, base_stats=stats_b,
        base_recall=recall_at_k(ids_b, truth),
        base_mean_io=float(np.mean([s.block_reads for s in stats_b])),
        base_xi=float(np.mean([s.vertex_utilization for s in stats_b])),
        base_latency_us=float(np.mean([
            NVME_SEGMENT.latency_us(s, pipeline=False) for s in stats_b])))

    radius = float(np.quantile(
        D.pairwise(q, x, device=device).cpu().numpy(), 0.002))
    gt = D.brute_force_range(x, q, radius, device=device)
    res, st = range_search(seg.view, q, radius, seg.params.search,
                           device=device)
    out.update(radius=radius, range_ids=res, range_stats=st,
               ap=average_precision(res, gt),
               range_mean_io=float(np.mean([s.block_reads for s in st])))
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = check_device(args.device, "quickstart")
    card = device_line(device)

    print("== Starling quickstart ==")
    x, q, truth = data(device)

    print("building segment (graph + BNF shuffle + nav graph + PQ) ...")
    seg = build_segment(x, SEGMENT_BENCH, device=device)
    print(f"  vectors={seg.num_vectors}  OR(G)={seg.overlap_ratio:.3f}")
    print(f"  memory={seg.memory_bytes()/1e6:.1f}MB  "
          f"disk={seg.disk_bytes()/1e6:.1f}MB  budget ok="
          f"{seg.check_budget()}")
    for k, v in seg.build_times.items():
        print(f"  {k:16s} {v:6.2f}s")

    r = search(seg, x, q, truth, device)
    print("\n-- ANNS (top-10) --")
    print(f"starling  recall={r['recall']:.3f} mean_io={r['mean_io']:.1f} "
          f"xi={r['xi']:.3f} "
          f"modeled_latency(NVMe model)={r['latency_us']:.0f}us")
    print(f"baseline  recall={r['base_recall']:.3f} "
          f"mean_io={r['base_mean_io']:.1f} xi={r['base_xi']:.3f} "
          f"modeled_latency(NVMe model)={r['base_latency_us']:.0f}us")
    print(f"==> I/O reduction {r['base_mean_io'] / r['mean_io']:.2f}x, "
          f"modeled speedup {r['base_latency_us'] / r['latency_us']:.2f}x")
    print(f"starling search wall {r['search_s'] * 1e3:.3f} ms for "
          f"{q.shape[0]} queries on {device.type} ({card})")

    print("\n-- Range search --")
    print(f"AP={r['ap']:.3f} mean_io={r['range_mean_io']:.1f}")
    r.update(seg=seg, x=x, q=q, truth=truth)
    return r


if __name__ == "__main__":
    main()
