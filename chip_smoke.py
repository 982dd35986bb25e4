#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # one CUDA card; exits non-zero without

It drives the port's main path — the batched device search as
``SegmentServer.search`` serves it — on a synthetic 1,000,000 x 128
segment made from a seed (``data.synthetic.synthetic_segment``), and
checks it:

  1. card: name and power limit (``nvidia-smi``);
  2. build: compiles the round kernels from ``kernels/csrc``;
  3. segment: builds the segment on the card, with the 10% tier-0 pack;
  4. kernels: each CUDA kernel against its plain PyTorch version on the
     inputs of a real first round of a 1,024-query batch (integer
     outputs equal, distances within atol 1e-4 / rtol 1e-5, the order
     equal to a stable argsort of the kernel's own selection key), and
     each timed with CUDA events next to its plain version;
  5. serve: one warm-up batch, then 8 batches of 1,024 queries, k=10,
     with recall@10 against a brute-force oracle and the launch counts
     (which must follow the rounds); then one batch on the two-pass
     union path (``fuse_union=False``, which runs ``gather_unique``);
  6. kernel path against plain path: one batch with ``fetch_impl="ref"``
     (recall within ±0.01 of the kernel path);
  7. profile: one batch under ``torch.profiler`` — device busy time, the
     idle share of the batch, the ops that take the device time;
  8. summary: one JSON line of the kernels, the card line, and last
     ``{"ok": true, "device": {...}}``.

Every served batch is checked: 10 distinct ids per query with ascending
distances, each the exact distance of its id. recall@10 is printed, not
bounded: the synthetic graph is a stand-in, not a built index.

Any failed check exits non-zero. ``--device cpu --n 20000`` rehearses the
whole script on the CPU with the plain versions (for rehearsal only).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (data sheet)
F32_OPS_PER_S = 67e12           # H100 SXM f32 outside the tensor cores
DIM, BATCH, BATCHES = 128, 1024, 8   # SIFT1M width; 8 batches of 1,024
ITERS = 50                           # launches per kernel timing
SRC = "src/repro_torch/kernels/csrc/tier0_fetch.cu"
REPLACES = {"gather_union": "src/repro/kernels/tier0_fetch.py:257",
            "fused_round_rank": "src/repro/kernels/tier0_fetch.py:401",
            "gather_unique": "src/repro/kernels/tier0_fetch.py:167"}


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


@contextlib.contextmanager
def phase(name: str):
    print(f"== {name}", flush=True)
    t0 = time.perf_counter()
    yield
    print(f"== {name}: {time.perf_counter() - t0:.3f} s", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_ms(fn, device, iters: int, flush=None) -> float:
    """Mean ms of ``fn()``: CUDA events around each call, with the L2
    flushed before each (the round's blocks are cold in L2 when the
    search asks for them); host clock on the CPU."""
    for _ in range(3):
        fn()
    sync(device)
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    pairs = []
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        pairs.append((e0, e1))
    torch.cuda.synchronize(device)
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def recall(pred: np.ndarray, truth: np.ndarray) -> float:
    hits = sum(len(set(p[p >= 0].tolist()) & set(t.tolist()))
               for p, t in zip(pred, truth))
    return hits / truth.size


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cpu only to rehearse with the plain versions")
    ap.add_argument("--n", type=int, default=1_000_000,
                    help="segment size; smaller only to rehearse")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if args.device == "cuda" and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "src"))
    from repro_torch.core import device_search as DS
    from repro_torch.core.params import (SEGMENT_BENCH_DEVICE,
                                         SERVE_DEVICE_SEARCH)
    from repro_torch.core.segment import segment_from_arrays
    from repro_torch.data.synthetic import synthetic_segment
    from repro_torch.data.vectors import query_set
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import tier0_fetch as T0
    from repro_torch.serving.coordinator import SegmentServer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(args.device)
    on_card = device.type == "cuda"

    with phase("1 card"):
        card = card_line() if on_card else "cpu rehearsal"
        print(f"card: {card}")
        if on_card:
            print(f"torch {torch.__version__} cuda {torch.version.cuda} "
                  f"devices {torch.cuda.device_count()}")

    with phase("2 build kernels"):
        if on_card:
            t0 = time.perf_counter()
            libs = _build.build()
            _build.load("tier0_fetch")
            print(f"built {sorted(libs)} in "
                  f"{time.perf_counter() - t0:.3f} s")
        else:
            print("skipped: the CPU rehearsal runs the plain versions")

    with phase("3 segment"):
        times = {}
        arrays = synthetic_segment(args.n, DIM, args.seed, device,
                                   times=times)
        for k, v in times.items():
            print(f"  {k}: {v:.3f}")
        seg = segment_from_arrays(arrays, SEGMENT_BENCH_DEVICE)
        t0 = time.perf_counter()
        ds = DS.from_segment(seg, device=device)
        sync(device)
        print(f"  from_segment_s: {time.perf_counter() - t0:.3f}")
        nb = ds.nbytes()
        for k, v in nb.items():
            print(f"  {k}: {v} B")
        print(f"  device total: {sum(nb.values())} B; n={args.n} "
              f"rho={seg.num_blocks} eps={seg.vid.shape[1]} "
              f"hot={len(DS.hot_pack_blocks(ds))}")
        # the vectors in id order, for the queries and the oracle
        valid = seg.vid >= 0
        x = np.empty((seg.num_vectors, DIM), np.float32)
        x[seg.vid[valid]] = seg.vecs[valid]
        del arrays

    p = SERVE_DEVICE_SEARCH
    nq = BATCH
    queries = query_set(x, nq * (BATCHES + 3), seed=1)
    batches = [queries[i * nq:(i + 1) * nq]
               for i in range(BATCHES + 3)]
    kern = {}

    with phase("4 kernels against plain versions"):
        q0 = torch.as_tensor(batches[0], device=device)
        q0, _, st = DS.initial_state(ds, q0, p)
        fw = p.fetch_width
        u, _ = DS.pick_candidates(st["cand_id"], st["open_key"], fw)
        eps = ds.vid.shape[1]
        n_expand = DS.expansions(eps, fw, p.sigma)
        bq = T0.BQ
        b = ds.block_of[u.long().clamp_min(0)]
        r = b.numel()
        flush = (torch.empty(2 ** 27, dtype=torch.int32, device=device)
                 if on_card else None)               # 512 MB > L2
        args_g = (ds.vecs, ds.vid, ds.nbrs)

        got = T0.gather_union(b, *args_g)
        want = ref.gather_union_ref(b, *args_g)
        for name, g, w in zip(("uniq", "rank2d", "tiles", "vid", "nbrs"),
                              got, want):
            check(torch.equal(g, w), f"gather_union {name} differs")
        uniq, rank2d, tv, ti, tn = want
        ndist = int(torch.unique(b).numel())
        payload = eps * (DIM + 1 + ds.nbrs.shape[2]) * 4
        out_rows = r * payload
        kern["gather_union"] = {
            "max_abs_err": 0.0,
            "bytes": r * 4 + ndist * payload + 2 * r * 4 + out_rows,
            "ops": 0,
            "ms": time_ms(lambda: T0.gather_union(b, *args_g), device,
                          ITERS, flush),
            "plain_ms": time_ms(lambda: ref.gather_union_ref(b, *args_g),
                                device, ITERS, flush),
            "library_ms": time_ms(lambda: torch.unique(
                b.reshape(-1), sorted=True, return_inverse=True), device,
                ITERS, flush)}

        got = T0.gather_unique(uniq, *args_g)
        want = ref.gather_unique_ref(uniq, *args_g)
        for name, g, w in zip(("tiles", "vid", "nbrs"), got, want):
            check(torch.equal(g, w), f"gather_unique {name} differs")
        kern["gather_unique"] = {
            "max_abs_err": 0.0,
            "bytes": r * 4 + ndist * payload + out_rows,
            "ops": 0,
            "ms": time_ms(lambda: T0.gather_unique(uniq, *args_g), device,
                          ITERS, flush),
            "plain_ms": time_ms(lambda: ref.gather_unique_ref(
                uniq, *args_g), device, ITERS, flush),
            "library_ms": None}

        hot = (ds.hot_slot_of, ds.hot_vecs, ds.hot_vid, ds.hot_nbrs)
        u_idle = u.clone()
        u_idle[-bq:] = -1                      # one all-idle tile too
        err = 0.0
        for case in (u, u_idle):
            rargs = (q0, case, rank2d, uniq, *hot, tv, ti, tn, n_expand)
            dd, vid, nbrs, hit, order = T0.fused_round_rank(*rargs, bq=bq)
            w = ref.fused_round_rank_ref(*rargs, bq=bq)
            for name, g, ww in zip(("vid", "nbrs", "hit"), (vid, nbrs, hit),
                                   w[1:4]):
                check(torch.equal(g, ww), f"fused_round_rank {name} differs")
            check(torch.allclose(dd, w[0], atol=1e-4, rtol=1e-5),
                  "fused_round_rank dd outside atol 1e-4 / rtol 1e-5")
            err = max(err, float((dd - w[0]).abs().max()))
            _, own = ref.selection_order(dd, vid, case, n_expand)
            live = torch.repeat_interleave(
                (case >= 0).reshape(-1, bq * fw).any(1), bq)
            own = torch.where(live[:, None], own, torch.zeros_like(own))
            check(torch.equal(order, own),
                  "fused_round_rank order is not the stable argsort of "
                  "its own selection key")
            print(f"  rank: order equal to the plain order on "
                  f"{float((order == w[4]).all(1).float().mean()):.4f} "
                  f"of rows; idle rows {int((~live).sum())}")
        rargs = (q0, u, rank2d, uniq, *hot, tv, ti, tn, n_expand)
        fe = fw * eps
        kern["fused_round_rank"] = {
            "max_abs_err": err,
            "bytes": (nq * DIM * 4 + 3 * r * 4 + ndist * (payload + 4)
                      + nq * fe * (2 + ds.nbrs.shape[2]) * 4
                      + nq * (fw + n_expand) * 4),
            "ops": 3 * nq * fe * DIM,
            "ms": time_ms(lambda: T0.fused_round_rank(*rargs, bq=bq),
                          device, ITERS, flush),
            "plain_ms": time_ms(lambda: ref.fused_round_rank_ref(
                *rargs, bq=bq), device, ITERS, flush),
            "library_ms": None}
        for name, k in kern.items():
            k["bound_ms"] = max(k["bytes"] / HBM_BYTES_PER_S,
                                k["ops"] / F32_OPS_PER_S) * 1e3
            k["bound_by"] = ("bytes" if k["bytes"] / HBM_BYTES_PER_S
                             >= k["ops"] / F32_OPS_PER_S else "operations")
            print(f"  {name}: ms={k['ms']:.6f} plain_ms={k['plain_ms']:.6f}"
                  f" bound_ms={k['bound_ms']:.6f} library_ms="
                  f"{k['library_ms']} max_abs_err={k['max_abs_err']:.3e} "
                  f"(R={r}, distinct={ndist})")
        del flush

    with phase("5 serve"):
        srv = SegmentServer(segment=ds, offset=0,
                            num_vectors=seg.num_vectors, params=p,
                            device=args.device)
        def oracle(qb):
            qt = torch.as_tensor(qb, device=device)
            d = xx[None, :] - 2.0 * (qt @ xt.T)
            return torch.topk(d, 10, dim=1, largest=False).indices.cpu(
                ).numpy()

        def serve(qb, server):
            sync(device)
            t0 = time.perf_counter()
            ids, dists, _ = server.search(qb, 10)
            sync(device)
            return ids, dists, (time.perf_counter() - t0) * 1e3

        def check_results(qb, ids, dists):
            """Shape, finiteness, ascending distances, no repeated id,
            and each distance the exact one of its id (f32 sums in
            another order: rtol 1e-4, atol 1e-3)."""
            check(ids.shape == (nq, 10) and dists.shape == (nq, 10),
                  f"result shapes {ids.shape} {dists.shape}")
            check(bool((ids >= 0).all() and np.isfinite(dists).all()),
                  "a query returned fewer than 10 results")
            check(bool((np.diff(dists, axis=1) >= 0).all()),
                  "distances are not ascending")
            check(all(len(set(r.tolist())) == 10 for r in ids),
                  "a query returned an id twice")
            qt = torch.as_tensor(qb, device=device)
            it = torch.as_tensor(ids, device=device).long()
            exact = torch.sum(torch.square(xt[it] - qt[:, None, :]), dim=-1)
            check(torch.allclose(torch.as_tensor(dists, device=device),
                                 exact, rtol=1e-4, atol=1e-3),
                  "returned distances are not the ids' exact distances")

        serve(batches[0], srv)                       # warm-up
        if on_card:
            torch.cuda.reset_peak_memory_stats(device)
        T0.reset_launches()
        rounds, served, lat = [], [], []
        for i in range(1, BATCHES + 1):
            ids, dists, ms = serve(batches[i], srv)
            st = srv.batch_stats()
            rounds.append(st["rounds"])
            served.append((ids, dists))
            lat.append(ms)
            print(f"  batch {i}: {ms:.3f} ms, {nq / ms * 1e3:.1f} QPS, "
                  f"rounds {st['rounds']}, io {st['io'].mean():.3f}, "
                  f"tier0_hits {st['tier0_hits'].mean():.3f}, "
                  f"dedup_saved {st['dedup_saved'].mean():.3f} per query")
        launches = dict(T0.LAUNCHES)
        print(f"  batch ms median {np.median(lat):.3f} max {max(lat):.3f}"
              f" ({BATCHES} batches); QPS at the median "
              f"{nq / np.median(lat) * 1e3:.1f}; ms per round "
              f"{sum(lat) / sum(rounds):.3f}")
        if on_card:
            print(f"  max_memory_allocated "
                  f"{torch.cuda.max_memory_allocated(device)} B")
        xt = torch.as_tensor(x, device=device)
        xx = torch.sum(xt * xt, dim=1)
        truth = []
        for i, (ids, dists) in enumerate(served, start=1):
            check_results(batches[i], ids, dists)
            truth.append(oracle(batches[i]))
        rec = recall(np.concatenate([s[0] for s in served]),
                     np.concatenate(truth))
        print(f"  recall@10 {rec:.4f} over {nq * BATCHES} queries "
              f"(synthetic stand-in graph)")
        print(f"  launches {launches}, rounds {sum(rounds)}")
        if on_card:
            check(launches["gather_union"] == sum(rounds) > 0
                  and launches["fused_round_rank"] == sum(rounds),
                  "main-path launches do not follow the rounds")

        # the two-pass union path on the next batch
        srv2 = dataclasses.replace(
            srv, params=dataclasses.replace(p, fuse_union=False))
        ids_f, _, _ = serve(batches[BATCHES + 1], srv)
        T0.reset_launches()
        ids_2, _, ms = serve(batches[BATCHES + 1], srv2)
        r2 = srv2.batch_stats()["rounds"]
        for name, v in T0.LAUNCHES.items():
            launches[name] = launches[name] or v
        print(f"  two-pass union batch: {ms:.3f} ms, rounds {r2}, "
              f"launches {dict(T0.LAUNCHES)}")
        check(np.array_equal(ids_f, ids_2),
              "fuse_union=False changed the ids")
        if on_card:
            check(T0.LAUNCHES["gather_unique"] == r2 > 0
                  and T0.LAUNCHES["gather_union"] == 0,
                  "two-pass launches do not follow the rounds")

    with phase("6 kernel path against plain path"):
        qb = batches[BATCHES + 2]
        srv_ref = dataclasses.replace(
            srv, params=dataclasses.replace(p, fetch_impl="ref"))
        ids_k, d_k, ms_k = serve(qb, srv)
        ids_r, d_r, ms_r = serve(qb, srv_ref)
        check_results(qb, ids_k, d_k)
        check_results(qb, ids_r, d_r)
        t = oracle(qb)
        rk, rr = recall(ids_k, t), recall(ids_r, t)
        agree = float((ids_k == ids_r).all(1).mean())
        print(f"  kernel path {ms_k:.3f} ms recall {rk:.4f}; plain path "
              f"{ms_r:.3f} ms recall {rr:.4f}; ids agree on {agree:.4f} "
              f"of queries")
        check(abs(rk - rr) <= 0.01, "kernel and plain recall differ "
              "by more than 0.01")

    with phase("7 profile one batch"):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if on_card:
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            _, _, ms = serve(qb, srv)
        rows = prof.key_averages()
        busy_ms = sum(getattr(e, "self_device_time_total", 0)
                      for e in rows) / 1e3
        print(f"  wall {ms:.3f} ms (profiled), device busy {busy_ms:.3f} ms"
              + (f", idle share {1 - busy_ms / ms:.4f}" if on_card
                 else " (not measured on the CPU)"))
        for what, key in (("device", lambda e: getattr(
                e, "self_device_time_total", 0)),
                ("host", lambda e: e.self_cpu_time_total)):
            print(f"  top ops by {what} time:")
            for e in sorted(rows, key=lambda e: -key(e))[:8]:
                print(f"    {e.key[:56]:56s} calls {e.count:6d} device "
                      f"{getattr(e, 'self_device_time_total', 0) / 1e3:9.3f}"
                      f" ms host {e.self_cpu_time_total / 1e3:9.3f} ms")

    out = []
    for name in ("gather_union", "fused_round_rank", "gather_unique"):
        k = kern[name]
        out.append({"name": name, "route": "cuda", "source": SRC,
                    "replaces": REPLACES[name],
                    "launches": launches[name],
                    "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                    "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                    "bound_by": k["bound_by"],
                    "library_ms": k["library_ms"], "ok": True})
    print(json.dumps({"kernels": out}))
    print(card)
    if on_card:
        kind = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": torch.cuda.device_count()}
    else:
        kind = {"platform": "cpu", "kind": "cpu rehearsal", "count": 0}
    print(json.dumps({"ok": True, "device": kind}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
