"""The port's multi-rank search step (``repro_torch.core.device_search.
make_search_step``) against the JAX package's on the CPU.

* The argument specs equal JAX's sharded ``ShapeDtypeStruct``s (shape,
  dtype, spec, per-rank shape) at the production defaults on both
  production meshes (JAX's from an ``AbstractMesh``) and at a small size.
* ``fn`` on a world of 1 (a gloo group in this process) equals the plain
  ``device_anns``.
* ``fn`` on 8 gloo ranks, a ``(2, 4)`` ``("data", "model")`` mesh of
  spawned processes, over 4 shape-identical integer-valued segments
  (``tests/test_torch_router.py``'s ``mesh_int`` data: every f32
  distance exact) equals JAX's ``fn`` under ``shard_map`` on 8 forced
  host devices (a subprocess) bit for bit in ``gid``, dists and the
  seven per-rank columns, and equals the one-card router's ``_step``
  over the same segments and rows, run in rank 0 after the step.
* A rank that raises fails the run within its deadline.

Spawned ranks import this module, so its top level imports no JAX; the
JAX package is imported inside the functions that use it.
"""
import dataclasses
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from test_torch_sharding import (FakeMesh, init_rank, spawn_ranks,
                                 world_of_one)

N_SEG, N_PER_SEG, DIM, Q = 4, 600, 32, 16
MESH = (2, 4)
DEADLINE_S = 240
# the router test's serving knobs (SERVE_DEVICE_SEARCH at Γ = 48); JAX
# runs the jnp round stage, the port its plain one ("ref")
SEARCH = dict(candidates=48, max_hops=128, fetch_width=2,
              compact_frac=0.25)
OUTS = ("gid", "dists", "io", "hops", "tier0_hits", "dedup_saved",
        "dedup_cross", "spec_hits", "spec_wasted")


def _tsearch():
    from repro_torch.serving.coordinator import SERVE_DEVICE_SEARCH
    return dataclasses.replace(SERVE_DEVICE_SEARCH, fetch_impl="ref",
                               **SEARCH)


def _jsearch():
    from repro.serving.coordinator import SERVE_DEVICE_SEARCH
    return dataclasses.replace(SERVE_DEVICE_SEARCH, fetch_impl="jnp",
                               **SEARCH)


def _queries(xs):
    from repro_torch.data.vectors import query_set
    return np.round(query_set(np.concatenate(xs), Q, seed=7)).astype(
        np.float32)


def _tsegments(seg_dir):
    from repro_torch.core import device_search as TDS
    from repro_torch.core.segment import load_segment
    segs = [load_segment(os.path.join(seg_dir, f"seg{s}.npz"))
            for s in range(N_SEG)]
    return segs, [TDS.from_segment(s, tier0_frac=0.1, device="cpu")
                  for s in segs]


# ------------------------------------------------------------------ specs

def _jspecs(jmesh, **kw):
    import repro.core  # noqa: F401  (the JAX package's import order)
    from repro.core.device_search import make_search_step
    from repro.launch.mesh import rules_for
    _, (seg, q) = make_search_step(jmesh, rules_for(jmesh), **kw)
    return seg, q


def _same_spec(t, j, name):
    from repro_torch.distributed.sharding import placements
    assert t.shape == tuple(j.shape), name
    assert str(t.dtype).replace("torch.", "") == str(j.dtype), name
    assert tuple(t.spec) == tuple(j.sharding.spec), name
    assert t.local_shape == tuple(j.sharding.shard_shape(j.shape)), name
    assert t.placements == placements(t.spec, j.sharding.mesh), name


@pytest.mark.parametrize("mesh_shape", [
    {"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
    {"data": 2, "model": 4}, {"pod": 2, "data": 2, "model": 2}])
@pytest.mark.parametrize("size", ["production", "small"])
def test_specs_equal_jax(mesh_shape, size):
    """The specs of ``make_search_step`` equal JAX's, field by field."""
    import jax
    from repro_torch.core import device_search as TDS
    from repro_torch.launch.mesh import rules_for
    kw = {} if size == "production" else dict(
        n_local=4096, dim=32, eps=8, lam=15, q_global=64, pq_m=8, pq_k=16,
        nav_frac=16, nav_deg=8)
    jmesh = jax.sharding.AbstractMesh(tuple(mesh_shape.values()),
                                      tuple(mesh_shape))
    jseg, jq = _jspecs(jmesh, **kw)
    mesh = FakeMesh(mesh_shape)
    _, (tseg, tq) = TDS.make_search_step(mesh, rules_for(mesh), **kw)
    for f in dataclasses.fields(TDS.DeviceSegment):
        _same_spec(getattr(tseg, f.name), getattr(jseg, f.name), f.name)
    _same_spec(tq, jq, "queries")
    if size == "production":
        # 2M vectors of BIGANN's eps = 16 on each model rank, in bf16
        assert tseg.vecs.local_shape == (1, 131072, 16, 128)
        assert tseg.vecs.local_nbytes == 131072 * 16 * 128 * 2


# -------------------------------------------------------- a world of one

@pytest.fixture(scope="module")
def int_segments(tmp_path_factory):
    """Four shape-identical segments of integer-valued vectors, built by
    the JAX package and saved for the port, the subprocess and the
    ranks (the ``mesh_int`` data of ``tests/test_torch_router.py``)."""
    import repro.core  # noqa: F401
    from repro.core.segment import build_segment, save_segment
    from repro.data.vectors import clustered_vectors
    from tests.conftest import SMALL_SEGMENT
    seg_dir = tmp_path_factory.mktemp("step_segments")
    xs = []
    for s in range(N_SEG):
        x = clustered_vectors(N_PER_SEG, DIM, num_clusters=8, seed=30 + s)
        x = np.round(x * 8).astype(np.float32)
        save_segment(build_segment(x, SMALL_SEGMENT),
                     str(seg_dir / f"seg{s}.npz"))
        xs.append(x)
    q = _queries(xs)
    np.save(seg_dir / "queries.npy", q)
    return str(seg_dir), q


def test_world_of_one_equals_device_anns(int_segments, tmp_path):
    """On a (1, 1) mesh the step is ``device_anns`` plus a trivial
    gather: every output equals it."""
    from repro_torch.core import device_search as TDS
    from repro_torch.launch.mesh import rules_for
    seg_dir, q = int_segments
    _, dsegs = _tsegments(seg_dir)
    p = _tsearch()
    with world_of_one(tmp_path, (1, 1), ("data", "model")) as mesh:
        fn, _ = TDS.make_search_step(mesh, rules_for(mesh),
                                     n_local=N_PER_SEG, search=p)
        out = fn(TDS.stack_segments([dsegs[2]]), torch.as_tensor(q))
    r = TDS.device_anns(dsegs[2], torch.as_tensor(q), p)
    want = (r.ids, r.dists, r.io, r.hops, r.tier0_hits, r.dedup_saved,
            r.dedup_cross, r.spec_hits, r.spec_wasted)
    for name, g, w in zip(OUTS, out, want):
        assert torch.equal(g.reshape(w.shape), w), name
    assert all(o.shape == (Q, 1) for o in out[2:])


# ------------------------------------------------------------ 8 ranks

def _step_rank(rank, store, seg_dir, out_dir):
    """One rank of the (2, 4) mesh: its segment shard and rows through
    ``fn``; rank 0 then runs the one-card router over all segments on
    each data half's rows."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.core import device_search as TDS
    from repro_torch.launch.mesh import make_debug_mesh, rules_for
    from repro_torch.serving.coordinator import SegmentServer
    from repro_torch.serving.router import MeshQueryRouter
    init_rank(rank, 8, store)
    try:
        mesh = init_device_mesh("cpu", MESH,
                                mesh_dim_names=("data", "model"))
        d, m = mesh.get_coordinate()
        segs, dsegs = _tsegments(seg_dir)
        q = np.load(os.path.join(seg_dir, "queries.npy"))
        rows = Q // MESH[0]
        stacked = TDS.stack_segments(dsegs)
        local = TDS.DeviceSegment(**{
            f.name: getattr(stacked, f.name)[m:m + 1]
            for f in dataclasses.fields(TDS.DeviceSegment)})
        p = _tsearch()
        fn, _ = TDS.make_search_step(mesh, rules_for(mesh),
                                     n_local=N_PER_SEG, search=p)
        out = fn(local, torch.as_tensor(q[d * rows:(d + 1) * rows]))
        res = {name: o.numpy() for name, o in zip(OUTS, out)}
        res["coord"] = np.asarray([d, m])
        if rank == 0:
            servers = [SegmentServer(segment=ds, offset=s * N_PER_SEG,
                                     num_vectors=N_PER_SEG, params=p,
                                     host=segs[s], device="cpu")
                       for s, ds in enumerate(dsegs)]
            router = MeshQueryRouter(servers,
                                     mesh=make_debug_mesh(1, N_SEG))
            for h in range(MESH[0]):
                qh = q[h * rows:(h + 1) * rows]
                got = router._step(qh, router._rank_meta(rows), p.k)
                for name, v in zip(OUTS, got):
                    res[f"router{h}_{name}"] = v
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    finally:
        dist.destroy_process_group()


def _jax_side(seg_dir, out_path):
    """JAX's step under ``shard_map`` on a (2, 4) mesh of 8 host
    devices over the same segments and queries; npz out."""
    import jax
    import jax.numpy as jnp
    import repro.core  # noqa: F401
    from repro.core import device_search as JDS
    from repro.core.segment import load_segment
    from repro.launch.mesh import rules_for
    from tests.conftest import SMALL_SEGMENT
    assert jax.device_count() == 8, jax.device_count()
    segs = [JDS.from_segment(load_segment(
        os.path.join(seg_dir, f"seg{s}.npz"), SMALL_SEGMENT),
        tier0_frac=0.1) for s in range(N_SEG)]
    q = np.load(os.path.join(seg_dir, "queries.npy"))
    mesh = jax.make_mesh(MESH, ("data", "model"))
    fn, _ = JDS.make_search_step(mesh, rules_for(mesh), n_local=N_PER_SEG,
                                 search=_jsearch())
    out = fn(JDS.stack_segments(segs), jnp.asarray(q))
    np.savez(out_path, **{name: np.asarray(o) for name, o in zip(OUTS, out)})


def _jax_env():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(root, "src"), root, os.path.join(root, "tests")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    return env


@pytest.fixture(scope="module")
def step_runs(int_segments, tmp_path_factory):
    """JAX's step in a subprocess and the port's on 8 spawned ranks, run
    side by side; both results read back."""
    seg_dir, _ = int_segments
    out = tmp_path_factory.mktemp("step_runs")
    jax_out = str(out / "jax.npz")
    jproc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "jax-step", seg_dir,
         jax_out], env=_jax_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        spawn_ranks(_step_rank, 8, (str(out / "store"), seg_dir, str(out)),
                    DEADLINE_S)
        _, err = jproc.communicate(timeout=DEADLINE_S)
    finally:
        if jproc.poll() is None:
            jproc.kill()
            jproc.communicate()
    assert jproc.returncode == 0, err[-3000:]
    ranks = [dict(np.load(out / f"rank{r}.npz")) for r in range(8)]
    return dict(np.load(jax_out)), ranks


def _assemble(ranks):
    """The ranks' outputs as JAX's global arrays: merged [Q, k] rows by
    data coordinate, per-rank columns [Q, 4] by (data, model)."""
    rows = Q // MESH[0]
    glob = {}
    by = {tuple(r["coord"]): r for r in ranks}
    for name in OUTS[:2]:
        glob[name] = np.concatenate([by[(d, 0)][name]
                                     for d in range(MESH[0])])
        for (d, m), r in by.items():   # every model rank merged the same
            np.testing.assert_array_equal(r[name], by[(d, 0)][name])
    for name in OUTS[2:]:
        col = np.zeros((Q, MESH[1]), np.int32)
        for (d, m), r in by.items():
            col[d * rows:(d + 1) * rows, m] = r[name][:, 0]
        glob[name] = col
    return glob


def test_step_on_8_ranks_equals_jax_step(step_runs):
    """gid, dist bits and the seven per-rank columns equal JAX's
    ``shard_map`` step on 8 host devices."""
    want, ranks = step_runs
    got = _assemble(ranks)
    for name in OUTS:
        assert got[name].dtype == want[name].dtype, name
        if got[name].dtype == np.float32:
            np.testing.assert_array_equal(got[name].view(np.int32),
                                          want[name].view(np.int32),
                                          err_msg=name)
        else:
            np.testing.assert_array_equal(got[name], want[name],
                                          err_msg=name)
    assert (got["gid"] >= 0).all()
    assert set(np.unique(got["gid"] // N_PER_SEG)) == set(range(N_SEG))


def test_step_on_8_ranks_equals_one_card_router(step_runs):
    """The same outputs as the one-card ``MeshQueryRouter._step`` over
    the four segments (one rank each), on each data half's rows."""
    _, ranks = step_runs
    got = _assemble(ranks)
    r0 = next(r for r in ranks if tuple(r["coord"]) == (0, 0))
    rows = Q // MESH[0]
    for name in OUTS:
        want = np.concatenate([r0[f"router{h}_{name}"]
                               for h in range(MESH[0])])
        if want.dtype == np.float32:
            np.testing.assert_array_equal(got[name].view(np.int32),
                                          want.view(np.int32), err_msg=name)
        else:
            np.testing.assert_array_equal(got[name], want, err_msg=name)
    assert rows * MESH[0] == Q


# --------------------------------------------------- a rank that raises

def _raising_rank(rank, store):
    """Rank 1 raises before the collective; rank 0 waits in it."""
    init_rank(rank, 2, store)
    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    dist.all_reduce(torch.zeros(4))


def _hanging_rank(rank):
    time.sleep(600)


def test_rank_that_raises_fails_within_deadline(tmp_path):
    """A rank that raises fails the run (its error, or its peer's broken
    collective, reaches the parent) well before the group's 60 s
    timeout; a rank that hangs is killed at the deadline."""
    import torch.multiprocessing as mp
    t0 = time.monotonic()
    with pytest.raises(mp.ProcessRaisedException,
                       match="rank 1 fails on purpose|Connection"):
        spawn_ranks(_raising_rank, 2, (str(tmp_path / "store"),), 45)
    assert time.monotonic() - t0 < 45
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="still running after 10 s"):
        spawn_ranks(_hanging_rank, 1, (), 10)
    assert time.monotonic() - t0 < 30


if __name__ == "__main__" and sys.argv[1:2] == ["jax-step"]:
    _jax_side(*sys.argv[2:4])
