"""The port's sharding rules, meshes and int8 all-reduce
(``repro_torch.distributed.{sharding,compress}``, ``launch.mesh``)
against the JAX package on the CPU.

In this process: the rule dicts, ``logical_spec`` over a seeded grid and
the replays of ``tests/test_distributed.py``, ``use_rules``, ``shard``
without rules, ``param_sharding_tree``, ``make_production_mesh``'s error,
``rules_for`` on every mesh kind, and ``compress``'s pieces bit for bit.

Across ranks: 8 gloo processes (``torch.multiprocessing`` spawn, a
``file://`` store under ``tmp_path``, a 60 s group timeout, joined
against the test's own deadline) build a ``(2, 4)`` ``("data",
"model")`` and a ``(2, 2, 2)`` ``("pod", "data", "model")`` mesh. Each
rank's local shard from ``shard`` must equal the slice JAX's
``NamedSharding(mesh, spec).devices_indices_map`` gives the device at
the same mesh coordinates, and ``compressed_psum`` over ``data`` must
equal JAX's under ``shard_map`` bit for bit (JAX on 8 forced host
devices in a subprocess, run beside the spawn).

Spawned ranks import this module, so its top level imports no JAX; the
JAX package is imported inside the functions that use it.
"""
import contextlib
import datetime
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.distributed import compress as TC
from repro_torch.distributed import sharding as TS
from repro_torch.launch import mesh as TM

RULE_SETS = ("SINGLE_POD_RULES", "MULTI_POD_RULES", "SEGMENT_SERVE_RULES")
DEADLINE_S = 240


class FakeMesh:
    """``tests/test_distributed.py``'s: a shape dict and axis names."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


# ------------------------------------------------- multi-rank harness

def init_rank(rank: int, world: int, store: str) -> None:
    """A spawned rank's set-up: one thread, a gloo group on the file
    store, a 60 s timeout on every collective."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))


def spawn_ranks(fn, nprocs: int, args: tuple, deadline_s: float) -> None:
    """Run ``fn(rank, *args)`` in ``nprocs`` spawned processes and join
    them against ``deadline_s``: a rank that raises re-raises here (its
    peers are terminated), and past the deadline every rank is killed
    and ``TimeoutError`` raised."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(fn, args=args, nprocs=nprocs, join=False,
                             start_method="spawn")
    end = time.monotonic() + deadline_s
    try:
        while not ctx.join(timeout=1):
            if time.monotonic() > end:
                raise TimeoutError(f"{nprocs} ranks still running after "
                                   f"{deadline_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
        for p in ctx.processes:
            p.join(10)


@contextlib.contextmanager
def world_of_one(tmp_path, shape, names):
    """A gloo group of one rank in this process and a ``DeviceMesh`` of
    ``shape`` (all ones) on it; the group is destroyed on exit."""
    from torch.distributed.device_mesh import init_device_mesh
    dist.init_process_group("gloo",
                            init_method=f"file://{tmp_path}/world1_store",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        yield init_device_mesh("cpu", shape, mesh_dim_names=names)
    finally:
        dist.destroy_process_group()


# --------------------------------------------------- rules, specs

def test_rule_sets_equal_jax():
    from repro.distributed import sharding as JS
    for name in RULE_SETS:
        assert getattr(TS, name) == getattr(JS, name), name


MESHES = [{"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
          {"data": 2, "model": 4}, {"pod": 2, "data": 2, "model": 2},
          {"data": 1, "model": 8}]
DIMS = (1, 2, 3, 4, 6, 8, 12, 16, 32, 48, 64, 100, 256, 4096)


@pytest.mark.parametrize("rules", RULE_SETS)
@pytest.mark.parametrize("mesh_shape", MESHES,
                         ids=["x".join(map(str, m.values())) for m in MESHES])
def test_logical_spec_grid_equals_jax(rules, mesh_shape):
    """A seeded grid of shapes x logical axes (every rule name, None and
    an unknown name): the specs are equal as tuples (the multi-pod rules
    on a mesh without ``pod`` raise ``KeyError`` in both)."""
    from repro.distributed import sharding as JS

    def spec_or_error(mod, shape, axes):
        try:
            return tuple(mod.logical_spec(shape, axes, getattr(mod, rules),
                                          mesh))
        except KeyError as e:
            return ("KeyError", str(e))
    rng = np.random.default_rng(len(rules) * 31 + len(mesh_shape))
    names = list(getattr(TS, rules)) + [None, "unknown"]
    mesh = FakeMesh(mesh_shape)
    for _ in range(300):
        nd = int(rng.integers(1, 5))
        shape = tuple(int(rng.choice(DIMS)) for _ in range(nd))
        axes = tuple(names[int(rng.integers(len(names)))]
                     for _ in range(nd))
        assert spec_or_error(TS, shape, axes) == spec_or_error(
            JS, shape, axes), (shape, axes)


def test_logical_spec_divisibility_fallback():
    mesh = FakeMesh({"data": 16, "model": 16})
    spec = TS.logical_spec((256, 4096), ("vocab", "fsdp"),
                           TS.SINGLE_POD_RULES, mesh)
    assert spec == TS.PartitionSpec("model", "data")
    spec = TS.logical_spec((4, 100), ("heads", "ff"), TS.SINGLE_POD_RULES,
                           mesh)
    assert spec == TS.PartitionSpec(None, None)


def test_logical_spec_no_axis_reuse():
    mesh = FakeMesh({"data": 16, "model": 16})
    spec = TS.logical_spec((64, 32), ("heads", "ff"), TS.SINGLE_POD_RULES,
                           mesh)
    assert spec == TS.PartitionSpec("model", None)


def test_segment_serve_rules_shard_segment_axis_only():
    mesh = FakeMesh({"data": 1, "model": 8})
    spec = TS.logical_spec((8, 64, 32), ("segment", "block", "dim"),
                           TS.SEGMENT_SERVE_RULES, mesh)
    assert spec == TS.PartitionSpec("model", None, None)
    spec = TS.logical_spec((3, 64), ("segment", "vertex"),
                           TS.SEGMENT_SERVE_RULES, mesh)
    assert spec == TS.PartitionSpec(None, None)


def test_partition_spec_placements():
    """A one-name tuple is the bare name, as in JAX; a dim over two mesh
    axes shards on both mesh dims."""
    from torch.distributed.tensor import Replicate, Shard
    assert TS.PartitionSpec(("data",)) == ("data",)
    mesh = FakeMesh({"pod": 2, "data": 2, "model": 2})
    spec = TS.logical_spec((8, 6, 5), ("batch", "heads", "embed"),
                           TS.MULTI_POD_RULES, mesh)
    assert spec == (("pod", "data"), "model", None)
    assert TS.placements(spec, mesh) == (Shard(0), Shard(0), Shard(1))
    assert TS.placements(TS.PartitionSpec(None, None), mesh) == (
        Replicate(),) * 3


def test_use_rules_restores_after_exception():
    mesh_a, mesh_b = FakeMesh({"data": 2}), FakeMesh({"model": 4})
    assert TS.current_rules() == (None, None)
    with TS.use_rules(TS.SINGLE_POD_RULES, mesh_a):
        with pytest.raises(RuntimeError):
            with TS.use_rules(TS.SEGMENT_SERVE_RULES, mesh_b):
                assert TS.current_rules() == (TS.SEGMENT_SERVE_RULES,
                                              mesh_b)
                raise RuntimeError("inside")
        assert TS.current_rules() == (TS.SINGLE_POD_RULES, mesh_a)
    assert TS.current_rules() == (None, None)


def test_shard_is_a_noop_without_rules():
    x = torch.arange(12.0).reshape(3, 4)
    assert TS.shard(x, "batch", "embed") is x
    TS.set_rules(TS.SINGLE_POD_RULES, None)      # rules without a mesh
    try:
        assert TS.shard(x, "batch", "embed") is x
    finally:
        TS.set_rules(None, None)


def test_param_sharding_tree_equals_jax():
    """A hand-made spec tree (dicts, lists, tuples): the same structure,
    each leaf's placements those of JAX's NamedSharding spec."""
    import jax
    from repro.distributed import sharding as JS

    def ps(shape, axes):
        return SimpleNamespace(shape=shape, axes=axes)
    tree = {"embed": ps((512, 64), ("vocab", "embed")),
            "layers": [ps((64, 256), ("embed", "ff")),
                       ps((4, 64), ("heads", "embed"))],
            "norm": (ps((64,), ("embed",)), ps((16, 8), ("batch", "seq")))}
    shape = {"data": 16, "model": 16}
    jmesh = jax.sharding.AbstractMesh(tuple(shape.values()), tuple(shape))
    want = JS.param_sharding_tree(tree, JS.SINGLE_POD_RULES, jmesh)
    got = TS.param_sharding_tree(tree, TS.SINGLE_POD_RULES,
                                 FakeMesh(shape))
    assert set(got) == set(want)
    pairs = [(got["embed"], want["embed"])]
    pairs += list(zip(got["layers"], want["layers"]))
    pairs += list(zip(got["norm"], want["norm"]))
    assert isinstance(got["layers"], list) and isinstance(got["norm"],
                                                           tuple)
    for g, w in pairs:
        assert g == TS.placements(tuple(w.spec), FakeMesh(shape))


# ---------------------------------------------------------- meshes

def test_make_production_mesh_names_the_world_it_needs(tmp_path):
    with pytest.raises(ValueError, match="256 ranks; none"):
        TM.make_production_mesh(device_type="cpu")
    with pytest.raises(ValueError, match="512 ranks"):
        TM.make_production_mesh(multi_pod=True, device_type="cpu")
    with world_of_one(tmp_path, (1, 1), ("data", "model")):
        with pytest.raises(ValueError, match="256 ranks; it has 1"):
            TM.make_production_mesh(device_type="cpu")
        with pytest.raises(ValueError, match="512 ranks; it has 1"):
            TM.make_production_mesh(multi_pod=True, device_type="cpu")


def test_rules_for_every_mesh_kind(tmp_path):
    """``rules_for`` on a DeviceMesh, a RankLayout and a fake mesh,
    against JAX's on the fake mesh of the same axes."""
    from repro.launch import mesh as JM
    kinds = [(FakeMesh({"data": 16, "model": 16}),
              FakeMesh({"data": 16, "model": 16})),
             (FakeMesh({"pod": 2, "data": 16, "model": 16}),
              FakeMesh({"pod": 2, "data": 16, "model": 16})),
             (TM.make_debug_mesh(2, 4), FakeMesh({"data": 2, "model": 4}))]
    for t_mesh, j_mesh in kinds:
        assert TM.rules_for(t_mesh) == JM.rules_for(j_mesh)
    from torch.distributed.device_mesh import init_device_mesh
    with world_of_one(tmp_path, (1, 1), ("data", "model")) as mesh:
        assert TM.rules_for(mesh) is TS.SINGLE_POD_RULES
        pod = init_device_mesh("cpu", (1, 1, 1),
                               mesh_dim_names=("pod", "data", "model"))
        assert TM.rules_for(pod) is TS.MULTI_POD_RULES
        with TS.use_rules(TM.rules_for(mesh), mesh):
            x = TS.shard(torch.arange(8.0).reshape(4, 2), "batch", "heads")
            assert x.placements == TS.placements(
                TS.logical_spec((4, 2), ("batch", "heads"),
                                TS.SINGLE_POD_RULES, mesh), mesh)
            assert torch.equal(x.to_local(), torch.arange(8.0).reshape(4, 2))


# ---------------------------------------------------------- compress

def _grad_cases():
    """Seeded leaves: normal at three scales, all zeros (the 1e-12
    floor), exact .5 ties (max |g| = 127, so the scale is 1), a bf16
    leaf."""
    rng = np.random.default_rng(3)
    ties = np.array([127.0, 0.5, -0.5, 1.5, -2.5, 3.5, 126.5, -126.5,
                     0.0, 64.5], np.float32)
    return {"normal": rng.standard_normal(1000).astype(np.float32),
            "large": (rng.standard_normal(257) * 1e4).astype(np.float32),
            "tiny": (rng.standard_normal(64) * 1e-9).astype(np.float32),
            "zeros": np.zeros(33, np.float32),
            "ties": ties}


@pytest.mark.parametrize("case", sorted(_grad_cases()))
def test_quantize_bits_equal_jax(case):
    import jax.numpy as jnp
    from repro.distributed import compress as JC
    g = _grad_cases()[case]
    jq, js = JC.quantize(jnp.asarray(g))
    tq, ts = TC.quantize(torch.as_tensor(g))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert tq.dtype == torch.int8
    assert ts.numpy().view(np.int32) == np.asarray(js).view(np.int32)
    np.testing.assert_array_equal(
        TC.dequantize(tq, ts).numpy().view(np.int32),
        np.asarray(JC.dequantize(jq, js)).view(np.int32))
    jb = JC.quantize(jnp.asarray(g, jnp.bfloat16))
    tb = TC.quantize(torch.as_tensor(g).to(torch.bfloat16))
    np.testing.assert_array_equal(tb[0].numpy(), np.asarray(jb[0]))
    assert tb[1].numpy().view(np.int32) == np.asarray(jb[1]).view(np.int32)


def test_compress_with_feedback_bits_equal_jax():
    import jax
    import jax.numpy as jnp
    from repro.distributed import compress as JC
    cases = _grad_cases()
    rng = np.random.default_rng(4)
    grads = {"w": cases["normal"], "b": [cases["ties"], cases["zeros"]],
             "t": (cases["large"], cases["tiny"])}
    errs = {"w": (rng.standard_normal(1000) * 1e-2).astype(np.float32),
            "b": [np.zeros(10, np.float32), np.zeros(33, np.float32)],
            "t": (np.zeros(257, np.float32), np.zeros(64, np.float32))}

    def to(tree, f):
        return TS.tree_map(f, tree)
    je = JC.ef_init(to(grads, jnp.asarray))
    te = TC.ef_init(to(grads, torch.as_tensor))
    for a, b in zip(TC._leaves(te), jax.tree.leaves(je)):
        assert a.dtype == torch.float32 and not a.any()
        assert tuple(a.shape) == b.shape
    want = JC.compress_with_feedback(to(grads, jnp.asarray),
                                     to(errs, jnp.asarray))
    got = TC.compress_with_feedback(to(grads, torch.as_tensor),
                                    to(errs, torch.as_tensor))
    for g_tree, w_tree in zip(got, want):
        g_leaves = TC._leaves(g_tree)
        w_leaves = jax.tree.leaves(w_tree)
        assert len(g_leaves) == len(w_leaves)
        for g, w in zip(g_leaves, w_leaves):
            g, w = np.atleast_1d(g.numpy()), np.atleast_1d(w)
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g.view(np.uint8),
                                          w.view(np.uint8))
    assert isinstance(got[0]["b"], list) and isinstance(got[0]["t"], tuple)


def test_quantize_roundtrip_error_bound():
    rng = np.random.default_rng(0)
    g = torch.as_tensor(rng.standard_normal(1000).astype(np.float32))
    q, s = TC.quantize(g)
    err = (TC.dequantize(q, s) - g).abs()
    assert float(err.max()) <= float(s) * 0.5 + 1e-6


def test_error_feedback_preserves_signal():
    """Sum of dequantized grads + final error == sum of raw grads."""
    rng = np.random.default_rng(1)
    grads = [torch.as_tensor((rng.standard_normal(64) * 10 ** i)
                             .astype(np.float32)) for i in range(3)]
    e = TC.ef_init({"g": grads[0]})["g"]
    total_sent = torch.zeros(64)
    total_true = torch.zeros(64)
    for g in grads:
        qs, ss, es = TC.compress_with_feedback({"x": g}, {"x": e})
        e = es["x"]
        total_sent = total_sent + TC.dequantize(qs["x"], ss["x"])
        total_true = total_true + g
    np.testing.assert_allclose((total_sent + e).numpy(), total_true.numpy(),
                               rtol=1e-5, atol=1e-4)


def test_compressed_psum_world_of_one(tmp_path):
    """The int8 all-reduce on a one-rank mesh (JAX's 1-device
    ``shard_map`` case), and bit for bit the plain formula; the mesh
    comes from ``use_rules`` when none is passed."""
    g = {"w": torch.arange(8, dtype=torch.float32)}
    e = TC.ef_init(g)
    with world_of_one(tmp_path, (1,), ("data",)) as mesh:
        out, new_e = TC.compressed_psum(g, e, "data", mesh)
        with TS.use_rules(TS.SINGLE_POD_RULES, mesh):
            out2, _ = TC.compressed_psum(g, e, "data")
    np.testing.assert_allclose(out["w"].numpy(), np.arange(8), atol=0.05)
    q, s = TC.quantize(g["w"])
    assert torch.equal(out["w"], q.to(torch.float32) * s / 1)
    assert torch.equal(new_e["w"], g["w"] - q.to(torch.float32) * s)
    assert torch.equal(out2["w"], out["w"])
    with pytest.raises(ValueError, match="needs a mesh"):
        TC.compressed_psum(g, e, "data")


# ------------------------------------------------------------ 8 ranks

RANK_MESHES = (("dm", (2, 4), ("data", "model")),
               ("pdm", (2, 2, 2), ("pod", "data", "model")))
# (shape, logical axes, rules, then: the axes of a redistribution or None)
SHARD_CASES = {
    "dm": [((8, 12), ("batch", "heads"), "SINGLE_POD_RULES", None),
           ((6, 16, 3), ("fsdp", "ff", "embed"), "SINGLE_POD_RULES", None),
           ((5, 8), ("batch", "vocab"), "SINGLE_POD_RULES", None),
           ((4, 10, 2), ("segment", "block", "dim"), "SEGMENT_SERVE_RULES",
            None),
           ((8, 7), ("query", "dim"), "SEGMENT_SERVE_RULES", None),
           ((8, 12), ("batch", "heads"), "SINGLE_POD_RULES",
            ("seq", "heads"))],
    "pdm": [((8, 6), ("batch", "heads"), "MULTI_POD_RULES", None),
            ((4, 4, 5), ("fsdp", "kv_seq", "state"), "MULTI_POD_RULES",
             None),
            ((6, 8), ("batch", "ff"), "MULTI_POD_RULES", None),
            ((8, 6), ("batch", "heads"), "SINGLE_POD_RULES", None),
            ((2, 9), ("segment", "vertex"), "SEGMENT_SERVE_RULES", None),
            ((8, 6), ("batch", "heads"), "MULTI_POD_RULES",
             ("seq", "heads"))],
}
PSUM_N = {"w": 300, "ties": 10, "zeros": 33}


def _case_array(shape, i):
    return np.arange(int(np.prod(shape)), dtype=np.float32).reshape(
        shape) * (i + 1)


def _psum_inputs():
    """Per (data, model) coordinate of the (2, 4) mesh: gradients and
    errors. The ties leaf holds exact .5 ties with max |g| = 127 on data
    rank 0, so the all-reduced scale is exactly 1."""
    rng = np.random.default_rng(9)
    g = {"w": rng.standard_normal((2, 4, PSUM_N["w"])).astype(np.float32),
         "ties": np.zeros((2, 4, PSUM_N["ties"]), np.float32),
         "zeros": np.zeros((2, 4, PSUM_N["zeros"]), np.float32)}
    g["ties"][0] = [127.0, 0.5, -0.5, 1.5, -2.5, 3.5, 126.5, -126.5, 0.0,
                    64.5]
    g["ties"][1] = [-100.5, 2.5, 4.5, -0.5, 0.5, 7.5, 1.0, -3.5, 99.5, 8.5]
    e = {"w": (rng.standard_normal((2, 4, PSUM_N["w"])) * 1e-3).astype(
            np.float32),
         "ties": np.zeros((2, 4, PSUM_N["ties"]), np.float32),
         "zeros": np.zeros((2, 4, PSUM_N["zeros"]), np.float32)}
    return g, e


def _psum_tree(leaves):
    return {"w": leaves["w"], "b": (leaves["ties"], [leaves["zeros"]])}


def _sharding_rank(rank, store, out_dir):
    """One rank: the shard cases on both meshes, then the int8 all-reduce
    over ``data`` of the (2, 4) mesh."""
    from torch.distributed.device_mesh import init_device_mesh
    init_rank(rank, 8, store)
    try:
        res = {}
        meshes = {}
        for mname, shape, names in RANK_MESHES:
            mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
            meshes[mname] = mesh
            res[f"{mname}_coord"] = np.asarray(mesh.get_coordinate())
            for i, (shp, axes, rules, then) in enumerate(SHARD_CASES[mname]):
                with TS.use_rules(getattr(TS, rules), mesh):
                    t = TS.shard(torch.as_tensor(_case_array(shp, i)),
                                 *axes)
                    if then is not None:
                        t = TS.shard(t, *then)
                res[f"{mname}_{i}"] = t.to_local().numpy()
                res[f"{mname}_{i}_placements"] = np.asarray(
                    [repr(p) for p in t.placements])
        d, m = meshes["dm"].get_coordinate()
        g, e = _psum_inputs()
        mean, err = TC.compressed_psum(
            _psum_tree({k: torch.as_tensor(v[d, m]) for k, v in g.items()}),
            _psum_tree({k: torch.as_tensor(v[d, m]) for k, v in e.items()}),
            "data", meshes["dm"])
        for tag, tree in (("mean", mean), ("err", err)):
            res[f"psum_{tag}_w"] = tree["w"].numpy()
            res[f"psum_{tag}_ties"] = tree["b"][0].numpy()
            res[f"psum_{tag}_zeros"] = tree["b"][1][0].numpy()
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    finally:
        dist.destroy_process_group()


def _jax_side(out_path):
    """On 8 forced host devices: each shard case's spec and the slice of
    every device (keyed by its mesh coordinates), and JAX's
    ``compressed_psum`` under ``shard_map`` over ``data``."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.distributed import sharding as JS
    from repro.distributed.compress import compressed_psum
    assert jax.device_count() == 8, jax.device_count()
    out, arrays = {}, {}
    for mname, shape, names in RANK_MESHES:
        mesh = jax.make_mesh(shape, names)
        for i, (shp, axes, rules, then) in enumerate(SHARD_CASES[mname]):
            spec = JS.logical_spec(shp, then or axes, getattr(JS, rules),
                                   mesh)
            slices = {}
            for dev, idx in NamedSharding(mesh, spec).devices_indices_map(
                    shp).items():
                coord = tuple(int(c) for c in
                              np.argwhere(mesh.devices == dev)[0])
                slices[",".join(map(str, coord))] = [
                    [s.start or 0, s.stop if s.stop is not None else n]
                    for s, n in zip(idx, shp)]
            out[f"{mname}_{i}"] = {"spec": [list(a) if isinstance(a, tuple)
                                            else a for a in spec],
                                   "slices": slices}
    mesh = jax.make_mesh((2, 4), ("data", "model"))
    g, e = _psum_inputs()

    def f(gl, el):
        return compressed_psum(gl, el, "data")
    try:
        from jax import shard_map
        kw = {"check_vma": False}
    except ImportError:
        from jax.experimental.shard_map import shard_map
        kw = {"check_rep": False}
    spec = P("data", "model")
    mean, err = shard_map(f, mesh=mesh, in_specs=(spec, spec),
                          out_specs=(spec, spec), **kw)(
        _psum_tree({k: jax.numpy.asarray(v) for k, v in g.items()}),
        _psum_tree({k: jax.numpy.asarray(v) for k, v in e.items()}))
    for tag, tree in (("mean", mean), ("err", err)):
        arrays[f"psum_{tag}_w"] = np.asarray(tree["w"])
        arrays[f"psum_{tag}_ties"] = np.asarray(tree["b"][0])
        arrays[f"psum_{tag}_zeros"] = np.asarray(tree["b"][1][0])
    arrays["slices"] = np.asarray(json.dumps(out))
    np.savez(out_path, **arrays)


@pytest.fixture(scope="module")
def rank_runs(tmp_path_factory):
    """JAX in a subprocess and the port on 8 spawned ranks, side by
    side; both results read back."""
    out = tmp_path_factory.mktemp("sharding_runs")
    jax_out = str(out / "jax.npz")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(root, "src"), root, os.path.join(root, "tests")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    jproc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "jax-sharding",
         jax_out], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        spawn_ranks(_sharding_rank, 8, (str(out / "store"), str(out)),
                    DEADLINE_S)
        _, err = jproc.communicate(timeout=DEADLINE_S)
    finally:
        if jproc.poll() is None:
            jproc.kill()
            jproc.communicate()
    assert jproc.returncode == 0, err[-3000:]
    want = dict(np.load(jax_out))
    return want, [dict(np.load(out / f"rank{r}.npz")) for r in range(8)]


@pytest.mark.parametrize("mname", [m[0] for m in RANK_MESHES])
def test_shard_local_slices_equal_jax(rank_runs, mname):
    """Every rank's local shard is the slice JAX's sharding gives the
    device at the same mesh coordinates, and its placements are
    ``placements(logical_spec(...))``."""
    want, ranks = rank_runs
    slices = json.loads(str(want["slices"]))
    shape = dict((m[0], m) for m in RANK_MESHES)[mname]
    fake = FakeMesh(dict(zip(shape[2], shape[1])))
    seen = set()
    for r in ranks:
        coord = ",".join(map(str, r[f"{mname}_coord"]))
        seen.add(coord)
        for i, (shp, axes, rules, then) in enumerate(SHARD_CASES[mname]):
            case = slices[f"{mname}_{i}"]
            spec = TS.logical_spec(shp, then or axes, getattr(TS, rules),
                                   fake)
            assert list(spec) == [tuple(a) if isinstance(a, list) else a
                                  for a in case["spec"]], (mname, i)
            idx = tuple(slice(a, b) for a, b in case["slices"][coord])
            np.testing.assert_array_equal(
                r[f"{mname}_{i}"], _case_array(shp, i)[idx],
                err_msg=f"{mname} case {i} at {coord}")
            assert list(r[f"{mname}_{i}_placements"]) == [
                repr(p) for p in TS.placements(spec, fake)]
    assert len(seen) == 8


def test_compressed_psum_over_data_equals_jax_shard_map(rank_runs):
    """The int8 all-reduce over ``data`` of the (2, 4) mesh: each rank's
    mean and new error equal JAX's ``shard_map`` outputs of the device
    at its coordinates, bit for bit."""
    want, ranks = rank_runs
    for r in ranks:
        d, m = (int(c) for c in r["dm_coord"])
        for tag in ("mean", "err"):
            for leaf in PSUM_N:
                got = r[f"psum_{tag}_{leaf}"]
                w = want[f"psum_{tag}_{leaf}"][d, m]
                assert got.dtype == w.dtype == np.float32
                np.testing.assert_array_equal(
                    got.view(np.int32), w.view(np.int32),
                    err_msg=f"{tag} {leaf} at {(d, m)}")
    # the ties leaf: scale 1, so the mean is the half-even rounded sum / 2
    g, _ = _psum_inputs()
    r0 = next(r for r in ranks if tuple(r["dm_coord"]) == (0, 0))
    want_mean = (np.round(g["ties"][0, 0]) + np.round(g["ties"][1, 0])) / 2
    np.testing.assert_array_equal(r0["psum_mean_ties"], want_mean)


if __name__ == "__main__" and sys.argv[1:2] == ["jax-sharding"]:
    _jax_side(sys.argv[2])
