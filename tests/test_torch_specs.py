"""The port's AOT input specs (``repro_torch.launch.specs`` and
``distributed.sharding.spec_tree_to_shape_dtype``) against the JAX
package's on the CPU.

``step_specs`` for all ten architectures x the four shapes x both
production meshes equals JAX's (on a ``jax.sharding.AbstractMesh``)
field by field, as ``tests/test_torch_search_step.py`` holds the search
step's: each leaf's shape, dtype, spec and per-rank shape, and the tree's
structure. Also ``cache_specs``' leaves, ``spec_tree_to_shape_dtype``
with and without ``dtype=``, and that building the specs allocates
nothing.
"""
import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import ARCH_IDS, CONFIGS, SHAPES, SMOKE_CONFIGS
from repro.distributed import sharding as JS
from repro.launch import specs as JSP
from repro.models import lm as JLM

from repro_torch.configs import CONFIGS as T_CONFIGS
from repro_torch.configs import SHAPES as T_SHAPES
from repro_torch.configs import SMOKE_CONFIGS as T_SMOKE
from repro_torch.distributed import sharding as TS
from repro_torch.launch import specs as TSP
from repro_torch.models import lm as TLM
from tests.test_torch_sharding import FakeMesh

MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}


def _jflat(tree):
    """path -> leaf of JAX's tree (None subtrees dropped)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in p):
            leaf for p, leaf in flat}


def _tflat(tree, path=()):
    """path -> ArgSpec of the port's tree."""
    if isinstance(tree, TS.ArgSpec):
        return {path: tree}
    out = {}
    items = (tree.items() if isinstance(tree, dict)
             else enumerate(tree) if isinstance(tree, (list, tuple)) else ())
    for k, v in items:
        if v is not None:
            out.update(_tflat(v, path + (str(k),)))
    return out


def _same(t, j, name):
    assert t.shape == tuple(j.shape), name
    assert str(t.dtype).replace("torch.", "") == str(j.dtype), name
    assert tuple(t.spec) == tuple(j.sharding.spec), name
    assert t.local_shape == tuple(j.sharding.shard_shape(j.shape)), name
    assert t.placements == TS.placements(t.spec, j.sharding.mesh), name


def _same_trees(t_tree, j_tree):
    tf, jf = _tflat(t_tree), _jflat(j_tree)
    assert set(tf) == set(jf), set(tf) ^ set(jf)
    for k in jf:
        _same(tf[k], jf[k], k)


class _NoAlloc(TorchDispatchMode):
    """Fails on any op that makes a tensor of more than one element off
    the ``meta`` device."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (list, tuple)) else [out]):
            if (isinstance(t, torch.Tensor) and t.device.type != "meta"
                    and t.numel() > 1):
                raise AssertionError(f"{func} allocated {tuple(t.shape)}")
        return out


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_step_specs_equal_jax(arch, shape, mesh):
    """(kind, args) of ``step_specs`` at the full config: the kind, every
    leaf's shape, dtype, spec, per-rank shape and placements, with
    nothing allocated."""
    sizes = MESHES[mesh]
    jmesh = jax.sharding.AbstractMesh(tuple(sizes.values()), tuple(sizes))
    jkind, jargs = JSP.step_specs(CONFIGS[arch], SHAPES[shape], jmesh)
    with _NoAlloc():
        tkind, targs = TSP.step_specs(T_CONFIGS[arch], T_SHAPES[shape],
                                      FakeMesh(sizes))
    assert tkind == jkind
    assert len(targs) == len(jargs)
    for t, j in zip(targs, jargs):
        _same_trees(t, j)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_leaves(arch):
    """``cache_specs`` at decode_32k on the single-pod mesh: JAX's leaves,
    ``len`` the 0-d int32 JAX's is, the KV cache sharded on its heads
    when the 16 model ranks divide them and on its sequence otherwise,
    an SSM state on its batch."""
    sizes = MESHES["single"]
    jmesh = jax.sharding.AbstractMesh(tuple(sizes.values()), tuple(sizes))
    shape = SHAPES["decode_32k"]
    want = JSP.cache_specs(CONFIGS[arch], shape, jmesh)
    got = TSP.cache_specs(T_CONFIGS[arch], T_SHAPES["decode_32k"],
                          FakeMesh(sizes))
    _same_trees(got, want)
    flat = _tflat(got)
    cfg = T_CONFIGS[arch]
    for path, a in flat.items():
        if path[-1] == "len":
            assert a.shape == () and a.dtype == torch.int32
            assert a.local_nbytes == 4
        elif path[-1] in ("k", "v", "attn_k", "attn_v"):
            axis = 3 if cfg.num_kv_heads % 16 == 0 else 2
            assert a.spec[axis] == "model" and a.spec[1] == "data", path
        else:
            assert "data" in a.spec, path


@pytest.mark.parametrize("dtype", [None, "float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "zamba2-1.2b"])
def test_spec_tree_to_shape_dtype_equal_jax(arch, dtype):
    """The parameter specs of a smoke config on a (2, 4) mesh, with and
    without a ``dtype`` override."""
    sizes = {"data": 2, "model": 4}
    jmesh = jax.sharding.AbstractMesh(tuple(sizes.values()), tuple(sizes))
    want = JS.spec_tree_to_shape_dtype(
        JLM.param_specs(SMOKE_CONFIGS[arch]), JS.SINGLE_POD_RULES, jmesh,
        dtype=None if dtype is None else getattr(jax.numpy, dtype))
    got = TS.spec_tree_to_shape_dtype(
        TLM.param_specs(T_SMOKE[arch]), TS.SINGLE_POD_RULES,
        FakeMesh(sizes), dtype=None if dtype is None else getattr(torch,
                                                                   dtype))
    _same_trees(got, want)
    leaves = list(_tflat(got).values())
    assert {a.dtype for a in leaves} == {getattr(torch, dtype or
                                                 "float32")}


def test_opt_specs_mirror_params():
    """AdamW's m and v mirror the parameter sharding in f32; the step is
    a replicated int32 scalar."""
    mesh = FakeMesh(MESHES["single"])
    cfg = T_CONFIGS["gemma3-1b"]
    p = _tflat(TSP.params_specs(cfg, mesh))
    o = TSP.opt_specs(cfg, mesh)
    for half in ("m", "v"):
        h = _tflat(o[half])
        assert set(h) == set(p)
        for k in p:
            assert h[k].spec == p[k].spec and h[k].dtype == torch.float32
    assert o["step"].shape == () and o["step"].dtype == torch.int32
    assert all(x.is_replicate() for x in o["step"].placements)
    nbytes = sum(a.local_nbytes for a in p.values())
    assert nbytes == pytest.approx(
        sum(np.prod(a.local_shape) * 4 for a in p.values()))
