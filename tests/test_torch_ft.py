"""The port's fault tolerance and token data against the JAX package's on
the CPU: ``tests/test_ft.py``'s cases on the port (the restart bit for bit,
retention, atomicity, stragglers, the re-mesh plan, the pipeline's
resume); ``TokenPipeline`` batches equal to JAX's bit for bit; checkpoints
that each package writes restored by the other bit for bit; a bf16 leaf
refused by name."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE_CONFIGS
from repro.data.pipeline import TokenPipeline as JPipe
from repro.ft import checkpoint as JCK
from repro.ft.straggler import HeartbeatMonitor as JMonitor
from repro.models import lm as JLM
from repro.optim import adamw as JAD

from repro_torch.configs import SMOKE_CONFIGS as T_SMOKE
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.distributed.elastic import plan_remesh
from repro_torch.ft import CheckpointManager, HeartbeatMonitor
from repro_torch.launch.train import default_optimizer, make_train_step
from repro_torch.models import lm
from repro_torch.optim import adamw_init
from repro_torch.optim.adamw import tree_leaves


@pytest.fixture
def deterministic():
    """``torch.use_deterministic_algorithms(True)`` for one test: the CPU's
    ``index_put_(accumulate=True)`` (the embedding's backward) otherwise
    adds its rows in an order that varies from run to run."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


def _train(cfg, step_fn, params, opt_state, pipe, steps):
    for _ in range(steps):
        batch = pipe.next_batch(cfg)
        params, opt_state, _ = step_fn(params, opt_state, batch)
    return params, opt_state


def _init(cfg, seed=0):
    return lm.init_params(cfg, torch.Generator().manual_seed(seed),
                          device="cpu")


def test_checkpoint_restart_bitexact(tmp_path, deterministic):
    """Train 6 steps straight == train 3, checkpoint, restore into fresh
    trees, train 3; the restored trees equal the saved ones."""
    cfg = T_SMOKE["gemma3-1b"]
    step_fn = make_train_step(cfg, default_optimizer())
    params0 = _init(cfg)
    opt0 = adamw_init(params0)

    pipe_a = TokenPipeline(cfg.vocab_size, batch=2, seq=16, seed=0)
    pa, oa = _train(cfg, step_fn, params0, opt0, pipe_a, 6)

    pipe_b = TokenPipeline(cfg.vocab_size, batch=2, seq=16, seed=0)
    pb, ob = _train(cfg, step_fn, params0, opt0, pipe_b, 3)
    ckpt = CheckpointManager(str(tmp_path), keep=2)
    ckpt.save(3, pb, ob, pipe_b.get_state())

    pipe_c = TokenPipeline(cfg.vocab_size, batch=2, seq=16, seed=0)
    pr, orr, pipe_state, step = ckpt.restore(_init(cfg, 9),
                                             adamw_init(_init(cfg, 9)))
    pipe_c.set_state(pipe_state)
    assert step == 3 and pipe_state == {"step": 3, "seed": 0}
    for a, b in zip(tree_leaves((pb, ob)), tree_leaves((pr, orr))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    pc, oc = _train(cfg, step_fn, pr, orr, pipe_c, 3)

    for a, b in zip(tree_leaves((pa, oa)), tree_leaves((pc, oc))):
        assert torch.equal(a, b)


def test_checkpoint_retention_and_latest(tmp_path):
    params = _init(T_SMOKE["whisper-base"])
    opt = adamw_init(params)
    ckpt = CheckpointManager(str(tmp_path), keep=2)
    assert ckpt.latest_step() is None
    for s in (1, 2, 3, 4):
        ckpt.save(s, params, opt, {"step": s, "seed": 0})
    assert ckpt.steps() == [3, 4]
    assert ckpt.latest_step() == 4


def test_checkpoint_atomicity_no_tmp_visible(tmp_path):
    params = _init(T_SMOKE["whisper-base"])
    opt = adamw_init(params)
    ckpt = CheckpointManager(str(tmp_path), keep=3)
    ckpt.save(7, params, opt, {"step": 7, "seed": 0})
    names = os.listdir(tmp_path)
    assert not any(".tmp" in n for n in names)
    assert "step_00000007" in names
    assert sorted(os.listdir(tmp_path / "step_00000007")) == [
        "meta.json", "opt.npz", "params.npz"]


@pytest.mark.parametrize("monitor", [HeartbeatMonitor, JMonitor])
def test_straggler_detection(monitor):
    """``test_ft``'s case, on both packages: the same report."""
    mon = monitor(num_nodes=8, timeout=10.0, straggler_factor=2.0)
    now = 100.0
    for node in range(6):
        mon.beat(node, step_s=1.0, now=now)
    mon.beat(6, step_s=5.0, now=now)          # straggler
    rep = mon.report(now=now + 1.0)
    assert rep.dead == [7]
    assert rep.stragglers == [6]
    assert set(rep.healthy) == set(range(6))
    assert rep.median_step_s == 1.0


def test_elastic_remesh_plan():
    p = plan_remesh(512, model=16, global_batch=256, pods=2)
    assert p.chips == 512 and p.data == 16
    p = plan_remesh(495, model=16, global_batch=256, pods=2)
    assert p.chips == 256 and p.data == 8
    assert p.per_device_batch * p.data * p.pods * p.grad_accum == 256
    p = plan_remesh(250, model=16, global_batch=256, pods=2)
    assert p.chips == 128
    assert p.per_device_batch * p.data * p.pods * p.grad_accum == 256
    assert plan_remesh(8, model=16, global_batch=256, pods=1) is None


def test_pipeline_state_resume():
    a = TokenPipeline(1000, batch=2, seq=8, seed=5)
    for _ in range(4):
        a.next_batch()
    state = a.get_state()
    b1 = a.next_batch()
    b = TokenPipeline(1000, batch=2, seq=8, seed=5)
    b.set_state(state)
    b2 = b.next_batch()
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("arch", ["gemma3-1b", "internvl2-1b",
                                  "whisper-base"])
def test_token_pipeline_equal_jax(seed, arch):
    """The same batches, bit for bit, with the ``vlm`` and ``audio``
    extras; then both resumed from the other's state."""
    cfg = SMOKE_CONFIGS[arch]
    pj = JPipe(cfg.vocab_size, batch=3, seq=24, seed=seed)
    pt = TokenPipeline(cfg.vocab_size, batch=3, seq=24, seed=seed)
    for _ in range(3):
        bj, bt = pj.next_batch(cfg), pt.next_batch(T_SMOKE[arch])
        assert bj.keys() == bt.keys()
        for k in bj:
            assert bj[k].dtype == bt[k].dtype and bj[k].shape == bt[k].shape
            np.testing.assert_array_equal(bj[k], bt[k])
    assert pt.get_state() == pj.get_state() == {"step": 3, "seed": seed}
    bj, bt = pj.next_batch(), pt.next_batch()         # no config: no extras
    assert bt.keys() == bj.keys() == {"tokens", "labels"}
    np.testing.assert_array_equal(bj["labels"], bt["labels"])
    pj2 = JPipe(cfg.vocab_size, batch=3, seq=24, seed=seed)
    pj2.set_state(pt.get_state())
    pt2 = TokenPipeline(cfg.vocab_size, batch=3, seq=24, seed=seed)
    pt2.set_state(pj.get_state())
    np.testing.assert_array_equal(pj2.next_batch()["tokens"],
                                  pt2.next_batch()["tokens"])


def _jax_trees(cfg):
    p = JLM.init_params(cfg, jax.random.PRNGKey(3))
    o = JAD.adamw_init(p)
    o = {"m": jax.tree.map(lambda a: a + 1.0, o["m"]),
         "v": jax.tree.map(lambda a: a + 2.0, o["v"]),
         "step": jnp.asarray(17, jnp.int32)}
    return p, o


@pytest.mark.parametrize("arch", ["gemma3-1b", "zamba2-1.2b"])
def test_checkpoint_jax_to_port(tmp_path, arch):
    """A checkpoint saved by JAX's ``CheckpointManager`` restores in the
    port bit for bit, into trees on the like's device and dtype."""
    cfg = SMOKE_CONFIGS[arch]
    pj, oj = _jax_trees(cfg)
    JCK.CheckpointManager(str(tmp_path)).save(
        5, pj, oj, {"step": 5, "seed": 0})
    like = _init(T_SMOKE[arch])
    pt, ot, pipe, step = CheckpointManager(str(tmp_path)).restore(
        like, adamw_init(like))
    assert step == 5 and pipe == {"step": 5, "seed": 0}
    assert ot["step"].dtype == torch.int32 and int(ot["step"]) == 17
    want = [np.asarray(a) for a in jax.tree.leaves((pj, oj))]
    got = tree_leaves((pt, ot))
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert b.device.type == "cpu" and str(a.dtype) == str(
            b.dtype).replace("torch.", "")
        np.testing.assert_array_equal(a, b.numpy())


@pytest.mark.parametrize("arch", ["gemma3-1b", "rwkv6-1.6b"])
def test_checkpoint_port_to_jax(tmp_path, arch):
    """The reverse: the port's npz keys are JAX's ``_flatten`` keys, and
    JAX's ``restore`` gives the port's values bit for bit."""
    params = _init(T_SMOKE[arch], 4)
    opt = adamw_init(params)
    opt["step"] = torch.tensor(9, dtype=torch.int32)
    CheckpointManager(str(tmp_path)).save(2, params, opt,
                                          {"step": 2, "seed": 0})
    pj, oj = _jax_trees(SMOKE_CONFIGS[arch])
    d = tmp_path / "step_00000002"
    with np.load(d / "params.npz") as z:
        assert set(z.files) == set(JCK._flatten(pj))
    with np.load(d / "opt.npz") as z:
        assert set(z.files) == set(JCK._flatten(oj))
        assert "step" in z.files and "m/embed" in z.files
    rp, ro, pipe, step = JCK.CheckpointManager(str(tmp_path)).restore(
        pj, oj)
    assert step == 2 and pipe == {"step": 2, "seed": 0}
    for a, b in zip(jax.tree.leaves((rp, ro)), tree_leaves((params, opt))):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
        assert np.asarray(a).dtype == b.numpy().dtype


def test_checkpoint_bf16_leaf_raises(tmp_path):
    """numpy has no bfloat16 here: a bf16 leaf is refused by name, on save
    and on restore into a bf16 tree."""
    cfg = T_SMOKE["gemma3-1b"]
    params = _init(cfg)
    opt = adamw_init(params)
    ckpt = CheckpointManager(str(tmp_path))
    bf16 = dict(params, final_ln=params["final_ln"].bfloat16())
    with pytest.raises(TypeError, match="'final_ln'"):
        ckpt.save(1, bf16, opt, {"step": 1, "seed": 0})
    assert ckpt.steps() == [] and not os.listdir(tmp_path)
    ckpt.save(1, params, opt, {"step": 1, "seed": 0})
    with pytest.raises(TypeError, match="'final_ln'"):
        ckpt.restore(bf16, opt)
    cfg16 = dataclasses.replace(cfg, param_dtype="bfloat16")
    with pytest.raises(TypeError, match="bfloat16"):
        ckpt.save(2, lm.init_params(cfg16, torch.Generator().manual_seed(0),
                                    device="cpu"), opt, {})
