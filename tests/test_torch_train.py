"""The port's training path against the JAX package's on the CPU:
``optim.adamw`` (the schedules, ``global_norm``, ``clip_by_global_norm``,
``adamw_update``) on seeded trees, ``launch.train.make_train_step`` on
JAX's weights carried across (``lm.params_from_jax``) for every smoke
architecture, ``test_models.py``'s train cases (gradient accumulation,
capacity dispatch with drops) in both packages, the ``mixed_state`` step,
a 20-step loss curve, and remat on and off bit for bit.

Bounds, f32: loss within 1e-5 relative, ``grad_norm`` within 1e-4
relative (a sum over every gradient element in another order), ``lr``
within 1e-6 relative; an updated parameter within 2 x lr + 2e-6 of JAX's
(Adam's first step moves an element by about ``sign(g) x lr``, so a
gradient that is noise around zero may flip it by 2 x lr), and no more
than 1e-3 of the elements further than lr / 2; a gradient within 1e-4 of
its leaf's largest |g|."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, SMOKE_CONFIGS
from repro.data.pipeline import TokenPipeline as JPipe
from repro.launch import train as JTR
from repro.models import lm as JLM
from repro.optim import adamw as JAD

from repro_torch.configs import SMOKE_CONFIGS as T_SMOKE
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch import train as TTR
from repro_torch.models import lm as TLM
from repro_torch.optim import adamw as TAD
from tests.test_torch_lm import batch_np

SCHED_STEPS = (0, 1, 50, 99, 100, 101, 5_000, 10_000)


def jleaves(tree):
    return [np.asarray(a) for a in jax.tree.leaves(tree)]


def tleaves(tree):
    return [t.detach().numpy() for t in TAD.tree_leaves(tree)]


def seeded_tree(seed, scale=1.0):
    """A nested dict of f32 arrays (keys out of order: JAX sorts them)."""
    rng = np.random.default_rng(seed)

    def a(*shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return {"w": a(5, 3), "b": {"z": a(7), "a": a(2, 2, 3)}, "c": a(1)}


def to_t(tree):
    return jax.tree.map(lambda a: torch.as_tensor(np.array(a)), tree)


def close_params(jp, tp, lr):
    for a, b in zip(jleaves(jp), tleaves(tp)):
        d = np.abs(a.astype(np.float32) - b.astype(np.float32))
        assert d.max() <= 2 * lr + 2e-6, (d.max(), lr)
        assert (d > lr / 2).mean() <= 1e-3, ((d > lr / 2).mean(), lr)


def close_grads(jg, tg, rel=1e-4):
    for a, b in zip(jleaves(jg), tleaves(tg)):
        scale = float(np.abs(a).max())
        assert np.abs(a - b).max() <= rel * scale + 1e-12, (
            np.abs(a - b).max(), scale)


def close_metrics(jm, tm, keys=("loss", "grad_norm", "lr")):
    tol = {"loss": 1e-5, "grad_norm": 1e-4, "lr": 1e-6, "ce": 1e-5,
           "aux": 1e-5}
    assert set(tm) == set(jm)
    for k in keys:
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=tol[k],
                                             abs=1e-7), k


def test_names_and_state_layout():
    assert [(f.name, f.default) for f in dataclasses.fields(TAD.AdamW)] == [
        (f.name, f.default) for f in dataclasses.fields(JAD.AdamW)]
    st = TAD.adamw_init(to_t(seeded_tree(0)))
    assert set(st) == {"m", "v", "step"}
    assert st["step"].dtype == torch.int32 and st["step"].dim() == 0
    for t in TAD.tree_leaves(st["m"]) + TAD.tree_leaves(st["v"]):
        assert t.dtype == torch.float32 and not t.any()
    jst = JAD.adamw_init(seeded_tree(0))
    assert [a.shape for a in jleaves(jst)] == [
        tuple(t.shape) for t in TAD.tree_leaves(st)]


@pytest.mark.parametrize("sched", [
    ("cosine_schedule", (3e-4, 100, 10_000)),
    ("cosine_schedule", (1e-3, 0, 5_000, 0.0)),
    ("cosine_schedule", (3e-4, 100, 60)),
    ("linear_warmup", (3e-4, 100)),
])
def test_schedules_equal_jax(sched):
    name, args = sched
    fj, ft = getattr(JAD, name)(*args), getattr(TAD, name)(*args)
    for s in SCHED_STEPS:
        want = float(fj(jnp.asarray(s, jnp.int32)))
        got = ft(torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.dim() == 0
        assert float(got) == pytest.approx(want, rel=1e-6, abs=1e-12), s


@pytest.mark.parametrize("scale,max_norm", [(1.0, 1.0), (0.01, 1.0),
                                            (3.0, 0.5)])
def test_global_norm_and_clip_equal_jax(scale, max_norm):
    tree = seeded_tree(1, scale)
    nj = JAD.global_norm(tree)
    nt = TAD.global_norm(to_t(tree))
    assert float(nt) == pytest.approx(float(nj), rel=1e-6)
    cj, nj2 = JAD.clip_by_global_norm(tree, max_norm)
    ct, nt2 = TAD.clip_by_global_norm(to_t(tree), max_norm)
    assert float(nt2) == pytest.approx(float(nj2), rel=1e-6)
    for a, b in zip(jleaves(cj), tleaves(ct)):
        np.testing.assert_allclose(b, a, rtol=2e-6, atol=1e-9)


@pytest.mark.parametrize("steps", [1, 6])
def test_adamw_update_equal_jax(steps):
    """``steps`` updates from fresh state on seeded params and grads (the
    clip active: the grads' norm is ~10)."""
    opt_j = JAD.AdamW(lr=JAD.cosine_schedule(1e-2, 2, 10))
    opt_t = TAD.AdamW(lr=TAD.cosine_schedule(1e-2, 2, 10))
    pj, pt = seeded_tree(2), to_t(seeded_tree(2))
    sj, st = JAD.adamw_init(pj), TAD.adamw_init(pt)
    for i in range(steps):
        g = seeded_tree(10 + i, 3.0)
        pt_before = [t.clone() for t in TAD.tree_leaves(pt)]
        pj, sj, mj = JAD.adamw_update(opt_j, g, sj, pj)
        pt, st, mt = TAD.adamw_update(opt_t, to_t(g), st, pt)
        close_metrics(mj, mt, ("grad_norm", "lr"))
    # the last call left its inputs as they were
    assert all(not torch.equal(a, b)
               for a, b in zip(pt_before, TAD.tree_leaves(pt)))
    assert int(st["step"]) == int(sj["step"]) == steps
    for a, b in zip(jleaves(pj) + jleaves(sj["m"]) + jleaves(sj["v"]),
                    tleaves(pt) + tleaves(st["m"]) + tleaves(st["v"])):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-7)


def jax_step(cfg, params, batch, opt=None):
    opt = opt or JTR.default_optimizer()
    return jax.jit(JTR.make_train_step(cfg, opt))(
        params, JAD.adamw_init(params), batch)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_train_step(arch):
    """``test_models``' one-step case in f32 on both packages, the same
    weights and batch: loss, ``grad_norm``, ``lr``, every updated
    parameter; the port's inputs are left as they were and nothing is
    left in ``.grad``."""
    jc = dataclasses.replace(SMOKE_CONFIGS[arch], dtype="float32")
    tc = dataclasses.replace(T_SMOKE[arch], dtype="float32")
    pj = JLM.init_params(jc, jax.random.PRNGKey(1))
    pt = TLM.params_from_jax(jax.tree.map(np.asarray, pj), device="cpu")
    before = [t.clone() for t in TAD.tree_leaves(pt)]
    batch = batch_np(jc, seed=1)
    jp, jo, jm = jax_step(jc, pj, batch)
    opt0 = TAD.adamw_init(pt)
    tp, to, tm = TTR.make_train_step(tc, TTR.default_optimizer())(
        pt, opt0, batch)
    close_metrics(jm, tm, ("loss", "grad_norm", "lr", "ce", "aux"))
    close_params(jp, tp, float(jm["lr"]))
    assert int(to["step"]) == 1 and not opt0["step"]
    for t, b in zip(TAD.tree_leaves(pt), before):
        assert torch.equal(t, b) and t.grad is None and not t.requires_grad
    changed = any(not torch.allclose(a, b)
                  for a, b in zip(before, TAD.tree_leaves(tp)))
    assert changed
    for t in TAD.tree_leaves(tp):
        assert bool(torch.isfinite(t).all()) and not t.requires_grad


def test_grad_accum_equivalence():
    """``test_models``' case in both packages (accum 2 against 1 within
    its bounds), and the port's accum-2 step against JAX's."""
    cfg = SMOKE_CONFIGS["stablelm-3b"]
    tcfg = T_SMOKE["stablelm-3b"]
    pj = JLM.init_params(cfg, jax.random.PRNGKey(3))
    pt = TLM.params_from_jax(jax.tree.map(np.asarray, pj), device="cpu")
    batch = batch_np(cfg, b=4, s=16, seed=3)
    opt_t = TTR.default_optimizer()
    p1, _, m1 = TTR.make_train_step(tcfg, opt_t)(pt, TAD.adamw_init(pt),
                                                  batch)
    tcfg2 = dataclasses.replace(tcfg, grad_accum=2)
    p2, _, m2 = TTR.make_train_step(tcfg2, opt_t)(pt, TAD.adamw_init(pt),
                                                   batch)
    assert set(m2) == {"loss", "grad_norm", "lr"}
    assert float(m1["grad_norm"]) == pytest.approx(float(m2["grad_norm"]),
                                                   rel=2e-2)
    for a, b in zip(tleaves(p1), tleaves(p2)):
        np.testing.assert_allclose(a, b, rtol=5e-2, atol=5e-4)
    # the same case on JAX's step, and the two accum-2 steps against
    # each other in f32
    jc2 = dataclasses.replace(cfg, grad_accum=2, dtype="float32")
    tc2 = dataclasses.replace(tcfg2, dtype="float32")
    jp, _, jm = jax_step(jc2, pj, batch)
    tp, _, tm = TTR.make_train_step(tc2, opt_t)(pt, TAD.adamw_init(pt),
                                                 batch)
    close_metrics(jm, tm)
    close_params(jp, tp, float(jm["lr"]))


def test_capacity_dispatch_trains_with_drops():
    """``test_models``' case: capacity dispatch at factor 1.25 drops
    tokens; loss and every gradient finite, and (f32) equal to JAX's."""
    jc = dataclasses.replace(SMOKE_CONFIGS["moonshot-v1-16b-a3b"],
                             moe_dispatch="capacity",
                             moe_capacity_factor=1.25, dtype="float32")
    tc = dataclasses.replace(T_SMOKE["moonshot-v1-16b-a3b"],
                             moe_dispatch="capacity",
                             moe_capacity_factor=1.25, dtype="float32")
    pj = JLM.init_params(jc, jax.random.PRNGKey(8))
    pt = TLM.params_from_jax(jax.tree.map(np.asarray, pj), device="cpu")
    tokens = np.random.default_rng(8).integers(
        0, jc.vocab_size, (2, 64)).astype(np.int32)
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, 1)}
    loss_j = JLM.loss_fn(jc, pj, jax.tree.map(jnp.asarray, batch))[0]
    gj = jax.grad(lambda p: JLM.loss_fn(
        jc, p, jax.tree.map(jnp.asarray, batch))[0])(pj)
    step = TTR.make_train_step(tc, TTR.default_optimizer())
    loss_t, _, gt = step.grads_of(pt, {k: torch.as_tensor(v)
                                       for k, v in batch.items()})
    assert bool(torch.isfinite(loss_t))
    for g in TAD.tree_leaves(gt):
        assert bool(torch.isfinite(g).all())
    assert float(loss_t) == pytest.approx(float(loss_j), rel=1e-5)
    close_grads(gj, gt)


def test_mixed_state_step():
    """moonshot's ``mixed_state`` (its full config's; the smoke's is
    off): the f32 master cast to a bf16 copy inside the step, gradients
    back in f32. bf16 compute, so ``test_models``' bf16 bound on the loss
    and the gradients (0.05 x scale + 0.05); the parameters within the
    Adam flip bound of 2 x lr + 2e-6."""
    jc = dataclasses.replace(SMOKE_CONFIGS["moonshot-v1-16b-a3b"],
                             mixed_state=True)
    tc = dataclasses.replace(T_SMOKE["moonshot-v1-16b-a3b"],
                             mixed_state=True)
    assert jc.dtype == tc.dtype == "bfloat16"
    pj = JLM.init_params(jc, jax.random.PRNGKey(5))
    pt = TLM.params_from_jax(jax.tree.map(np.asarray, pj), device="cpu")
    batch = batch_np(jc, seed=5)
    jp, _, jm = jax_step(jc, pj, batch)
    step = TTR.make_train_step(tc, TTR.default_optimizer())
    tp, _, tm = step(pt, TAD.adamw_init(pt), batch)
    for k in ("loss", "grad_norm"):
        assert abs(float(tm[k]) - float(jm[k])) <= 0.05 * abs(
            float(jm[k])) + 0.05, k
    lr = float(jm["lr"])
    for a, b in zip(jleaves(jp), tleaves(tp)):
        assert np.abs(a - b).max() <= 2 * lr + 2e-6
    cast = TTR._mixed_cast(tc, pt)
    for t in TAD.tree_leaves(cast):
        assert t.dtype == torch.bfloat16
    _, _, gt = step.grads_of(pt, {k: torch.as_tensor(v)
                                  for k, v in batch.items()})
    for t in TAD.tree_leaves(gt):
        assert t.dtype == torch.float32


def test_loss_curve_equal_jax():
    """20 f32 steps of gemma3's smoke config on ``TokenPipeline`` batches,
    ``default_optimizer(20)``: the loss within 1e-4 of JAX's at every
    step."""
    jc = dataclasses.replace(SMOKE_CONFIGS["gemma3-1b"], dtype="float32")
    tc = dataclasses.replace(T_SMOKE["gemma3-1b"], dtype="float32")
    pj = JLM.init_params(jc, jax.random.PRNGKey(0))
    pt = TLM.params_from_jax(jax.tree.map(np.asarray, pj), device="cpu")
    jstep = jax.jit(JTR.make_train_step(jc, JTR.default_optimizer(20)))
    tstep = TTR.make_train_step(tc, TTR.default_optimizer(20))
    sj, st = JAD.adamw_init(pj), TAD.adamw_init(pt)
    pipe_j = JPipe(jc.vocab_size, batch=4, seq=64, seed=0)
    pipe_t = TokenPipeline(tc.vocab_size, batch=4, seq=64, seed=0)
    lj, lt = [], []
    for _ in range(20):
        pj, sj, mj = jstep(pj, sj, pipe_j.next_batch(jc))
        pt, st, mt = tstep(pt, st, pipe_t.next_batch(tc))
        lj.append(float(mj["loss"]))
        lt.append(float(mt["loss"]))
    np.testing.assert_allclose(lt, lj, rtol=0, atol=1e-4)
    assert lt[-1] < lt[0]


@pytest.fixture
def deterministic():
    """``torch.use_deterministic_algorithms(True)`` for one test: the CPU's
    ``index_put_(accumulate=True)`` (the embedding's backward) otherwise
    adds its rows in an order that varies from run to run."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


def _saved_bytes(fn):
    """Bytes autograd saves for the backward outside any checkpoint
    (a checkpoint's own hooks stand inside this one)."""
    total = [0]

    def pack(t):
        total[0] += t.numel() * t.element_size()
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return out, total[0]


@pytest.mark.parametrize("arch,seq,vocab", [
    ("gemma3-1b", 2048, 32_768),   # blockwise attention, 4 CE chunks
    ("zamba2-1.2b", 1024, None),   # 8 SSD chunks a layer
    ("rwkv6-1.6b", 1024, None),    # 64 WKV chunks: nested 8 x 8
])
def test_remat_matches_no_remat(arch, seq, vocab, deterministic):
    """``remat=True`` gives the gradients of ``remat=False`` bit for bit
    on the CPU (deterministic algorithms), at smoke width over 1 x ``seq``
    tokens, and saves fewer bytes for the backward outside its
    checkpoints."""
    tc = dataclasses.replace(T_SMOKE[arch], dtype="float32")
    if vocab:
        tc = dataclasses.replace(tc, vocab_size=vocab)
    assert TLM._ce_chunks(seq, tc.padded_vocab) == (4 if vocab else 1)
    params = TLM.init_params(tc, torch.Generator().manual_seed(0),
                             device="cpu")
    tokens = np.random.default_rng(0).integers(
        0, tc.vocab_size, (1, seq)).astype(np.int32)
    batch = {"tokens": torch.as_tensor(tokens),
             "labels": torch.as_tensor(np.roll(tokens, -1, 1))}
    got = {}
    for remat in (False, True):
        step = TTR.make_train_step(dataclasses.replace(tc, remat=remat),
                                   TTR.default_optimizer())
        got[remat] = _saved_bytes(lambda: step.grads_of(params, batch))
    (l0, _, g0), b0 = got[False]
    (l1, _, g1), b1 = got[True]
    assert torch.equal(l0, l1)
    for a, b in zip(TAD.tree_leaves(g0), TAD.tree_leaves(g1)):
        assert torch.equal(a, b)
    # zamba2 keeps its shared attention's activations: JAX does not remat
    # that block (0.66 of the bytes; gemma3 0.06, rwkv6 0.20)
    assert b1 < 0.75 * b0, (b1, b0)
