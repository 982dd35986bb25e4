"""``examples_torch/train_resume.py`` against ``examples/train_resume.py``
on the CPU.

JAX's example runs once in this process at rwkv6-1.6b's smoke
configuration in f32 (its ``get_smoke_config`` global wrapped: in bf16
the two packages' losses part by ~1e-2 within 24 steps, XLA fusing
elementwise chains in f32 where the port rounds each op), with its
``jax.jit`` wrapped to keep each step's loss, its ``lm.init_params`` to
keep the weights, and its checkpoint directory in a pytest temporary
directory. JAX's example fails its own check, ``losses[-1] <
losses[0]``: ``default_optimizer()`` warms up over 100 steps, so 24 steps
never lift the learning rate past 7.2e-5 and the curve only wanders.

The port's ``run`` on JAX's weights carried across must give JAX's curve
within 1e-4 (the bound of the training tests) and resume at step 12, and
the check must fail on it too. Under ``torch.use_deterministic_
algorithms(True)`` the resumed run equals an uninterrupted one bit for
bit: the claim the example makes ("the loss curve continues
seamlessly").
"""
import dataclasses
import re
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.models import lm as TLM
from repro_torch.optim import adamw as TAD
from tests.test_torch_example_quickstart import (  # noqa: F401
    load_example, one_torch_thread, recorder, run_jax_example)

ARCH, STEPS, CRASH_AT = "rwkv6-1.6b", 24, 12
CURVE_ATOL = 1e-4


@pytest.fixture(scope="module")
def jax_train(tmp_path_factory):
    mod = load_example("examples/train_resume.py", "jax_train_resume")
    smoke = mod.get_smoke_config
    mod.get_smoke_config = lambda arch: dataclasses.replace(
        smoke(arch), dtype="float32")
    losses, params = [], []
    real_jit = mod.jax.jit

    def jit(fn):
        step = real_jit(fn)

        def call(p, o, batch):
            out = step(p, o, batch)
            losses.append(float(out[2]["loss"]))
            return out
        return call

    mod.jax = SimpleNamespace(jit=jit, random=jax.random)
    mod.lm = SimpleNamespace(init_params=recorder(mod.lm.init_params,
                                                  params))
    ckpt_dir = str(tmp_path_factory.mktemp("jax_ckpt"))
    mod.tempfile = SimpleNamespace(mkdtemp=lambda prefix: ckpt_dir)
    text, failed = run_jax_example(mod)
    return SimpleNamespace(text=text, failed=failed, losses=losses,
                           params=jax.tree.map(np.asarray, params[0]))


@pytest.fixture(scope="module")
def port():
    return load_example("examples_torch/train_resume.py",
                        "torch_train_resume")


@pytest.fixture(scope="module")
def port_runs(jax_train, port, tmp_path_factory):
    """The port's ``run`` on JAX's weights, resumed at 12 and straight
    through (a crash at the last step restores and trains no further),
    both under deterministic algorithms."""
    cfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32")
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        return {name: port.run(
            cfg, TLM.params_from_jax(jax_train.params, device="cpu"),
            STEPS, crash, str(tmp_path_factory.mktemp(name)), "cpu")
            for name, crash in (("resumed", CRASH_AT), ("straight", STEPS))}
    finally:
        torch.use_deterministic_algorithms(was)


def test_curve_within_bound_of_jax(jax_train, port_runs):
    got = port_runs["resumed"]["losses"]
    assert len(got) == len(jax_train.losses) == STEPS
    np.testing.assert_allclose(got, jax_train.losses, rtol=0,
                               atol=CURVE_ATOL)
    printed = [float(v) for v in re.search(
        r"loss curve: (.*)", jax_train.text).group(1).split()]
    assert printed == [round(v, 3) for v in jax_train.losses]


def test_resumed_at_the_last_checkpoint(jax_train, port_runs):
    assert port_runs["resumed"]["resumed_at"] == CRASH_AT
    assert f"resumed at step {CRASH_AT}" in jax_train.text
    assert len(port_runs["resumed"]["saves"]) == CRASH_AT // 6


def test_check_outcome_equals_jax(jax_train, port_runs):
    """JAX's example fails its check, by far more than the curves'
    distance; so does the port on the same weights."""
    j, t = jax_train.losses, port_runs["resumed"]["losses"]
    assert isinstance(jax_train.failed, AssertionError)
    assert j[-1] - j[0] > 100 * CURVE_ATOL
    assert not j[-1] < j[0]
    assert not t[-1] < t[0]


def test_resumed_equals_straight_bit_for_bit(port_runs):
    a, b = port_runs["resumed"], port_runs["straight"]
    assert b["resumed_at"] == STEPS
    assert a["losses"] == b["losses"]
    for x, y in zip(TAD.tree_leaves((a["params"], a["opt"])),
                    TAD.tree_leaves((b["params"], b["opt"]))):
        assert torch.equal(x, y)


def test_main_end_to_end(port, capsys):
    """The port's example at its defaults on its own seeded weights (bf16
    compute): on the CPU its curve falls by ~0.09 (6.792 -> 6.696-6.698,
    the last digit set by the thread count), so ``main`` returns with its
    own check passed, and prints the curve across the restart."""
    r = port.main(["--device", "cpu"])
    text = capsys.readouterr().out
    curve = [float(v) for v in re.search(r"loss curve: (.*)",
                                         text).group(1).split()]
    assert len(curve) == STEPS and f"resumed at step {CRASH_AT}" in text
    assert [round(v, 3) for v in r["losses"]] == curve
    assert "resume OK" in text
