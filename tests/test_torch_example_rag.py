"""``examples_torch/rag_serving.py`` against ``examples/rag_serving.py``
on the CPU.

JAX's example runs once in this process at gemma3-1b's smoke
configuration in f32 (its ``get_smoke_config`` global wrapped; greedy
tokens are compared in f32, where a near-tie of two logits cannot fall
differently in the two packages' bf16 roundings), with its
``build_segment``, ``lm`` and ``DS`` globals wrapped to keep the segment,
the weights, the prompt, every token fed to a decode step, the last
logits and each retrieval. The port's ``rag`` stage then runs on JAX's
weights (``lm.params_from_jax``), prompt and segment carried across:
the tokens, and each retrieval's ids, ``io`` and ``tier0_hits``, must be
equal, its dists within ROADMAP's device-search bound 2.5e-4. The port's
``main`` runs end to end once.
"""
import dataclasses
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.configs.starling_segment import SEGMENT_BENCH_DEVICE
from repro_torch.core import device_search as TDS
from repro_torch.models import lm as TLM
from tests.test_torch_example_quickstart import (  # noqa: F401
    carry, load_example, one_torch_thread, recorder, run_jax_example)

GEN, EVERY = 12, 4
DIST_ATOL = 2.5e-4


@pytest.fixture(scope="module")
def jax_rag(tmp_path_factory):
    mod = load_example("examples/rag_serving.py", "jax_rag_serving")
    smoke = mod.get_smoke_config
    mod.get_smoke_config = lambda arch: dataclasses.replace(
        smoke(arch), dtype="float32")
    built, params, retrieved = [], [], []
    prompts, fed, logits = [], [], []
    real_lm, real_ds = mod.lm, mod.DS

    def prefill(cfg, p, tokens, max_len):
        prompts.append(np.array(tokens))
        return real_lm.prefill(cfg, p, tokens, max_len)

    def decode_step(cfg, p, cache, tok):
        fed.append(np.asarray(tok))
        out = real_lm.decode_step(cfg, p, cache, tok)
        logits.append(np.asarray(out[0]))
        return out

    mod.lm = SimpleNamespace(
        init_params=recorder(real_lm.init_params, params),
        prefill=prefill, decode_step=decode_step)
    mod.DS = SimpleNamespace(
        from_segment=real_ds.from_segment, tier0_bytes=real_ds.tier0_bytes,
        device_anns=recorder(real_ds.device_anns, retrieved))
    mod.build_segment = recorder(mod.build_segment, built)
    text, failed = run_jax_example(mod)
    assert failed is None, failed
    # the tokens: each one fed to a decode step, then the last argmax
    tokens = np.concatenate(
        fed + [np.argmax(logits[-1][:, -1:], axis=-1)], axis=1)
    return SimpleNamespace(
        text=text, seg=carry(built[0], tmp_path_factory,
                             SEGMENT_BENCH_DEVICE),
        params=jax.tree.map(np.asarray, params[0]), prompt=prompts[0],
        tokens=tokens, retrieved=retrieved)


@pytest.fixture(scope="module")
def port():
    return load_example("examples_torch/rag_serving.py", "torch_rag_serving")


@pytest.fixture(scope="module")
def port_rag(jax_rag, port):
    cfg = dataclasses.replace(get_smoke_config("gemma3-1b"),
                              dtype="float32")
    params = TLM.params_from_jax(jax_rag.params, device="cpu")
    prompt = torch.as_tensor(jax_rag.prompt)
    ds = TDS.from_segment(jax_rag.seg, device="cpu")
    return port.rag(cfg, params, prompt, ds, GEN, EVERY)


def test_tokens_equal_jax(jax_rag, port_rag):
    assert port_rag["tokens"].shape == (2, GEN)
    np.testing.assert_array_equal(port_rag["tokens"], jax_rag.tokens)


@pytest.mark.parametrize("field", ["ids", "io", "tier0_hits", "dists"])
def test_retrievals_equal_jax(jax_rag, port_rag, field):
    got = port_rag["retrievals"]
    assert len(got) == len(jax_rag.retrieved) == (GEN - 1) // EVERY
    for g, r in zip(got, jax_rag.retrieved):
        want = np.asarray(getattr(r, field))
        if field == "dists":
            np.testing.assert_allclose(g[field], want, rtol=0,
                                       atol=DIST_ATOL)
        else:
            np.testing.assert_array_equal(g[field], want)


def test_printed_lines_equal_jax(jax_rag, port_rag):
    for g in port_rag["retrievals"]:
        assert (f"step {g['step']}: retrieved ctx ids "
                f"{g['ids'][0].tolist()} (cold DMAs {g['io'].tolist()}, "
                f"tier-0 hits {g['tier0_hits'].tolist()})"
                in jax_rag.text)


def test_main_end_to_end(port, capsys):
    """The port's example with its own weights, prompt and build."""
    r = port.main(["--device", "cpu"])
    text = capsys.readouterr().out
    assert r["tokens"].shape == (2, GEN)
    assert len(r["retrievals"]) == (GEN - 1) // EVERY
    for g in r["retrievals"]:
        assert g["ids"].shape == (2, 4) and (g["ids"] >= 0).all()
    assert "segment ready: OR(G)=" in text and "on cpu (cpu)" in text
