"""The port's ``models.lm`` against the JAX package's on the CPU: the
parameter specs of all ten full configurations (nothing allocated),
``init_params``, ``params_from_jax``, and for every smoke architecture
``forward``, ``loss_fn`` / ``_chunked_ce`` and ``init_cache`` on JAX's
weights carried across; ``test_models.py``'s analytic-count case replayed
on the port. Tolerances as in ``tests/test_torch_layers.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, CONFIGS, SMOKE_CONFIGS
from repro.models import lm as JLM

from repro_torch.configs import CONFIGS as T_CONFIGS
from repro_torch.configs import SMOKE_CONFIGS as T_SMOKE
from repro_torch.models import layers as TLY
from repro_torch.models import lm as TLM
from tests.test_torch_layers import assert_close, cfg_pair, normal


def _flat(tree):
    """path -> leaf of a nested dict (either package's)."""
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        else:
            out[path] = t
    walk(tree, ())
    return out


def batch_np(cfg, b=2, s=32, seed=0):
    """Seeded tokens, next-token labels and the stub modality inputs."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, 1)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.standard_normal(
            (b, cfg.patch_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (b, cfg.num_mem_tokens, cfg.d_model)).astype(np.float32)
    return batch


def weights(cfg, seed=0):
    """JAX's f32 master weights and the same tree in the port."""
    p = JLM.init_params(cfg, jax.random.PRNGKey(seed))
    return p, TLM.params_from_jax(jax.tree.map(np.asarray, p), device="cpu")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_jax(arch):
    """Shape, axes, init and scale of every leaf of the full config, as
    ``P`` specs: nothing is allocated."""
    want = _flat(JLM.param_specs(CONFIGS[arch]))
    got = _flat(TLM.param_specs(T_CONFIGS[arch]))
    assert got.keys() == want.keys()
    for path, p in got.items():
        assert isinstance(p, TLY.P), path
        w = want[path]
        assert (p.shape, p.axes, p.init, p.scale) == (
            w.shape, w.axes, w.init, w.scale), path
        assert p.dtype is torch.float32


@pytest.mark.parametrize("arch", ["gemma3-1b", "zamba2-1.2b", "rwkv6-1.6b",
                                  "whisper-base"])
def test_init_params_shapes_and_seed(arch):
    """The tree, shapes and dtypes of JAX's ``init_params``; zeros and
    ones leaves equal JAX's; normal leaves seeded by the generator."""
    jc, tc = SMOKE_CONFIGS[arch], T_SMOKE[arch]
    want = _flat(JLM.init_params(jc, jax.random.PRNGKey(0)))
    got = _flat(TLM.init_params(tc, torch.Generator().manual_seed(0),
                                device="cpu"))
    again = _flat(TLM.init_params(tc, torch.Generator().manual_seed(0),
                                  device="cpu"))
    other = _flat(TLM.init_params(tc, torch.Generator().manual_seed(1),
                                  device="cpu"))
    specs = _flat(TLM.param_specs(tc))
    assert got.keys() == want.keys()
    for path, t in got.items():
        w = want[path]
        assert tuple(t.shape) == w.shape and t.dtype == torch.float32, path
        assert torch.equal(t, again[path])
        if specs[path].init == "normal":
            assert not torch.equal(t, other[path])
        else:
            np.testing.assert_array_equal(t.numpy(), np.asarray(w))


def test_params_from_jax_keeps_bits_and_len():
    tree = {"a": jnp.asarray(normal((3, 4), 1), jnp.bfloat16),
            "b": {"c": jnp.arange(5, dtype=jnp.int32)},
            "len": jnp.asarray(7, jnp.int32), "none": None}
    got = TLM.params_from_jax(jax.tree.map(np.asarray, tree), device="cpu")
    assert got["a"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got["a"].view(torch.int16).numpy(),
        np.asarray(tree["a"]).view(np.int16))
    assert got["b"]["c"].dtype == torch.int32
    assert got["len"] == 7 and isinstance(got["len"], int)
    assert got["none"] is None


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_equal_jax(arch, dtype):
    """Logits and the aux loss of ``forward`` on JAX's weights."""
    jc, tc = cfg_pair(arch, dtype)
    pj, pt = weights(jc)
    batch = batch_np(jc)
    kw = {k: batch[k] for k in ("patch_embeds", "frames") if k in batch}
    lj, _, aj = JLM.forward(jc, pj, jnp.asarray(batch["tokens"]),
                            **{k: jnp.asarray(v) for k, v in kw.items()})
    with torch.inference_mode():
        lt, cache, at = TLM.forward(tc, pt, torch.as_tensor(batch["tokens"]),
                                    **{k: torch.as_tensor(v)
                                       for k, v in kw.items()})
    assert cache is None
    assert lt.shape == (2, 32, jc.padded_vocab)
    assert lt.dtype == getattr(torch, dtype)
    assert_close(lj, lt, f32=dtype == "float32")
    assert float(at) == pytest.approx(float(aj), rel=1e-3, abs=1e-6)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_fn_equal_jax(arch):
    jc, tc = cfg_pair(arch)
    pj, pt = weights(jc, seed=1)
    batch = batch_np(jc, seed=1)
    batch["labels"][0, :5] = -1                   # masked positions
    (loss_j, mj) = JLM.loss_fn(jc, pj, jax.tree.map(jnp.asarray, batch))
    with torch.inference_mode():
        loss_t, mt = TLM.loss_fn(tc, pt, {k: torch.as_tensor(v)
                                          for k, v in batch.items()})
    assert_close(np.asarray(loss_j)[None], loss_t[None])
    for k in ("ce", "aux"):
        assert_close(np.asarray(mj[k])[None], mt[k][None])


def test_ce_chunks_equal_jax():
    for s in (1, 7, 32, 64, 1024, 4096, 6000):
        for v in (512, 16_383, 16_384, 32_000, 262_144):
            assert TLM._ce_chunks(s, v) == JLM._ce_chunks(s, v), (s, v)


@pytest.mark.parametrize("softcap,vocab", [(0.0, 40_000), (30.0, 40_000),
                                           (0.0, 32_768)])
def test_chunked_ce_equal_jax(softcap, vocab):
    """Several sequence chunks (S * V past 2^24), the soft cap and the
    padded vocab's mask (40,000 pads to 40,448)."""
    jc, tc = cfg_pair("gemma3-1b")                # tied embeddings
    jc = dataclasses.replace(jc, vocab_size=vocab, logit_softcap=softcap)
    tc = dataclasses.replace(tc, vocab_size=vocab, logit_softcap=softcap)
    s = 1024
    assert TLM._ce_chunks(s, jc.padded_vocab) >= 2
    rng = np.random.default_rng(2)
    emb = (rng.standard_normal((jc.padded_vocab, jc.d_model)) * 0.5).astype(
        np.float32)
    pj = {"embed": jnp.asarray(emb), "final_ln": jnp.zeros(jc.d_model)}
    pt = {"embed": torch.as_tensor(emb), "final_ln": torch.zeros(jc.d_model)}
    x = normal((2, s, jc.d_model), 3)
    labels = rng.integers(0, vocab, (2, s)).astype(np.int32)
    labels[1, ::3] = -1
    ref = JLM._chunked_ce(jc, pj, jnp.asarray(x), jnp.asarray(labels))
    got = TLM._chunked_ce(tc, pt, torch.as_tensor(x), torch.as_tensor(labels))
    assert_close(np.asarray(ref)[None], got[None])
    lj = JLM._unembed(jc, pj, jnp.asarray(x[:, :8]))
    lt = TLM._unembed(tc, pt, torch.as_tensor(x[:, :8]))
    assert_close(lj, lt)
    if jc.padded_vocab > vocab:
        assert float(lt[..., vocab:].max()) <= -1e29


def test_chunked_ce_matches_direct():
    """``test_models``' case on the port: ``_chunked_ce`` equals the CE of
    the full logits."""
    cfg = T_SMOKE["minitron-8b"]
    params = TLM.init_params(cfg, torch.Generator().manual_seed(4),
                             device="cpu")
    tokens = torch.as_tensor(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 64)).astype(np.int32))
    labels = torch.roll(tokens, -1, 1)
    x, _, _ = TLM._forward_hidden(cfg, params, tokens)
    ce = TLM._chunked_ce(cfg, params, x, labels)
    logits, _, _ = TLM.forward(cfg, params, tokens)
    lg = logits.float()
    naive = (torch.logsumexp(lg, -1)
             - torch.take_along_dim(lg, labels[..., None].long(),
                                    -1)[..., 0]).mean()
    assert float(ce) == pytest.approx(float(naive), rel=1e-3)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_init_cache_equal_jax(arch):
    """Shapes and dtypes of JAX's cache; every buffer its own storage (JAX
    binds one zeros array to K and V and broadcasts the SSM states: an
    in-place write would then reach both); ``len`` a host int."""
    jc, tc = SMOKE_CONFIGS[arch], T_SMOKE[arch]
    want = _flat(JLM.init_cache(jc, 3, 20))
    got = _flat(TLM.init_cache(tc, 3, 20, device="cpu"))
    assert got.keys() == want.keys()
    ptrs = []
    for path, t in got.items():
        w = want[path]
        if path == ("len",):
            assert t == 0 and isinstance(t, int)
            continue
        if w is None:
            assert t is None, path
            continue
        assert tuple(t.shape) == w.shape, path
        assert str(t.dtype).replace("torch.", "") == str(w.dtype), path
        assert not t.any() and 0 not in t.stride(), path
        ptrs.append(t.data_ptr())
    assert len(set(ptrs)) == len(ptrs)
    for dtype in (torch.float32, torch.bfloat16):
        c = TLM.init_cache(tc, 1, 4, dtype, device="cpu")
        if "k" in c:
            assert c["k"].dtype == c["v"].dtype == dtype


def test_num_params_analytic_close_to_actual():
    """``test_models``' case on the port."""
    for arch in ("stablelm-3b", "rwkv6-1.6b", "zamba2-1.2b"):
        cfg = T_SMOKE[arch]
        params = TLM.init_params(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
        actual = sum(t.numel() for t in _flat(params).values())
        assert abs(actual - cfg.num_params()) / actual < 0.35, arch


def test_cast_params_is_idempotent():
    cfg = T_SMOKE["gemma3-1b"]
    p = TLM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    once = TLM._cast_params(cfg, p)
    twice = TLM._cast_params(cfg, once)
    for path, t in _flat(once).items():
        assert t.dtype == torch.bfloat16
        assert _flat(twice)[path] is t
