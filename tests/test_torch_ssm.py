"""The port's ``models.ssm`` (Mamba2's chunked SSD, RWKV6's chunked WKV and
their decode steps) against the JAX package's on the CPU, on the same
numpy inputs and JAX's weights carried across. The traps: the biased
variance of RWKV's group norm (``jnp.var``; ``torch.var`` corrects by 1),
the masks on the exponents, and the scans and states kept in f32 under
bf16 compute. Tolerances as in ``tests/test_torch_layers.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as JSS

from repro_torch.models import lm as TLM
from repro_torch.models import ssm as TSS
from tests.test_torch_layers import (assert_close, both, cfg_pair, normal,
                                     params_pair)


def test_constants_equal_jax():
    assert TSS.RWKV_CHUNK == JSS.RWKV_CHUNK
    assert TSS.RWKV_LOGW_MIN == JSS.RWKV_LOGW_MIN


@pytest.mark.parametrize("n", [4, 64, 36])
def test_scan_chunks_is_lax_scan(n):
    """``_scan_chunks`` hands its body runs of consecutive chunks (all of
    them, or groups of 8 at 64 chunks while autograd records: the sqrt
    path; 36 is not a multiple of 8, so it takes one run); chained, the
    runs are ``lax.scan`` of the per-chunk body, carry, outputs and
    gradient."""
    xs = (torch.arange(3. * n).reshape(n, 3) / n, torch.ones(n, 2))

    def chunk(c, a, b):
        return c * 0.5 + a.sum() + b.sum(), c * a

    runs = []

    def run(c, inp):
        runs.append(inp[0].shape[0])
        ys = []
        for a, b in zip(*(t.unbind(0) for t in inp)):
            c, y = chunk(c, a, b)
            ys.append(y)
        return c, torch.stack(ys)
    c0 = torch.tensor(1.0, requires_grad=True)
    carry, ys = TSS._scan_chunks(run, c0, xs, n)
    assert runs == ([8] * 8 if n == 64 else [n])
    jc, jys = jax.lax.scan(
        lambda c, inp: chunk(c, *inp), jnp.asarray(1.0),
        tuple(jnp.asarray(t.numpy()) for t in xs))
    np.testing.assert_allclose(float(carry.detach()), float(jc), rtol=1e-6)
    np.testing.assert_allclose(ys.detach().numpy(), np.asarray(jys),
                               rtol=1e-6)
    (g,) = torch.autograd.grad(carry + ys.sum(), c0)
    gj = jax.grad(lambda c: (lambda r: r[0] + r[1].sum())(jax.lax.scan(
        lambda c, inp: chunk(c, *inp), c,
        tuple(jnp.asarray(t.numpy()) for t in xs))))(jnp.asarray(1.0))
    np.testing.assert_allclose(float(g), float(gj), rtol=1e-6)
    with torch.no_grad():
        runs.clear()
        TSS._scan_chunks(run, c0, xs, n)
        assert runs == [n]


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_equal_jax(with_state):
    xj, xt = both(normal((2, 9, 12), 1), "float32")
    kj, kt = both(normal((4, 12), 2), "float32")
    sj, st = both(normal((2, 3, 12), 3), "float32")
    yj, nj = JSS._causal_conv(xj, kj, sj if with_state else None)
    yt, nt = TSS._causal_conv(xt, kt, st if with_state else None)
    assert_close(yj, yt)
    np.testing.assert_array_equal(np.asarray(nj), nt.numpy())


def _ssd_inputs(b=2, s=64, h=3, p=4, n=5, dt_scale=1.0, seed=4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = (np.abs(rng.standard_normal((b, s, h))) * dt_scale).astype(
        np.float32)
    log_a = (-np.exp(rng.standard_normal(h)) * dt).astype(np.float32)
    bm = rng.standard_normal((b, s, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, n)).astype(np.float32)
    s0 = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return x, dt, log_a, bm, cm, s0


@pytest.mark.parametrize("chunk", [16, 64, 128])
@pytest.mark.parametrize("dt_scale", [1.0, 40.0])
def test_ssd_chunked_equal_jax(chunk, dt_scale):
    """Several chunks and one; at dt 40 a future pair's exponent reaches
    the hundreds, so ``exp`` of it is inf: masked in the exponent it is
    0, masked after the product inf * 0 would be NaN."""
    args = _ssd_inputs(dt_scale=dt_scale)
    yj, sj = JSS._ssd_chunked(*map(jnp.asarray, args), chunk)
    yt, st = TSS._ssd_chunked(*map(torch.as_tensor, args), chunk)
    assert_close(yj, yt)
    assert_close(sj, st)
    assert yt.dtype == st.dtype == torch.float32


def _mamba(dtype="float32"):
    jc, tc = cfg_pair("zamba2-1.2b", dtype)
    pj, pt = params_pair(jc)
    lj = jax.tree.map(lambda a: a[0, 0], pj["groups"])
    lt = TLM._layer(TLM._layer(pt["groups"], 0), 0)
    return jc, tc, lj, lt


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_mix_equal_jax(dtype):
    """Without a state, and from a carried state (the decode path); the
    SSM state stays f32 and the conv state takes the cache's dtype."""
    jc, tc, lj, lt = _mamba(dtype)
    f32 = dtype == "float32"
    xj, xt = both(normal((2, 32, jc.d_model), 5), dtype)
    oj, _ = JSS.mamba_mix(lj, xj, jc)
    ot, none = TSS.mamba_mix(lt, xt, tc)
    assert none is None and ot.dtype == xt.dtype
    assert_close(oj, ot, f32)
    state_j = jax.tree.map(
        lambda a: jnp.asarray(normal(a.shape, 6), a.dtype),
        JSS.init_mamba_state(jc, 2, jnp.bfloat16))
    state_t = TLM.params_from_jax(jax.tree.map(np.asarray, state_j),
                                  device="cpu")
    for s in (1, 16):
        oj, nj = JSS.mamba_mix(lj, xj[:, :s], jc, state_j)
        ot, nt = TSS.mamba_mix(lt, xt[:, :s], tc, state_t)
        assert_close(oj, ot, f32)
        assert_close(nj["ssm"], nt["ssm"], f32)
        assert_close(nj["conv"], nt["conv"], f32)
        assert nt["ssm"].dtype == torch.float32
        assert nt["conv"].dtype == torch.bfloat16


def test_mamba_decode_steps_equal_chunked_scan():
    """The port's recurrent steps, token by token, equal its chunked scan
    over the same tokens (f32)."""
    _, tc, _, lt = _mamba()
    x = torch.as_tensor(normal((2, 8, tc.d_model), 7))
    full, _ = TSS.mamba_mix(lt, x, tc)
    st = TSS.init_mamba_state(tc, 2, torch.float32, device="cpu")
    outs = []
    for t in range(8):
        o, st = TSS.mamba_decode_step(lt, x[:, t:t + 1], tc, st)
        outs.append(o)
    assert_close(full, torch.cat(outs, 1))


def _rwkv(dtype="float32"):
    jc, tc = cfg_pair("rwkv6-1.6b", dtype)
    pj, pt = params_pair(jc)
    return (jc, tc, jax.tree.map(lambda a: a[0], pj["layers"]),
            TLM._layer(pt["layers"], 0))


@pytest.mark.parametrize("logw_min", [False, True])
def test_wkv_chunked_equal_jax(logw_min):
    """Over 4 chunks of 16; with every log-decay at the clamp (-4), the
    factored form's exp(+cumsum) reaches e^64, still finite in f32."""
    rng = np.random.default_rng(8)
    b, s, h, k = 2, 64, 2, 8
    r, kk, v = (rng.standard_normal((b, s, h, k)).astype(np.float32)
                for _ in range(3))
    logw = (np.full((b, s, h, k), JSS.RWKV_LOGW_MIN, np.float32) if logw_min
            else -np.exp(rng.standard_normal((b, s, h, k))).clip(
                1e-5, 4).astype(np.float32))
    u = rng.standard_normal((h, k)).astype(np.float32)
    s0 = rng.standard_normal((b, h, k, k)).astype(np.float32)
    args = (r, kk, v, logw, u, s0)
    yj, sj = JSS._wkv_chunked(*map(jnp.asarray, args))
    yt, st = TSS._wkv_chunked(*map(torch.as_tensor, args))
    assert_close(yj, yt)
    assert_close(sj, st)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv_time_mix_equal_jax(dtype):
    """Its group norm divides by n, as ``jnp.var`` does; ``torch.var``'s
    default (n - 1) leaves the f32 bound."""
    jc, tc, lj, lt = _rwkv(dtype)
    f32 = dtype == "float32"
    xj, xt = both(normal((2, 32, jc.d_model), 9), dtype)
    oj, _ = JSS.rwkv_time_mix(lj["tm"], xj, jc)
    ot, _ = TSS.rwkv_time_mix(lt["tm"], xt, tc)
    assert_close(oj, ot, f32)
    state_j = jax.tree.map(
        lambda a: jnp.asarray(normal(a.shape, 10), a.dtype),
        JSS.init_rwkv_state(jc, 2, jnp.bfloat16)["tm"])
    state_t = TLM.params_from_jax(jax.tree.map(np.asarray, state_j),
                                  device="cpu")
    for s in (1, 16):
        oj, nj = JSS.rwkv_time_mix(lj["tm"], xj[:, :s], jc, state_j)
        ot, nt = TSS.rwkv_time_mix(lt["tm"], xt[:, :s], tc, state_t)
        assert_close(oj, ot, f32)
        assert_close(nj["wkv"], nt["wkv"], f32)
        assert_close(nj["shift"], nt["shift"], f32)
        assert nt["wkv"].dtype == torch.float32
        assert nt["shift"].dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv_layer_equal_jax(dtype):
    """Time mix + channel mix, without and with a state."""
    jc, tc, lj, lt = _rwkv(dtype)
    f32 = dtype == "float32"
    xj, xt = both(normal((2, 16, jc.d_model), 12), dtype)
    oj, _ = JSS.rwkv_layer(lj, xj, jc)
    ot, _ = TSS.rwkv_layer(lt, xt, tc)
    assert_close(oj, ot, f32)
    sj = JSS.init_rwkv_state(jc, 2, jnp.float32)
    st = TSS.init_rwkv_state(tc, 2, torch.float32, device="cpu")
    oj, nj = JSS.rwkv_layer(lj, xj, jc, sj)
    ot, nt = TSS.rwkv_layer(lt, xt, tc, st)
    assert_close(oj, ot, f32)
    assert_close(nj["cm"]["shift"], nt["cm"]["shift"], f32)
    cj, _ = JSS.rwkv_channel_mix(lj["cm"], xj, jc)
    ct, _ = TSS.rwkv_channel_mix(lt["cm"], xt, tc)
    assert_close(cj, ct, f32)


def test_rwkv_decode_steps_equal_chunked_scan():
    _, tc, _, lt = _rwkv()
    x = torch.as_tensor(normal((2, 16, tc.d_model), 13))
    full, _ = TSS.rwkv_layer(lt, x, tc)
    st = TSS.init_rwkv_state(tc, 2, torch.float32, device="cpu")
    outs = []
    for t in range(16):
        o, st = TSS.rwkv_layer(lt, x[:, t:t + 1], tc, st)
        outs.append(o)
    assert_close(full, torch.cat(outs, 1))


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "rwkv6-1.6b"])
def test_init_states_equal_jax(arch):
    """Shapes and dtypes as JAX's (the scans' states f32 whatever the
    cache dtype), each buffer its own storage."""
    jc, tc = cfg_pair(arch)
    init_j, init_t = ((JSS.init_mamba_state, TSS.init_mamba_state)
                      if arch.startswith("zamba")
                      else (JSS.init_rwkv_state, TSS.init_rwkv_state))
    sj = init_j(jc, 3, jnp.bfloat16)
    st = init_t(tc, 3, torch.bfloat16, device="cpu")
    lj = jax.tree_util.tree_leaves_with_path(sj)
    lt = jax.tree_util.tree_leaves_with_path(st)
    assert [(p, a.shape, str(a.dtype)) for p, a in lj] == [
        (p, tuple(t.shape), str(t.dtype).replace("torch.", ""))
        for p, t in lt]
    assert all(not t.any() for _, t in lt)
    ptrs = [t.data_ptr() for _, t in lt]
    assert len(set(ptrs)) == len(ptrs)


def test_ssd_chunk_size_leaves_the_result():
    """Another ``ssm_chunk`` (``dataclasses.replace``) chunks the same scan
    differently and gives the same output: the chip run's teacher-forced
    check of a 544-token sequence relies on it."""
    _, tc, _, lt = _mamba()
    x = torch.as_tensor(normal((2, 32, tc.d_model), 14))
    a, _ = TSS.mamba_mix(lt, x, tc)
    b, _ = TSS.mamba_mix(lt, x, dataclasses.replace(tc, ssm_chunk=8))
    assert_close(a, b)
