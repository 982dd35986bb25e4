"""The port's ``models.layers`` against the JAX package's on the CPU: the
same numpy inputs and the same weights (JAX's ``init_params`` carried
across by ``lm.params_from_jax``) through both. Each place where
PyTorch's default differs from JAX's has a case that fails when the port
takes PyTorch's: GeLU's tanh form, top-k ties, the clamped cache write,
and q and k upcast before the attention product.

Tolerances: with f32 compute, max |diff| <= 1e-4 * max|ref| + 1e-5; with
bf16 compute, ``tests/test_models.py``'s 0.05 * max|ref| + 0.05."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE_CONFIGS
from repro.models import layers as JLY
from repro.models import lm as JLM

from repro_torch.configs import SMOKE_CONFIGS as T_SMOKE
from repro_torch.distributed.sharding import SINGLE_POD_RULES, use_rules
from repro_torch.models import layers as TLY
from repro_torch.models import lm as TLM


def to_torch(a):
    """A JAX or numpy array -> a CPU tensor with the same bits."""
    return TLM.params_from_jax(np.asarray(a), device="cpu")


def within(ref, got, f32: bool = True) -> bool:
    """The stated bound: f32 1e-4*scale + 1e-5; bf16 0.05*scale + 0.05."""
    ref = np.asarray(ref, np.float32)
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(
        got, np.float32)
    assert ref.shape == got.shape, (ref.shape, got.shape)
    scale = float(np.abs(ref).max()) if ref.size else 0.0
    diff = float(np.abs(ref - got).max()) if ref.size else 0.0
    bound = 1e-4 * scale + 1e-5 if f32 else 0.05 * scale + 0.05
    return bool(np.isfinite(got).all()) and diff <= bound


def assert_close(ref, got, f32: bool = True):
    ref32 = np.asarray(ref, np.float32)
    got32 = got.float().numpy() if torch.is_tensor(got) else np.asarray(
        got, np.float32)
    assert within(ref, got, f32), (
        f"max diff {np.abs(ref32 - got32).max()} at scale "
        f"{np.abs(ref32).max()} ({'f32' if f32 else 'bf16'} bound)")


def cfg_pair(arch: str, dtype: str = "float32"):
    """(JAX config, port config) of a smoke architecture at ``dtype``."""
    return (dataclasses.replace(SMOKE_CONFIGS[arch], dtype=dtype),
            dataclasses.replace(T_SMOKE[arch], dtype=dtype))


def params_pair(cfg, seed: int = 0):
    """JAX's ``init_params`` cast to the compute dtype, and the same tree
    carried into the port."""
    p = JLM._cast_params(cfg, JLM.init_params(cfg, jax.random.PRNGKey(seed)))
    return p, TLM.params_from_jax(jax.tree.map(np.asarray, p), device="cpu")


def normal(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def both(a, dtype: str):
    """numpy -> (JAX array, tensor) at ``dtype`` with the same bits."""
    j = jnp.asarray(a, jnp.dtype(dtype))
    return j, to_torch(j)


def test_constants_and_spec_equal_jax():
    assert TLY._BLOCKWISE_THRESHOLD == JLY._BLOCKWISE_THRESHOLD
    assert (TLY.Q_CHUNK, TLY.KV_CHUNK) == (JLY.Q_CHUNK, JLY.KV_CHUNK)
    jf = {f.name: f.default for f in dataclasses.fields(JLY.P)}
    tf = {f.name: f.default for f in dataclasses.fields(TLY.P)}
    assert jf.keys() == tf.keys()
    assert tf["dtype"] is torch.float32 and tf["init"] == jf["init"]
    with pytest.raises(AssertionError):
        TLY.P((2, 3), (None,))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_equal_jax(dtype):
    xj, xt = both(normal((3, 5, 48), 1, 3.0), dtype)
    gj, gt = both(normal((48,), 2, 0.5), dtype)
    ref = JLY.rms_norm(xj, gj, 1e-6)
    got = TLY.rms_norm(xt, gt, 1e-6)
    assert got.dtype == xt.dtype
    assert_close(ref, got, f32=dtype == "float32")


def test_rope_equal_jax():
    pos = np.arange(5, 45)
    for theta in (10_000.0, 1_000_000.0):
        sj, cj = JLY.rope_table(jnp.asarray(pos), 32, theta)
        st, ct = TLY.rope_table(torch.as_tensor(pos), 32, theta)
        assert st.dtype == torch.float32
        assert_close(sj, st)
        assert_close(cj, ct)
        for dtype in ("float32", "bfloat16"):
            xj, xt = both(normal((2, 40, 3, 32), 3), dtype)
            assert_close(JLY.apply_rope(xj, sj, cj),
                         TLY.apply_rope(xt, st, ct), f32=dtype == "float32")


@pytest.mark.parametrize("window,kv_len,causal",
                         [(0, None, True), (7, None, True), (0, 30, True),
                          (5, 25, True), (0, None, False), (4, 20, False)])
def test_attn_mask_equal_jax(window, kv_len, causal):
    qp, kp = np.arange(10, 30), np.arange(40)
    ref = JLY._attn_mask(jnp.asarray(qp), jnp.asarray(kp),
                         jnp.asarray(window, jnp.int32),
                         None if kv_len is None else jnp.asarray(kv_len),
                         causal)
    got = TLY._attn_mask(torch.as_tensor(qp), torch.as_tensor(kp), window,
                         kv_len, causal)
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())


def test_attention_logits_upcast_before_product():
    """bf16 q and k with logits in the hundreds: JAX takes the products in
    f32 (``preferred_element_type``); logits rounded to bf16 (ulp 4 at
    ~1,000) would move the softmax far past the bf16 bound."""
    b, s, hkv, g, hd = 2, 24, 2, 2, 16
    qj, qt = both(normal((b, s, hkv, g, hd), 4, 30.0), "bfloat16")
    kj, kt = both(normal((b, s, hkv, hd), 5, 30.0), "bfloat16")
    vj, vt = both(normal((b, s, hkv, hd), 6), "bfloat16")
    pos = np.arange(s)
    ref = JLY._plain_attention(qj, kj, vj, jnp.asarray(pos), jnp.asarray(pos),
                               None, jnp.asarray(0, jnp.int32), True)
    got = TLY._plain_attention(qt, kt, vt, torch.as_tensor(pos),
                               torch.as_tensor(pos), None, 0, True)
    assert got.dtype == torch.bfloat16
    assert_close(ref, got, f32=False)
    logits = TLY._logits(qt, kt, hd ** -0.5)
    assert logits.dtype == torch.float32


@pytest.mark.parametrize("window", [0, 32])
@pytest.mark.parametrize("chunks", ["default", "small"])
def test_blockwise_attention_equal_jax(window, chunks, monkeypatch):
    """``_blockwise_attention`` against JAX's at windows 0 and 32, at the
    real chunk sizes and at small ones (several Q and KV chunks, with a
    cache-shaped KV past ``kv_len``); and against the port's plain
    attention (``test_models.test_blockwise_attention_matches_plain``)."""
    if chunks == "small":
        for mod in (JLY, TLY):
            monkeypatch.setattr(mod, "Q_CHUNK", 64)
            monkeypatch.setattr(mod, "KV_CHUNK", 96)
    b, sq, hkv, g, hd = 2, 256, 2, 2, 16
    cases = [(np.arange(sq), sq, None)]
    if chunks == "small":
        cases.append((np.arange(40, 40 + sq), 384, 40 + sq))
    for q_pos, sk, kv_len in cases:
        qj, qt = both(normal((b, sq, hkv, g, hd), 7), "float32")
        kj, kt = both(normal((b, sk, hkv, hd), 8), "float32")
        vj, vt = both(normal((b, sk, hkv, hd), 9), "float32")
        kv_pos = np.arange(sk)
        args_j = (jnp.asarray(q_pos), jnp.asarray(kv_pos),
                  None if kv_len is None else jnp.asarray(kv_len),
                  jnp.asarray(window, jnp.int32), True)
        args_t = (torch.as_tensor(q_pos), torch.as_tensor(kv_pos), kv_len,
                  window, True)
        ref = JLY._blockwise_attention(qj, kj, vj, *args_j)
        got = TLY._blockwise_attention(qt, kt, vt, *args_t)
        assert_close(ref, got)
        plain = TLY._plain_attention(qt, kt, vt, *args_t)
        np.testing.assert_allclose(plain.numpy(), got.numpy(), rtol=2e-3,
                                   atol=2e-3)


def test_gqa_attention_dispatch_equal_jax(monkeypatch):
    """The blockwise path runs when Sq * Sk passes the threshold and
    Sq >= 64, as in JAX; both paths equal JAX's."""
    for mod in (JLY, TLY):
        monkeypatch.setattr(mod, "_BLOCKWISE_THRESHOLD", 1 << 12)
    calls = []
    real = TLY._blockwise_attention
    monkeypatch.setattr(TLY, "_blockwise_attention",
                        lambda *a: calls.append(a[0].shape[1]) or real(*a))
    for sq, sk, blockwise in ((64, 128, True), (32, 256, False),
                              (64, 64, False)):
        qj, qt = both(normal((1, sq, 4, 8), 10), "float32")
        kj, kt = both(normal((1, sk, 2, 8), 11), "float32")
        vj, vt = both(normal((1, sk, 2, 8), 12), "float32")
        q_pos = np.arange(sk - sq, sk)
        ref = JLY.gqa_attention(qj, kj, vj, jnp.asarray(q_pos),
                                jnp.arange(sk), None,
                                jnp.asarray(16, jnp.int32))
        n0 = len(calls)
        got = TLY.gqa_attention(qt, kt, vt, torch.as_tensor(q_pos),
                                torch.arange(sk), None, 16)
        assert (len(calls) > n0) == blockwise, (sq, sk)
        assert_close(ref, got)


@pytest.mark.parametrize("start", [0, 3, 9, 11, 20, -2])
def test_cache_write_clamps_as_dynamic_update_slice(start):
    """``write_cache`` puts the update where ``lax.dynamic_update_slice``
    does: the start clamped into [0, Smax - S] (a plain slice assignment
    fails or writes elsewhere past the end)."""
    buf = normal((2, 12, 3, 4), 13)
    new = normal((2, 3, 3, 4), 14)
    ref = jax.lax.dynamic_update_slice(jnp.asarray(buf), jnp.asarray(new),
                                       (0, start, 0, 0))
    got = TLY.write_cache(torch.as_tensor(buf.copy()), torch.as_tensor(new),
                          start)
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())


@pytest.mark.parametrize("length", [0, 5, 14])
def test_attention_block_with_cache_equal_jax(length):
    """A cached attention block against JAX's, the new K/V written at
    ``len`` and, at 14 + 4 > 16, at the clamped start; the cache's ``len``
    advances by Sq unclamped, as JAX's."""
    jc, tc = cfg_pair("gemma3-1b")
    pj, pt = params_pair(jc)
    aj = jax.tree.map(lambda a: a[0], pj["layers"]["attn"])
    at = TLM._layer(pt["layers"]["attn"], 0)
    b, sq, smax = 2, 4, 16
    xj, xt = both(normal((b, sq, jc.d_model), 15), "float32")
    cache0 = normal((b, smax, jc.num_kv_heads, jc.hd), 16)
    pos = np.arange(length, length + sq)
    jcache = {"k": jnp.asarray(cache0), "v": jnp.asarray(cache0 * 2),
              "len": jnp.asarray(length, jnp.int32)}
    tcache = {"k": torch.as_tensor(cache0.copy()),
              "v": torch.as_tensor(cache0 * 2), "len": length}
    for window in (0, 3):
        oj, cj = JLY.attention_block(aj, xj, jnp.asarray(pos), jc,
                                     jnp.asarray(window, jnp.int32),
                                     cache=jcache)
        ot, ct = TLY.attention_block(at, xt, torch.as_tensor(pos), tc,
                                     window, cache=dict(tcache))
        assert_close(oj, ot)
        assert_close(cj["k"], ct["k"])
        assert_close(cj["v"], ct["v"])
        assert ct["len"] == int(cj["len"]) == length + sq
        assert isinstance(ct["len"], int)


def test_cross_attention_equal_jax():
    jc, tc = cfg_pair("whisper-base")
    pj, pt = params_pair(jc)
    aj = jax.tree.map(lambda a: a[0], pj["layers"]["cross"])
    at = TLM._layer(pt["layers"]["cross"], 0)
    xj, xt = both(normal((2, 6, jc.d_model), 17), "float32")
    mj, mt = both(normal((2, 10, jc.d_model), 18), "float32")
    pos = np.arange(6)
    oj, _ = JLY.attention_block(aj, xj, jnp.asarray(pos), jc,
                                jnp.asarray(0, jnp.int32), memory=mj)
    ot, c = TLY.attention_block(at, xt, torch.as_tensor(pos), tc, 0,
                                memory=mt)
    assert c is None
    assert_close(oj, ot)


def test_gelu_is_the_tanh_approximation():
    """``jax.nn.gelu`` defaults to the tanh form; torch's default (erf)
    differs from it by up to ~5e-4."""
    x = np.linspace(-6, 6, 4001).astype(np.float32)
    ref = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = TLY.gelu(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    exact = torch.nn.functional.gelu(torch.as_tensor(x)).numpy()
    assert np.abs(exact - ref).max() > 1e-4


@pytest.mark.parametrize("arch,gated", [("stablelm-3b", True),
                                        ("gemma3-1b", True),
                                        ("whisper-base", False)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_block_equal_jax(arch, gated, dtype):
    jc, tc = cfg_pair(arch, dtype)
    pj, pt = params_pair(jc)
    mj = jax.tree.map(lambda a: a[0], pj["layers"]["mlp"])
    mt = TLM._layer(pt["layers"]["mlp"], 0)
    xj, xt = both(normal((2, 8, jc.d_model), 19, 2.0), dtype)
    assert_close(JLY.mlp_block(mj, xj, jc, gated=gated),
                 TLY.mlp_block(mt, xt, tc, gated=gated),
                 f32=dtype == "float32")


def test_top_k_breaks_ties_to_the_lower_index():
    x = np.array([[1, 3, 3, 0, 3, 2, 2, 3], [5, 5, 5, 5, 5, 5, 5, 5],
                  [0, 1, 2, 3, 4, 5, 6, 7]], np.float32)
    for k in (1, 3, 5, 8):
        vj, ij = jax.lax.top_k(jnp.asarray(x), k)
        vt, it = TLY.top_k(torch.as_tensor(x), k)
        np.testing.assert_array_equal(np.asarray(ij), it.numpy())
        np.testing.assert_array_equal(np.asarray(vj), vt.numpy())


def _moe_params(arch, dtype="float32", zero_router=False):
    jc, tc = cfg_pair(arch, dtype)
    pj, pt = params_pair(jc)
    mj = jax.tree.map(lambda a: a[0], pj["layers"]["moe"])
    mt = TLM._layer(pt["layers"]["moe"], 0)
    if zero_router:
        mj = dict(mj, router=jnp.zeros_like(mj["router"]))
        mt = dict(mt, router=torch.zeros_like(mt["router"]))
    return jc, tc, mj, mt


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b",
                                  "moonshot-v1-16b-a3b"])
@pytest.mark.parametrize("dispatch", ["dense", "capacity"])
@pytest.mark.parametrize("zero_router", [False, True])
def test_moe_block_equal_jax(arch, dispatch, zero_router):
    """Dense and capacity dispatch against JAX's, aux loss too. With a
    zero router every expert ties for every token and every token ties
    for every expert: JAX's ``top_k`` takes the lower indices."""
    jc, tc, mj, mt = _moe_params(arch, zero_router=zero_router)
    jc = dataclasses.replace(jc, moe_dispatch=dispatch)
    tc = dataclasses.replace(tc, moe_dispatch=dispatch)
    xj, xt = both(normal((2, 16, jc.d_model), 20), "float32")
    oj, auxj = JLY.moe_block(mj, xj, jc)
    ot, auxt = TLY.moe_block(mt, xt, tc)
    assert_close(oj, ot)
    assert float(auxt) == pytest.approx(float(auxj), rel=1e-5)


def test_capacity_dispatch_matches_dense_at_full_capacity():
    """``test_models``' case on the port: with capacity covering every
    token, the capacity dispatch equals the dense one."""
    cfg = T_SMOKE["qwen3-moe-235b-a22b"]
    gen = torch.Generator().manual_seed(7)
    params = TLM.init_params(cfg, gen, device="cpu")
    moe = TLM._layer(params["layers"]["moe"], 0)
    x = torch.randn((2, 64, cfg.d_model), generator=gen)
    cfg_cap = dataclasses.replace(
        cfg, moe_dispatch="capacity",
        moe_capacity_factor=float(cfg.num_experts) / cfg.experts_per_token)
    dense, aux1 = TLY.moe_block(moe, x, cfg)
    cap, aux2 = TLY.moe_block(moe, x, cfg_cap)
    np.testing.assert_allclose(dense.numpy(), cap.numpy(), rtol=2e-3,
                               atol=2e-3)
    assert float(aux1) == pytest.approx(float(aux2), rel=1e-4)


def test_capacity_dispatch_ep_on_a_one_rank_mesh_equals_plain(tmp_path):
    """Under a (1, 1) ("data", "model") ``DeviceMesh`` on a one-rank gloo
    group, capacity dispatch runs JAX's expert-parallel path
    (``_capacity_dispatch_ep``, once a call) and equals the plain
    ``_capacity_dispatch`` bit for bit, output and aux loss."""
    from tests.test_torch_sharding import world_of_one
    _, tc, _, mt = _moe_params("qwen3-moe-235b-a22b")
    tc = dataclasses.replace(tc, moe_dispatch="capacity")
    x = torch.as_tensor(normal((2, 24, tc.d_model), 13))
    plain, aux = TLY.moe_block(mt, x, tc)
    calls = []
    real = TLY._capacity_dispatch_ep

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    TLY._capacity_dispatch_ep = counted
    try:
        with world_of_one(tmp_path, (1, 1), ("data", "model")) as mesh:
            with use_rules(SINGLE_POD_RULES, mesh):
                out, aux_ep = TLY.moe_block(mt, x, tc)
            out, aux_ep = out.full_tensor(), aux_ep.full_tensor()
    finally:
        TLY._capacity_dispatch_ep = real
    assert len(calls) == 1
    assert torch.equal(out, plain) and torch.equal(aux_ep, aux)


@pytest.mark.parametrize("arch", ["gemma3-1b", "qwen3-moe-235b-a22b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_layer_equal_jax(arch, dtype):
    jc, tc = cfg_pair(arch, dtype)
    pj, pt = params_pair(jc)
    lj = jax.tree.map(lambda a: a[0], pj["layers"])
    lt = TLM._layer(pt["layers"], 0)
    xj, xt = both(normal((2, 24, jc.d_model), 21), dtype)
    pos = np.arange(24)
    window = jc.layer_windows()[0]
    oj, _, auxj = JLY.dense_layer(lj, xj, jnp.asarray(pos), jc,
                                  jnp.asarray(window, jnp.int32))
    ot, _, auxt = TLY.dense_layer(lt, xt, torch.as_tensor(pos), tc, window)
    assert_close(oj, ot, f32=dtype == "float32")
    assert float(auxt) == pytest.approx(float(auxj), rel=1e-3, abs=1e-6)
