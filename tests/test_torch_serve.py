"""The port's serving path (``lm.init_cache`` / ``prefill`` /
``decode_step`` and ``launch.serve``) against the JAX package's on the
CPU: for every smoke architecture a prefill and 4 decode steps on JAX's
weights carried across, with the caches compared too; ``greedy_decode``'s
tokens for gemma3, zamba2 and rwkv6; ``test_models.py``'s decode-versus-
forward case replayed on the port. Tolerances as in
``tests/test_torch_layers.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.launch import serve as JSV
from repro.models import lm as JLM

from repro_torch.configs import SMOKE_CONFIGS as T_SMOKE
from repro_torch.launch import serve as TSV
from repro_torch.models import layers as TLY
from repro_torch.models import lm as TLM
from tests.test_torch_layers import assert_close, cfg_pair
from tests.test_torch_lm import _flat, batch_np, weights


def _extras(batch, to):
    return {k: to(batch[k]) for k in ("patch_embeds", "frames")
            if k in batch}


def _rows_with_router_ties(cfg, run) -> set:
    """Batch rows in which the port's router met a top-k tie finer than
    bf16's resolution (the k-th and next probability closer than 2^-8 of
    the k-th) while ``run()`` ran. bf16 noise flips such a choice either
    way, and the row then leaves the bound for a discrete reason, as
    ``test_models.py`` says of the full MoE model in bf16."""
    rows = set()
    real = TLY.moe_block

    def spy(params, x, c):
        xn = TLY.rms_norm(x, params["ln"], c.norm_eps)
        probs = torch.softmax(xn.float() @ params["router"].float(), -1)
        top = probs.sort(-1, descending=True).values
        k = c.experts_per_token
        tie = (top[..., k - 1] - top[..., k]) < top[..., k - 1] / 256
        rows.update(torch.nonzero(tie.any(-1)).flatten().tolist())
        return real(params, x, c)
    TLY.moe_block = spy
    try:
        run()
    finally:
        TLY.moe_block = real
    return rows


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_equal_jax(arch, dtype):
    """A prefill of 16 tokens into a 24-long cache, then 4 decode steps
    (f32 compute with an f32 cache; bf16 with the default bf16 cache):
    the logits of each call and the cache after the last. In bf16 an MoE
    row whose routing met a tie within bf16's resolution is left out (at
    least one row stays); f32 holds every row."""
    jc, tc = cfg_pair(arch, dtype)
    f32 = dtype == "float32"
    pj, pt = weights(jc, seed=2)
    batch = batch_np(jc, s=20, seed=2)
    toks = batch["tokens"]
    cdt_j = jnp.float32 if f32 else jnp.bfloat16
    cdt_t = torch.float32 if f32 else torch.bfloat16
    outs_j, outs_t = [], []
    lj, cj = JLM.prefill(jc, pj, jnp.asarray(toks[:, :16]), 24,
                         cache_dtype=cdt_j, **_extras(batch, jnp.asarray))
    outs_j.append(lj)
    step = jax.jit(lambda p, c, tok: JLM.decode_step(jc, p, c, tok))
    for t in range(16, 20):
        lj, cj = step(pj, cj, jnp.asarray(toks[:, t:t + 1]))
        outs_j.append(lj)

    def run():
        lt, ct = TLM.prefill(tc, pt, torch.as_tensor(toks[:, :16]), 24,
                             cache_dtype=cdt_t,
                             **_extras(batch, torch.as_tensor))
        outs_t[:] = [lt]
        for t in range(16, 20):
            lt, ct = TLM.decode_step(tc, pt, ct,
                                     torch.as_tensor(toks[:, t:t + 1]))
            assert lt.shape == (2, 1, jc.padded_vocab)
            outs_t.append(lt)
        return ct
    with torch.inference_mode():
        if jc.family == "moe" and not f32:
            skip = _rows_with_router_ties(tc, run)
            ct = run()
        else:
            skip, ct = set(), run()
    rows = [r for r in range(2) if r not in skip]
    assert rows
    for lj, lt in zip(outs_j, outs_t):
        assert bool(torch.isfinite(lt.float()).all())
        assert_close(np.asarray(lj)[rows], lt[rows], f32)
    want, got = _flat(cj), _flat(ct)
    assert want.keys() == got.keys()
    for path, w in want.items():
        if path == ("len",):
            assert got[path] == int(w)
            assert int(w) == 20 + (jc.patch_tokens if jc.family == "vlm"
                                   else 0)
        elif w is not None:
            g = got[path]
            assert str(g.dtype).replace("torch.", "") == str(w.dtype)
            w = np.asarray(w)
            if skip:                      # an MoE cache: K/V [L, B, ...]
                w, g = w[:, rows], g[:, rows]
            assert_close(w, g, f32)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_matches_full_forward(arch):
    """``test_models``' case on the port: prefill + token-by-token decode
    equals the teacher-forced forward."""
    cfg = T_SMOKE[arch]
    params = TLM.init_params(cfg, torch.Generator().manual_seed(2),
                             device="cpu")
    b, s, mx = 2, 16, 24
    batch = batch_np(cfg, b, s, seed=3)
    tokens = torch.as_tensor(batch["tokens"])
    kw = _extras(batch, torch.as_tensor)
    with torch.inference_mode():
        full, _, _ = TLM.forward(cfg, params, tokens, **kw)
        pre = s - 4
        lp, cache = TLM.prefill(cfg, params, tokens[:, :pre], mx,
                                cache_dtype=torch.float32, **kw)
        outs = [lp]
        for t in range(pre, s):
            lg, cache = TLM.decode_step(cfg, params, cache,
                                        tokens[:, t:t + 1])
            outs.append(lg)
    inc = torch.cat(outs, dim=1).float()
    full = full.float()
    diff = float((full - inc).abs().max())
    scale = float(full.abs().max()) + 1e-6
    assert diff <= 0.05 * scale + 0.05


@pytest.mark.parametrize("arch", ["gemma3-1b", "zamba2-1.2b", "rwkv6-1.6b"])
def test_greedy_decode_tokens_equal_jax(arch):
    """8 greedy tokens after a 16-token prompt on JAX's weights: the same
    token ids. In f32: at bf16 the two packages' logits differ by bf16
    noise (up to ~0.06 at zamba2's scale of 0.66), past the gap between
    the best two tokens of some steps, and an argmax then flips."""
    jc, tc = cfg_pair(arch)
    pj, pt = weights(jc, seed=3)
    prompt = batch_np(jc, s=16, seed=4)["tokens"]
    want = JSV.greedy_decode(jc, pj, jnp.asarray(prompt), 8, 24)
    with torch.inference_mode():
        got = TSV.greedy_decode(tc, pt, torch.as_tensor(prompt), 8, 24)
    assert got.dtype == torch.int32 and got.shape == (2, 8)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_serve_steps_are_lm_calls():
    """``make_prefill`` / ``make_serve_step`` run ``lm.prefill`` /
    ``lm.decode_step``."""
    cfg = T_SMOKE["whisper-base"]
    params = TLM.init_params(cfg, torch.Generator().manual_seed(5),
                             device="cpu")
    batch = {k: torch.as_tensor(v)
             for k, v in batch_np(cfg, s=8, seed=5).items()}
    with torch.inference_mode():
        l1, c1 = TSV.make_prefill(cfg, 12)(params, batch)
        l2, c2 = TLM.prefill(cfg, params, batch["tokens"], 12,
                             frames=batch["frames"])
        assert torch.equal(l1, l2)
        tok = torch.zeros((2, 1), dtype=torch.int32)
        s1, _ = TSV.make_serve_step(cfg)(params, c1, tok)
        s2, _ = TLM.decode_step(cfg, params, c2, tok)
        assert torch.equal(s1, s2)


def test_main_runs_on_the_cpu_and_refuses_a_missing_card(capsys):
    TSV.main(["--arch", "rwkv6-1.6b", "--smoke", "--device", "cpu",
              "--gen", "4"])
    assert "decoded (2, 4) on cpu" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            TSV.main(["--arch", "rwkv6-1.6b", "--smoke"])
