"""The port's ``configs`` package and ``models.config.ModelConfig``
against the JAX package's: every architecture's ``CONFIG`` and ``SMOKE``
field by field with their derived values, the shape grid, the registry,
every ``starling_segment`` preset, and the Example-2 accounting on the
port's ``LayoutParams``."""
import dataclasses

import pytest

import repro.core  # noqa: F401  (the JAX package's import order)
from repro import configs as JCFG
from repro.configs import starling_segment as JSS
from repro.core.params import LayoutParams as JLayoutParams

from repro_torch import configs as TCFG
from repro_torch.configs import starling_segment as TSS
from repro_torch.core.params import LayoutParams
from repro_torch.models import ModelConfig

DERIVED = ("padded_vocab", "hd", "q_dim", "kv_dim", "d_inner", "ssm_heads",
           "rwkv_heads")


def _derived(cfg):
    return ({name: getattr(cfg, name) for name in DERIVED},
            cfg.layer_windows(), cfg.num_params(), cfg.active_params())


@pytest.mark.parametrize("arch", JCFG.ARCH_IDS)
def test_arch_configs_equal_jax(arch):
    for get in ("get_config", "get_smoke_config"):
        t, j = getattr(TCFG, get)(arch), getattr(JCFG, get)(arch)
        assert isinstance(t, ModelConfig)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert _derived(t) == _derived(j)


def test_registry_and_shapes_equal_jax():
    assert TCFG.ARCH_IDS == JCFG.ARCH_IDS
    assert set(TCFG.CONFIGS) == set(JCFG.CONFIGS)
    assert set(TCFG.SMOKE_CONFIGS) == set(JCFG.SMOKE_CONFIGS)
    assert {k: dataclasses.asdict(v) for k, v in TCFG.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in JCFG.SHAPES.items()}
    assert TCFG.all_cells() == JCFG.all_cells()
    assert len(TCFG.all_cells()) == 40
    for arch, shape in JCFG.all_cells():
        assert TCFG.skip_reason(arch, shape) == JCFG.skip_reason(arch, shape)
        assert TCFG.cell_supported(arch, shape) == JCFG.cell_supported(
            arch, shape)
    for get in ("get_config", "get_smoke_config"):
        with pytest.raises(KeyError, match="unknown arch"):
            getattr(TCFG, get)("no-such-arch")


def test_model_config_checks_equal_jax():
    """``__post_init__`` rejects what JAX's rejects."""
    from repro.models.config import ModelConfig as JModelConfig
    base = dict(name="x", num_layers=2, d_model=64, num_heads=4,
                num_kv_heads=2, d_ff=128, vocab_size=1000)
    for family, extra in (("bogus", {}), ("moe", {}), ("hybrid", {}),
                          ("audio", {}), ("vlm", {}),
                          ("moe", dict(num_experts=4, experts_per_token=2,
                                       moe_d_ff=32)),
                          ("dense", dict(window=8, global_every=3))):
        kw = dict(base, family=family, **extra)
        try:
            want = _derived(JModelConfig(**kw))
        except AssertionError:
            with pytest.raises(AssertionError):
                ModelConfig(**kw)
            continue
        assert _derived(ModelConfig(**kw)) == want


def _names(mod):
    return sorted(n for n in dir(mod) if n.isupper())


def test_starling_segment_presets_equal_jax():
    assert _names(TSS) == _names(JSS)
    for name in _names(TSS):
        t, j = getattr(TSS, name), getattr(JSS, name)
        if dataclasses.is_dataclass(j):
            assert dataclasses.asdict(t) == dataclasses.asdict(j), name
        else:
            assert t == j, name
    assert dataclasses.asdict(TSS.DEVICE_SEARCH_BATCH) == dict(
        dataclasses.asdict(TSS.DEVICE_SEARCH_BENCH), fetch_width=2,
        compact_frac=0.25)


@pytest.mark.parametrize("name", sorted(JSS.PAPER_DATASETS))
def test_example2_accounting_on_port_layout(name):
    """``tests/test_accounting.py``'s Example-2 cases: ε and ρ of every
    paper dataset from the port's ``LayoutParams``, equal to JAX's."""
    n, d, b, lam, eta_kb, eps, rho = TSS.PAPER_DATASETS[name]
    lp, jp = LayoutParams(block_kb=eta_kb), JLayoutParams(block_kb=eta_kb)
    assert lp.verts_per_block(d, lam, b) == eps
    assert lp.num_blocks(n, d, lam, b) == rho
    assert lp.num_blocks(n, d, lam, b) == jp.num_blocks(n, d, lam, b)


def test_example2_bigann_block():
    """Example 2: BIGANN, γ = 128 + 4 + 31·4 = 256 B, ε = 16 per 4 KB
    block; a vertex that does not fit raises."""
    lp = LayoutParams(block_kb=4.0)
    assert lp.verts_per_block(128, 31, 1) == 16
    assert lp.num_blocks(33_000_000, 128, 31, 1) == 2_062_500
    assert lp.num_blocks(17, 128, 31, 1) == 2
    with pytest.raises(ValueError):
        LayoutParams(block_kb=0.1).verts_per_block(128, 31, 4)
