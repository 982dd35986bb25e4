"""The port stands alone: no file of ``src/repro_torch``, of
``examples_torch`` and not ``chip_smoke.py`` imports ``jax`` or anything
of the JAX package ``repro`` (the port keeps its own copies of what it
needs)."""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + sorted(
    (ROOT / "examples_torch").glob("*.py")) + [ROOT / "chip_smoke.py"]
BANNED = ("jax", "jaxlib", "repro")


def _imported(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_has_files():
    assert len(FILES) > 10
    pkg = ROOT / "src" / "repro_torch"
    for src in ("tier0_fetch.cu", "l2_tile.cu", "pq_adc.cu",
                "block_topk.cu"):
        assert (pkg / "kernels" / "csrc" / src).exists()
    for mod in ("io/hottier.py", "kernels/block_topk.py",
                "core/navgraph.py", "core/device_search.py",
                "serving/coordinator.py", "core/iostats.py",
                "obs/__init__.py", "obs/roundlog.py", "core/search.py",
                "io/cache.py", "io/cached_store.py", "io/async_fetch.py",
                "io/prefetch.py", "serving/target.py",
                "serving/batcher.py", "serving/scheduler.py",
                "obs/calibrate.py", "obs/clock.py", "obs/trace.py",
                "obs/metrics.py", "obs/export.py", "serving/router.py",
                "distributed/elastic.py", "launch/mesh.py",
                "distributed/sharding.py", "distributed/compress.py",
                "configs/registry.py", "configs/shapes.py",
                "configs/starling_segment.py", "models/config.py",
                "models/layers.py", "models/ssm.py", "models/lm.py",
                "launch/serve.py", "launch/train.py", "optim/__init__.py",
                "optim/adamw.py", "data/pipeline.py", "ft/__init__.py",
                "ft/checkpoint.py", "ft/straggler.py", "launch/specs.py",
                "launch/dryrun.py", "distributed/hlo.py"):
        assert pkg / mod in FILES
    for arch in ("gemma3_1b", "granite_20b", "internvl2_1b", "minitron_8b",
                 "moonshot_16b", "qwen3_moe_235b", "rwkv6_1p6b",
                 "stablelm_3b", "whisper_base", "zamba2_1p2b"):
        assert pkg / "configs" / f"{arch}.py" in FILES
    for example in ("quickstart", "serve_segments", "rag_serving",
                    "train_resume"):
        assert ROOT / "examples_torch" / f"{example}.py" in FILES


# names of a JAX package's namespace the port does not export: TPU-only
NOT_EXPORTED = {
    "kernels": {"set_interpret", "interpret_default"},
}
# names the port exports beyond JAX's namespace
EXTRA = {"distributed": {"compress_with_feedback", "compressed_psum",
                         "dequantize", "ef_init", "quantize"},
         "kernels": {"LAUNCHES", "reset_launches"}}     # launch counts
PACKAGES = ("core", "io", "pq", "data", "kernels", "serving", "obs",
            "configs", "distributed", "models", "launch", "optim", "ft")


def _declared(init: pathlib.Path) -> set:
    """The public names a package's ``__init__`` binds by ``from ...
    import`` or lists in ``__all__``."""
    tree = ast.parse(init.read_text(), filename=str(init))
    names = set()
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            names.update(a.asname or a.name for a in node.names)
        elif (isinstance(node, ast.Assign)
              and any(getattr(t, "id", None) == "__all__"
                      for t in node.targets)):
            names.update(e.value for e in node.value.elts
                         if isinstance(e, ast.Constant))
    return {n for n in names if not n.startswith("_")}


@pytest.mark.parametrize("pkg", PACKAGES)
def test_package_exports_equal_jax(pkg):
    """Each port package exports JAX's names (less the TPU-only ones and
    those that wait for a later slice, plus the listed extras), and each
    resolves."""
    import importlib
    want = _declared(ROOT / "src" / "repro" / pkg / "__init__.py")
    got = _declared(ROOT / "src" / "repro_torch" / pkg / "__init__.py")
    assert got == (want - NOT_EXPORTED.get(pkg, set())) | EXTRA.get(pkg,
                                                                     set())
    mod = importlib.import_module(f"repro_torch.{pkg}")
    for name in got:
        assert getattr(mod, name) is not None, name


@pytest.mark.parametrize("module", ["ops", "tier0_fetch"])
def test_fused_round_defaults_equal_jax(module):
    """``fused_round``'s keyword defaults are JAX's (``fuse_union`` off),
    less the TPU-only ``interpret``, ``pipeline_dma`` and ``_force_dma``."""
    import importlib
    import inspect
    jax_fn = importlib.import_module(f"repro.kernels.{module}").fused_round
    port_fn = importlib.import_module(
        f"repro_torch.kernels.{module}").fused_round
    jax_fn = getattr(jax_fn, "__wrapped__", jax_fn)

    def defaults(fn):
        return {k: p.default for k, p in inspect.signature(fn)
                .parameters.items()
                if p.default is not inspect.Parameter.empty}
    want = {k: v for k, v in defaults(jax_fn).items()
            if k not in ("interpret", "pipeline_dma", "_force_dma")}
    assert defaults(port_fn) == want
    assert defaults(port_fn)["fuse_union"] is False


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported(path) if m.split(".")[0] in BANNED]
    assert not bad, f"{path.name} imports {bad}"
