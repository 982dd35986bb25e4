"""The port stands alone: no file of ``src/repro_torch`` and not
``chip_smoke.py`` imports ``jax`` or anything of the JAX package
``repro`` (the port keeps its own copies of what it needs)."""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
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
                "distributed/elastic.py", "launch/mesh.py"):
        assert pkg / mod in FILES


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported(path) if m.split(".")[0] in BANNED]
    assert not bad, f"{path.name} imports {bad}"
