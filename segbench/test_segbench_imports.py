"""Nothing that the benchmark runs loads JAX or the JAX package, and
nothing in it reads the JAX package's ``benchmarks/`` folder."""
import json
import os
import pathlib
import subprocess
import sys

from segbench import ROOT

HERE = pathlib.Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

PROBE = r"""
import json, sys, pathlib
import segbench.run, segbench.harness, segbench.control, segbench.sweep
import segbench.rehearsal, segbench.rehearsal_ip, segbench.tiny
from segbench import harness, tiny
here = pathlib.Path(harness.HERE)
for kind in ("loops", "systems", "references", "metrics", "generators"):
    for f in sorted((here / kind).glob("*.py")):
        harness.plugin(kind, f.stem)
import torch
torch.set_num_threads(1)
tiny.run(tiny.cell("bigann-1m.stream"), seconds=0.8, trace=True)
print(json.dumps(sorted({m.split(".")[0] for m in list(sys.modules)})))
"""


def test_a_run_loads_neither_jax_nor_the_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in tops and "segbench" in tops
    assert not tops & FORBIDDEN, tops & FORBIDDEN


def test_the_harness_reads_nothing_of_benchmarks():
    for f in HERE.rglob("*.py"):
        if f.name.startswith("test_"):
            continue
        text = f.read_text()
        assert "benchmarks/" not in text and "benchmarks." not in text, f
