"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 -m segbench.run --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once, from the root
of a checkout. The port lives under ``src/``; importing this package
puts it on ``sys.path``, so the command needs no ``PYTHONPATH``.
"""
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
_SRC = str(ROOT / "src")
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)
