"""Build and load the CUDA kernels of this package.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into
a shared library with a plain C interface, in ``build/kernels/`` at the
root of the checkout (``.gitignore`` lists ``build/``), and loaded with
``ctypes``. The library's file name carries a hash of its source, so an
edited source is rebuilt and an unchanged one is reused. Nothing is
compiled or loaded when this module is imported.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

P, I = ctypes.c_void_p, ctypes.c_int
# C signatures of every entry point, by source
SIGNATURES = {
    "tier0_fetch": {
        "t0_union_in_smem": [I],
        "t0_gather_union": [P, I, P, P, P, P, I, I, I, I, P, P, P, P, P, P],
        "t0_gather": [P, I, P, P, P, I, I, I, I, P, P, P, P],
        "t0_rank": [P, P, P, P, I, P, I, P, P, P, I, P, P, P, I, I, I, I,
                    I, I, I, I, P, P, P, P, P, P],
        "t0_fetch_rank": [P, P, I, I, P, I, P, I, P, I, I, I, P, P, P],
    },
    "l2_tile": {
        "l2_tile_f32": [P, P, I, I, I, I, P, P, P],
        "l2_tile_bf16": [P, P, I, I, I, I, P, P, P],
    },
    "pq_adc": {
        "pq_adc": [P, P, I, I, I, I, I, P, P],
    },
    "block_topk": {
        "block_topk": [P, P, I, I, I, I, I, P, P, P],
    },
}

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return found


def _lib_path(name: str, src: Path = None) -> Path:
    src = CSRC / f"{name}.cu" if src is None else src
    tag = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()
                         ).hexdigest()
    return BUILD_DIR / f"lib{name}_{tag[:12]}.so"


def build(names: List[str] = None,
          sources: Dict[str, Path] = None) -> Dict[str, Path]:
    """Compile every named source that has no current library, one
    ``nvcc`` per source, all started together (``sources`` maps a name
    to another file than ``csrc/<name>.cu``). Returns the paths."""
    names = list(SIGNATURES) if names is None else names
    srcs = {n: (sources or {}).get(n, CSRC / f"{n}.cu") for n in names}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {n: _lib_path(n, srcs[n]) for n in names}
    procs = []
    for name, out in todo.items():
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(srcs[name])]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc failed on {srcs[name]}:\n{log.decode()}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return todo


def _bind(name: str, path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        lib = _loaded[name] = _bind(name, build([name])[name])
    return lib


def load_source(name: str, src) -> ctypes.CDLL:
    """A library built from another copy of ``csrc/<name>.cu`` (an
    earlier commit's, say) with the same flags, bound to the same C
    signatures: ``swapped`` runs it through the same wrappers."""
    return _bind(name, build([name], {name: Path(src)})[name])


@contextlib.contextmanager
def swapped(name: str, lib: ctypes.CDLL):
    """Inside the block, ``load(name)`` returns ``lib``."""
    saved = load(name)
    _loaded[name] = lib
    try:
        yield
    finally:
        _loaded[name] = saved


def check(code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")


def stream() -> int:
    """The current CUDA stream, as the C entry points take it."""
    import torch
    return torch.cuda.current_stream().cuda_stream


def require(what: str, **tensors) -> None:
    """Validate a kernel's CUDA operands, each given as (tensor, dtype or
    tuple of dtypes): one card, contiguous, an accepted dtype."""
    device = None
    for name, (t, dtypes) in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{what}: {name} is on {t.device}, not cuda")
        if device is not None and t.device != device:
            raise ValueError(f"{what}: operands on {device} and {t.device}")
        device = t.device
        dtypes = dtypes if isinstance(dtypes, tuple) else (dtypes,)
        if t.dtype not in dtypes:
            raise TypeError(f"{what}: {name} is {t.dtype}, needs {dtypes}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")
