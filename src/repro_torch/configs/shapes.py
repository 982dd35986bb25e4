"""Assigned input shapes and the 40-cell (arch x shape) grid.

  train_4k     seq 4,096   batch 256  — train_step
  prefill_32k  seq 32,768  batch 32   — prefill (inference)
  decode_32k   seq 32,768  batch 128  — serve_step: 1 new token, 32k cache
  long_500k    seq 524,288 batch 1    — serve_step: 1 new token, 500k cache

``long_500k`` requires sub-quadratic attention: it runs only for the
SSM / hybrid / mostly-local archs (rwkv6, zamba2, gemma3 — gemma3's local
layers are O(w); its 1-in-6 global layers attend the full cache at O(S)
per decoded token, which is linear, noted in DESIGN.md). Pure
full-attention archs record a SKIP for this cell.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from repro_torch.configs.registry import ARCH_IDS, get_config


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": Shape("train_4k", "train", 4_096, 256),
    "prefill_32k": Shape("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": Shape("decode_32k", "decode", 32_768, 128),
    "long_500k": Shape("long_500k", "decode", 524_288, 1),
}

# archs allowed to run long_500k (sub-quadratic decode memory/compute)
_LONG_OK = ("zamba2-1.2b", "rwkv6-1.6b", "gemma3-1b")


def skip_reason(arch: str, shape_name: str) -> Optional[str]:
    if shape_name == "long_500k" and arch not in _LONG_OK:
        return ("full-attention arch: long_500k requires sub-quadratic "
                "attention (see DESIGN.md §Arch-applicability)")
    return None


def cell_supported(arch: str, shape_name: str) -> bool:
    return skip_reason(arch, shape_name) is None


def all_cells() -> List[Tuple[str, str]]:
    """The 40 (arch, shape) cells, including skipped ones."""
    return [(a, s) for a in ARCH_IDS for s in SHAPES]
