"""Seeds for the data generators (``segbench/generators/<name>.py``).

Every array a generator makes comes from ``torch.Generator``s on the
given device, each seeded from ``(seed, stream)``, so the same seed gives
the same arrays on the same kind of device, and a stream never repeats
another's draws.
"""
from __future__ import annotations

import hashlib

import torch


def stream_seed(seed: int, stream: str) -> int:
    """A 63-bit generator seed for one named stream of a run's seed."""
    digest = hashlib.sha256(f"{int(seed)}:{stream}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def generator(seed: int, stream: str, device) -> torch.Generator:
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(stream_seed(seed, stream))
    return g
