"""What the examples print beside a time: the card's name and power
limit as ``nvidia-smi`` reports them, or ``cpu``."""
from __future__ import annotations

import subprocess

import torch


def device_line(device) -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` of the first card on a
    CUDA device, ``cpu`` otherwise."""
    if torch.device(device).type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def check_device(device: str, name: str) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without a card
    ends the example (no quiet switch to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"{name}: no CUDA device (pass --device cpu to "
                         f"run on the CPU)")
    return dev


def sync(device) -> None:
    """Wait for the work queued on a CUDA ``device``; nothing on the CPU."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
