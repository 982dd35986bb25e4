"""Fault-tolerant training demo: train an assigned arch (reduced config),
kill mid-run, resume from the latest checkpoint, verify the loss curve
continues seamlessly (the PyTorch port of ``examples/train_resume.py``).

  PYTHONPATH=src python examples_torch/train_resume.py --arch rwkv6-1.6b
  PYTHONPATH=src python examples_torch/train_resume.py --device cpu

The train step is eager (no compilation); the checkpoints go to a
temporary directory that is removed at the end.
"""
import argparse
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "src"))
sys.path.insert(0, HERE)

import torch  # noqa: E402

from _card import check_device, sync  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data.pipeline import TokenPipeline  # noqa: E402
from repro_torch.ft.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.launch.train import (default_optimizer,  # noqa: E402
                                      make_train_step)
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402

CKPT_EVERY = 6
BATCH, SEQ = 4, 32


def init(cfg, device):
    return lm.init_params(cfg, torch.Generator(device=device)
                          .manual_seed(0), device=device)


def run(cfg, params, steps: int, crash_at: int, ckpt_dir: str,
        device) -> dict:
    """Train from ``params`` to step ``crash_at`` with a checkpoint every 6
    steps, restore the latest into fresh weights, and train on to
    ``steps``. Returns the loss curve, the resumed step, the final
    weights and optimizer state, each step's ms and each save's seconds
    and bytes."""
    step_fn = make_train_step(cfg, default_optimizer())
    ckpt = CheckpointManager(ckpt_dir, keep=2)
    pipe = TokenPipeline(cfg.vocab_size, batch=BATCH, seq=SEQ, seed=0)
    opt = adamw_init(params)
    losses, step_ms, saves = [], [], []

    def one(params, opt, pipe):
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, pipe.next_batch(cfg))
        losses.append(float(m["loss"]))          # syncs with the device
        step_ms.append((time.perf_counter() - t0) * 1e3)
        return params, opt

    print(f"training to step {crash_at}, then 'crashing' ...")
    for step in range(crash_at):
        params, opt = one(params, opt, pipe)
        if (step + 1) % CKPT_EVERY == 0:
            t0 = time.perf_counter()
            path = ckpt.save(step + 1, params, opt, pipe.get_state())
            saves.append((time.perf_counter() - t0, sum(
                os.path.getsize(os.path.join(path, f))
                for f in os.listdir(path))))
            print(f"  step {step+1}: loss={losses[-1]:.4f} [checkpoint]")

    print("simulated node failure — restarting from latest checkpoint")
    params2 = init(cfg, device)                           # fresh proc
    opt2 = adamw_init(params2)
    t0 = time.perf_counter()
    params2, opt2, pipe_state, start = ckpt.restore(params2, opt2)
    sync(device)
    restore_s = time.perf_counter() - t0
    pipe2 = TokenPipeline(cfg.vocab_size, batch=BATCH, seq=SEQ, seed=0)
    pipe2.set_state(pipe_state)
    print(f"resumed at step {start}")
    for _ in range(start, steps):
        params2, opt2 = one(params2, opt2, pipe2)
    return {"losses": losses, "resumed_at": start, "params": params2,
            "opt": opt2, "step_ms": step_ms, "saves": saves,
            "restore_s": restore_s}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rwkv6-1.6b")
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--crash-at", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = check_device(args.device, "train_resume")

    cfg = get_smoke_config(args.arch)
    print(f"== fault-tolerant training: {cfg.name} ==")
    with tempfile.TemporaryDirectory(prefix="repro_ckpt_") as d:
        out = run(cfg, init(cfg, device), args.steps, args.crash_at, d,
                  device)
    losses = out["losses"]
    print("loss curve:", " ".join(f"{l:.3f}" for l in losses))
    assert losses[-1] < losses[0], "loss should decrease"
    print("resume OK — loss continued decreasing across the restart")
    return out


if __name__ == "__main__":
    main()
