"""Training step factory + end-to-end training loop (port of
``repro.launch.train``).

``make_train_step(cfg, opt)`` builds
``train_step(params, opt_state, batch) -> (params, opt_state, metrics)``
with microbatched gradient accumulation (``cfg.grad_accum``): a loop over
the microbatches, so one microbatch of activations is live at a time.
Gradients come from ``torch.autograd.grad`` on detached aliases of the
parameter leaves: the step leaves its inputs as they were and nothing in
``.grad``, and returns new trees. ``batch`` holds numpy arrays or
tensors; they go to the parameters' device.

Run as a script for a training run with checkpoint/restart, on the card
by default:
  python -m repro_torch.launch.train --arch gemma3-1b --smoke
  python -m repro_torch.launch.train --arch gemma3-1b --smoke --device cpu
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Any, Dict, Tuple

import torch

from repro_torch.distributed.sharding import shard, tree_map
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import P
from repro_torch.optim import (AdamW, adamw_init, adamw_update,
                               cosine_schedule)
from repro_torch.optim.adamw import tree_leaves, tree_like

Tree = Any


def _mixed_cast(cfg: ModelConfig, params: Tree) -> Tree:
    """fp32 master -> compute-dtype copy laid out by the parameter's
    logical axes (``shard``: the identity without a mesh), so that under
    a mesh the collectives move the narrow copy."""
    specs = []
    tree_map(specs.append, lm.param_specs(cfg),
             is_leaf=lambda x: isinstance(x, P))
    spec = iter(specs)
    dtype = getattr(torch, cfg.dtype)

    def one(p):
        axes = next(spec).axes
        if p.dtype != torch.float32:
            return p
        return shard(p.to(dtype), *axes)

    return tree_map(one, params)


def _to(batch: Dict, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, opt: AdamW):
    accum = max(cfg.grad_accum, 1)

    def grads_of(params: Tree, batch: Dict[str, torch.Tensor]):
        """(loss, metrics, grads) of ``lm.loss_fn`` at ``params``; the
        grads a tree like ``params`` (zeros where a leaf is unused)."""
        leaves = tree_leaves(params)
        live = [t.detach().requires_grad_() for t in leaves]
        with torch.enable_grad():
            p = tree_like(params, live)
            if cfg.mixed_state:
                p = _mixed_cast(cfg, p)
            loss, metrics = lm.loss_fn(cfg, p, batch)
            grads = torch.autograd.grad(loss, live, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g
                 for t, g in zip(live, grads)]
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                tree_like(params, grads))

    def train_step(params: Tree, opt_state: Dict, batch: Dict
                   ) -> Tuple[Tree, Dict, Dict]:
        device = tree_leaves(params)[0].device
        batch = _to(batch, device)
        if accum == 1:
            loss, metrics, grads = grads_of(params, batch)
        else:
            def split(x):
                if x.ndim == 0:
                    return [x] * accum
                b = x.shape[0]
                if b % accum:
                    raise ValueError(f"batch {b} does not split into "
                                     f"{accum} microbatches")
                m = b // accum
                if hasattr(x, "placements"):
                    # on a mesh: JAX's contiguous microbatches, each laid
                    # out by rows again (a rank's rows are not one
                    # microbatch's)
                    return [shard(x[i * m:(i + 1) * m], "batch",
                                  *([None] * (x.ndim - 1)))
                            for i in range(accum)]
                return x.reshape(accum, m, *x.shape[1:]).unbind(0)
            micro = {k: split(v) for k, v in batch.items()}
            loss_sum = torch.zeros((), dtype=torch.float32, device=device)
            grad_sum = [torch.zeros_like(p, dtype=torch.float32)
                        for p in tree_leaves(params)]
            for i in range(accum):
                mb = {k: v[i] for k, v in micro.items()}
                loss, _, grads = grads_of(params, mb)
                loss_sum = loss_sum + loss
                for s, g in zip(grad_sum, tree_leaves(grads)):
                    s.add_(g)
                del grads
            loss = loss_sum / accum
            grads = tree_like(params, [s.div_(accum) for s in grad_sum])
            metrics = {}

        params, opt_state, opt_metrics = adamw_update(
            opt, grads, opt_state, params)
        out = {"loss": loss, **opt_metrics}
        out.update(metrics)
        return params, opt_state, out

    train_step.grads_of = grads_of
    return train_step


def default_optimizer(total_steps: int = 10_000) -> AdamW:
    return AdamW(lr=cosine_schedule(3e-4, warmup=100, total=total_steps))


# ------------------------------------------------------------ entry point

def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("train: no CUDA device (pass --device cpu to run "
                         "on the CPU)")
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.ft.checkpoint import CheckpointManager

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(
        args.arch)
    opt = default_optimizer(args.steps)
    step_fn = make_train_step(cfg, opt)

    pipe = TokenPipeline(vocab=cfg.vocab_size, batch=args.batch,
                         seq=args.seq, seed=0)
    ckpt = CheckpointManager(args.ckpt_dir, keep=3)

    params = lm.init_params(cfg, torch.Generator(device).manual_seed(0),
                            device=device)
    opt_state = adamw_init(params)
    start = 0
    if args.resume and ckpt.latest_step() is not None:
        params, opt_state, pipe_state, start = ckpt.restore(
            params, opt_state)
        pipe.set_state(pipe_state)
        print(f"resumed from step {start}")

    t0 = time.time()
    for step in range(start, args.steps):
        batch = pipe.next_batch(cfg)
        # rebinding drops the old trees, as JAX's donated buffers go
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {float(metrics['loss']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"({(time.time() - t0):.1f}s)", flush=True)
        if (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, params, opt_state, pipe.get_state())
    print("done")


if __name__ == "__main__":
    main()
