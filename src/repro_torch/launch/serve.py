"""Serving steps (port of ``repro.launch.serve``): LM decode
(``serve_step``) and prefill, and a greedy decoding loop.

Run as a script for a small end-to-end serving run, on the card by
default:
  python -m repro_torch.launch.serve --arch gemma3-1b
  python -m repro_torch.launch.serve --arch whisper-base --smoke --device cpu
"""
from __future__ import annotations

import argparse
import time
from typing import Any

import torch

from repro_torch.models import lm
from repro_torch.models.config import ModelConfig

Tree = Any


def make_serve_step(cfg: ModelConfig):
    """serve_step(params, cache, tokens [B,1]) -> (logits, cache')."""
    def serve_step(params, cache, tokens):
        return lm.decode_step(cfg, params, cache, tokens)
    return serve_step


def make_prefill(cfg: ModelConfig, max_len: int):
    def prefill_fn(params, batch):
        return lm.prefill(cfg, params, batch["tokens"], max_len,
                          patch_embeds=batch.get("patch_embeds"),
                          frames=batch.get("frames"))
    return prefill_fn


def greedy_decode(cfg: ModelConfig, params: Tree, prompt: torch.Tensor,
                  steps: int, max_len: int, **kw) -> torch.Tensor:
    """Batched greedy decoding loop: the ``steps`` tokens after
    ``prompt`` [B, S] as [B, steps] int32. The weights are cast to the
    compute dtype once, before the loop (``forward`` casts them again,
    which leaves cast leaves as they are)."""
    params = lm._cast_params(cfg, params)
    serve = make_serve_step(cfg)
    logits, cache = lm.prefill(cfg, params, prompt, max_len, **kw)
    tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    out = [tok]
    for _ in range(steps - 1):
        logits, cache = serve(params, cache, tok)
        tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        out.append(tok)
    return torch.cat(out, dim=1)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("serve: no CUDA device (pass --device cpu to run "
                         "on the CPU)")
    from repro_torch.configs import get_config, get_smoke_config
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(
        args.arch)
    with torch.inference_mode():
        gen = torch.Generator(device=device).manual_seed(0)
        params = lm.init_params(cfg, gen, device=device)
        gen = torch.Generator(device=device).manual_seed(1)
        prompt = torch.randint(0, cfg.vocab_size,
                               (args.batch, args.prompt_len),
                               generator=gen, device=device,
                               dtype=torch.int32)
        kw = {}
        if cfg.family == "vlm":
            kw["patch_embeds"] = torch.randn(
                (args.batch, cfg.patch_tokens, cfg.d_model), generator=gen,
                device=device)
        if cfg.family == "audio":
            kw["frames"] = torch.randn(
                (args.batch, cfg.num_mem_tokens, cfg.d_model),
                generator=gen, device=device)
        t0 = time.perf_counter()
        toks = greedy_decode(cfg, params, prompt, args.gen,
                             args.prompt_len + args.gen, **kw)
        toks = toks.cpu()
        dt = time.perf_counter() - t0
    print(f"decoded {tuple(toks.shape)} on {device} in {dt:.2f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s)")
    print(toks[0])


if __name__ == "__main__":
    main()
