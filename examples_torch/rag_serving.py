"""RAG bridge: an assigned-architecture LM decodes while querying a
Starling segment index for nearest-neighbor context every few steps —
the integration point between the paper's technique and the LM serving
substrate (DESIGN.md §Arch-applicability); the PyTorch port of
``examples/rag_serving.py``.

  PYTHONPATH=src python examples_torch/rag_serving.py --arch gemma3-1b
  PYTHONPATH=src python examples_torch/rag_serving.py --device cpu

The LM is the architecture's smoke configuration; the segment indexes
2,000 corpus vectors at its width. On the card each retrieval's rounds
run the fused CUDA round kernels (``gather_union`` + ``t0_rank``).
"""
import argparse
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "src"))
sys.path.insert(0, HERE)

import torch  # noqa: E402

from _card import check_device, device_line, sync  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.configs.starling_segment import (  # noqa: E402
    SEGMENT_BENCH_DEVICE)
from repro_torch.core import device_search as DS  # noqa: E402
from repro_torch.core.params import DeviceSearchParams  # noqa: E402
from repro_torch.core.segment import build_segment  # noqa: E402
from repro_torch.data.vectors import clustered_vectors  # noqa: E402
from repro_torch.models import lm  # noqa: E402

RETRIEVE = DeviceSearchParams(k=4, candidates=32, max_hops=64)
BATCH, PROMPT_LEN = 2, 8


def index(corpus, params, device):
    """The corpus's segment and its device arrays. ``from_segment`` packs
    tier 0: exact copies of the hottest 10% of the blocks, held on the
    device beside the block store, which a round reads before the cold
    gather."""
    seg = build_segment(corpus, params, device=device)
    return seg, DS.from_segment(seg, device=device)


def make_prompt(cfg, device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(1)
    return torch.randint(0, cfg.vocab_size, (BATCH, PROMPT_LEN),
                         generator=gen, device=device, dtype=torch.int32)


def rag(cfg, params, prompt, ds, gen: int, every: int) -> dict:
    """Greedy decoding of ``gen`` tokens after ``prompt`` [B, S], with a
    ``device_anns`` retrieval every ``every`` steps whose queries are the
    embedding rows of the tokens just fed in. Returns the tokens [B, gen],
    each retrieval (its step, queries, ids, dists, ``io``,
    ``tier0_hits``), the prefill's ms and each decode step's ms."""
    device = prompt.device
    b, s = prompt.shape
    with torch.inference_mode():
        sync(device)
        t0 = time.perf_counter()
        logits, cache = lm.prefill(cfg, params, prompt, s + gen)
        tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        sync(device)
        prefill_ms = (time.perf_counter() - t0) * 1e3
        toks, decode_ms, retrievals = [tok], [], []
        for step in range(gen - 1):
            t0 = time.perf_counter()
            logits, cache = lm.decode_step(cfg, params, cache, tok)
            sync(device)
            decode_ms.append((time.perf_counter() - t0) * 1e3)
            # every few tokens, embed the hidden query (here: the
            # pre-logit representation proxy = embedding of the argmax
            # token) and retrieve neighbors from the segment; the cast
            # to f32 stays on the device (the weights may be bf16)
            if (step + 1) % every == 0:
                q = params["embed"][tok[:, 0].long()].float()
                r = DS.device_anns(ds, q.to(ds.device), RETRIEVE)
                got = {"step": step + 1, "queries": q.cpu().numpy(),
                       "ids": r.ids.cpu().numpy(),
                       "dists": r.dists.cpu().numpy(),
                       "io": r.io.cpu().numpy(),
                       "tier0_hits": r.tier0_hits.cpu().numpy()}
                retrievals.append(got)
                print(f"  step {step+1}: retrieved ctx ids "
                      f"{got['ids'][0].tolist()} "
                      f"(cold DMAs {got['io'].tolist()}, "
                      f"tier-0 hits {got['tier0_hits'].tolist()})")
            tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
            toks.append(tok)
    total_io = sum(int(r["io"].sum()) for r in retrievals)
    total_t0 = sum(int(r["tier0_hits"].sum()) for r in retrievals)
    print(f"decoded {gen} tokens x {b} seqs; total retrieval "
          f"block touches: {total_io + total_t0} "
          f"({total_io} cold DMAs + {total_t0} tier-0 hits)")
    return {"tokens": torch.cat(toks, dim=1).cpu().numpy(),
            "retrievals": retrievals, "prefill_ms": prefill_ms,
            "decode_ms": decode_ms}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--gen", type=int, default=12)
    ap.add_argument("--retrieve-every", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = check_device(args.device, "rag_serving")

    cfg = get_smoke_config(args.arch)
    print(f"== RAG serving: {cfg.name} + Starling segment ==")

    # corpus embeddings at the LM's width; the segment indexes them
    corpus = clustered_vectors(2000, cfg.d_model, num_clusters=16, seed=0)
    seg, ds = index(corpus, SEGMENT_BENCH_DEVICE, device)
    print(f"segment ready: OR(G)={seg.overlap_ratio:.3f} "
          f"tier0={DS.tier0_bytes(ds)}B")

    params = lm.init_params(cfg, torch.Generator(device=device)
                            .manual_seed(0), device=device)
    out = rag(cfg, params, make_prompt(cfg, device), ds, args.gen,
              args.retrieve_every)
    out.update(seg=seg, ds=ds)
    print(f"prefill {out['prefill_ms']:.3f} ms, decode "
          f"{sum(out['decode_ms']) / len(out['decode_ms']):.3f} ms a step "
          f"on {device.type} ({device_line(device)})")
    return out


if __name__ == "__main__":
    main()
