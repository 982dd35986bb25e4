"""Deterministic, checkpointable token pipeline (numpy copy of
``repro.data.pipeline``: the same seed and step give the same batches).

Synthetic LM data with Zipfian unigram structure + induced bigram
correlations, so training losses actually decrease. The pipeline state
(a counter) is tiny and exact: restoring ``get_state()`` resumes the
stream bit-for-bit — the property the fault-tolerance tests assert.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


class TokenPipeline:
    def __init__(self, vocab: int, batch: int, seq: int, seed: int = 0):
        self.vocab = vocab
        self.batch = batch
        self.seq = seq
        self.seed = seed
        self.step = 0
        rng = np.random.default_rng(seed)
        ranks = np.arange(1, vocab + 1, dtype=np.float64)
        self._probs = (1.0 / ranks) / np.sum(1.0 / ranks)
        # fixed "grammar": token t prefers successor succ[t]
        self._succ = rng.permutation(vocab).astype(np.int64)

    def get_state(self) -> Dict:
        return {"step": int(self.step), "seed": self.seed}

    def set_state(self, state: Dict) -> None:
        assert state["seed"] == self.seed, "pipeline seed mismatch"
        self.step = int(state["step"])

    def _tokens(self, step: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, step))
        draws = rng.choice(self.vocab, size=(self.batch, self.seq),
                           p=self._probs)
        follow = rng.random((self.batch, self.seq)) < 0.5
        out = draws.copy()
        for t in range(1, self.seq):
            out[:, t] = np.where(follow[:, t], self._succ[out[:, t - 1]],
                                 draws[:, t])
        return out.astype(np.int32)

    def next_batch(self, cfg=None) -> Dict[str, np.ndarray]:
        toks = self._tokens(self.step)
        self.step += 1
        batch = {"tokens": toks,
                 "labels": np.concatenate(
                     [toks[:, 1:], np.full((self.batch, 1), -1,
                                           np.int32)], axis=1)}
        if cfg is not None and getattr(cfg, "family", "") == "vlm":
            rng = np.random.default_rng((self.seed, self.step, 7))
            batch["patch_embeds"] = rng.standard_normal(
                (self.batch, cfg.patch_tokens, cfg.d_model)).astype(
                np.float32)
        if cfg is not None and getattr(cfg, "family", "") == "audio":
            rng = np.random.default_rng((self.seed, self.step, 11))
            batch["frames"] = rng.standard_normal(
                (self.batch, cfg.num_mem_tokens, cfg.d_model)).astype(
                np.float32)
        return batch
