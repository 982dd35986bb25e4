"""The plain reference of a k-NN query node: exact L2 search by brute
force in float64, and the comparison that decides ``correct``.

Plain PyTorch, independent of the program: it is handed the generated
base rows and queries and the program's answers, and works out the
exact distances itself. On integer-valued rows below 2^26 a float64
product is exact, so its distances and its top-k are exact too.

``control`` is this reference put in the program's place one precision
down (bfloat16), the control that the comparison must refuse.
"""
from __future__ import annotations

import numpy as np
import torch


def _tf32_off() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def exact_topk(base: torch.Tensor, queries: torch.Tensor, k: int,
               block: int = 1 << 17):
    """(ids [S, k] int64, dists [S, k] float64): the k nearest base rows
    of each query, by squared L2 in float64, in blocks of base rows."""
    _tf32_off()
    q = queries.to(torch.float64)
    qq = (q * q).sum(1, keepdim=True)
    best_d = torch.full((q.shape[0], 0), float("inf"), dtype=torch.float64,
                        device=q.device)
    best_i = torch.zeros((q.shape[0], 0), dtype=torch.int64, device=q.device)
    for s in range(0, base.shape[0], block):
        x = base[s:s + block].to(torch.float64)
        d = (qq - 2.0 * q @ x.T + (x * x).sum(1)[None, :]).clamp_min_(0.0)
        kk = min(k, d.shape[1])
        bd, bi = torch.topk(d, kk, dim=1, largest=False)
        best_d = torch.cat([best_d, bd], 1)
        best_i = torch.cat([best_i, bi + s], 1)
        best_d, o = torch.topk(best_d, min(k, best_d.shape[1]), dim=1,
                               largest=False)
        best_i = torch.gather(best_i, 1, o)
    return best_i, best_d


def pair_dists(base: torch.Tensor, queries: torch.Tensor,
               ids: torch.Tensor) -> torch.Tensor:
    """[A, k] float64: the squared L2 distance of each query to each of
    its ids (ids must be valid)."""
    x = base[ids].to(torch.float64)
    return ((x - queries.to(torch.float64)[:, None, :]) ** 2).sum(-1)


def judge(base: np.ndarray, queries: np.ndarray, ids: np.ndarray,
          dists: np.ndarray, sample: np.ndarray, k: int, device,
          chunk: int = 16384) -> dict:
    """The numbers that decide ``correct`` for answers (ids [A, k],
    dists [A, k]) to ``queries`` [A, D] over ``base`` [N, D]:

    * ``bad_answers``: answers with an id outside [0, N), an id twice,
      a distance that is not finite, or distances not ascending;
    * ``dist_gap``: the largest |returned - exact| distance of a valid
      slot, over the exact distance (at least 1);
    * ``recall``: recall@k over the ``sample`` rows, a slot counting
      when its id's exact distance is within the exact k-th (ties count
      as found).
    """
    _tf32_off()
    n = base.shape[0]
    ids = np.asarray(ids, np.int64)
    dists = np.asarray(dists, np.float64)
    valid = (ids >= 0) & (ids < n)
    srt = np.sort(np.where(valid, ids, -1 - np.arange(k)[None, :]), 1)
    dup = (srt[:, 1:] == srt[:, :-1]).any(1)
    bad = (~valid.all(1)) | dup | (~np.isfinite(dists).all(1)) | (
        np.diff(dists, axis=1) < 0).any(1)
    xb = torch.as_tensor(base, device=device)
    gap = 0.0
    for s in range(0, ids.shape[0], chunk):
        v = torch.as_tensor(valid[s:s + chunk], device=device)
        i = torch.as_tensor(ids[s:s + chunk], device=device).clamp(0, n - 1)
        q = torch.as_tensor(queries[s:s + chunk], device=device)
        ex = pair_dists(xb, q, i)
        got = torch.as_tensor(dists[s:s + chunk], device=device)
        rel = ((got - ex).abs() / ex.clamp_min(1.0)).masked_fill(~v, 0.0)
        rel = rel.nan_to_num(nan=float("inf"))
        gap = max(gap, float(rel.max())) if rel.numel() else gap
    found = 0
    for s in range(0, len(sample), 2048):
        rows = sample[s:s + 2048]
        sq = torch.as_tensor(queries[rows], device=device)
        _, td = exact_topk(xb, sq, k)
        si = torch.as_tensor(ids[rows], device=device).clamp(0, n - 1)
        sv = torch.as_tensor(valid[rows] & ~dup[rows][:, None],
                             device=device)
        sd = pair_dists(xb, sq, si)
        found += int(((sd <= td[:, -1:] * (1 + 1e-12)) & sv).sum(1)
                     .clamp_max(k).sum())
    recall = found / max(len(sample) * k, 1)
    return {"bad_answers": int(bad.sum()), "dist_gap": gap,
            "recall": recall}


def control(base: torch.Tensor, queries: torch.Tensor, k: int,
            block: int = 1 << 17):
    """The reference in the program's place one precision down: the same
    brute force with its rows, products, norms and distances in
    bfloat16. Returns (ids [Q, k] int64, dists [Q, k] f32) as numpy."""
    dtype = torch.bfloat16
    q = queries.to(dtype)
    qq = (q * q).sum(1, keepdim=True)
    best_d = torch.full((q.shape[0], 0), float("inf"), dtype=dtype,
                        device=q.device)
    best_i = torch.zeros((q.shape[0], 0), dtype=torch.int64,
                         device=q.device)
    for s in range(0, base.shape[0], block):
        x = base[s:s + block].to(dtype)
        d = qq - 2.0 * (q @ x.T) + (x * x).sum(1)[None, :]
        bd, bi = torch.topk(d, min(k, d.shape[1]), dim=1, largest=False)
        best_d = torch.cat([best_d, bd], 1)
        best_i = torch.cat([best_i, bi + s], 1)
        best_d, o = torch.topk(best_d, min(k, best_d.shape[1]), dim=1,
                               largest=False)
        best_i = torch.gather(best_i, 1, o)
    return best_i.cpu().numpy(), best_d.float().cpu().numpy()
