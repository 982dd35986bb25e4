"""Product quantization for memory-resident routing (torch port of
``repro.pq.pq``, with its signatures and return types).

  train_pq     — per-subspace Lloyd k-means on a training sample ->
                 ``PQCodebook``
  encode_pq    — [N, M] uint8 codes
  adc_lut      — per-query [M, K] lookup table of subspace distances
  adc_lut_batch — [Q, M, K] for a batch of queries (``lut_host`` on
                 tensors, which the host search calls; the device
                 search's own tables are ``lut_batch``)
  adc_distance — sum of LUT entries along the codes, through
                 ``kernels.ops.pq_adc_batch`` (the ``pq_adc`` CUDA kernel on
                 the card)
  reconstruct  — decode codes back to vectors

Arrays go in and out as numpy, as in the JAX package; the work runs on
``device`` (a trailing keyword, the card unless the caller names the
CPU). The training sample and the initial centroids come from the same
numpy generator calls as the JAX package, so for the same data and seed
the codebooks agree to float tolerance and the codes are equal.

The two LUT forms keep the f32 order of their JAX twins, so the keys
equal theirs bit for bit: ``lut_batch`` adds the dsub terms in order, as
the device search's jnp ``_adc_lut``; ``lut_host`` adds them as numpy's
``einsum`` does in the JAX host search's ``adc_lut`` (four lanes of
chained adds, then a pairwise reduction of the lanes; ``ip``: numpy's
pairwise ``sum``), and ``pq_adc`` adds the M lookups in numpy's pairwise
order, as ``adc_distance``'s ``.sum(axis=1)``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.params import PQParams
from repro_torch.kernels import ops
from repro_torch.kernels.ref import pairwise_sum


@dataclasses.dataclass
class PQCodebook:
    centroids: np.ndarray     # [M, K, dsub] float32
    dim: int
    metric: str = "l2"

    @property
    def num_subspaces(self) -> int:
        return self.centroids.shape[0]

    @property
    def num_centroids(self) -> int:
        return self.centroids.shape[1]

    @property
    def dsub(self) -> int:
        return self.centroids.shape[2]

    def memory_bytes(self) -> int:
        return self.centroids.nbytes


def _lloyd(x: torch.Tensor, init: torch.Tensor, iters: int) -> torch.Tensor:
    """x [N, d], init [K, d] -> [K, d]. Empty clusters keep their
    centroid. The cluster sums are a one-hot matmul, as in JAX, so the
    result does not depend on the order of atomic adds."""
    cent = init
    xx = torch.sum(x * x, 1, keepdim=True)
    for _ in range(iters):
        d = xx + torch.sum(cent * cent, 1) - 2.0 * x @ cent.T
        a = torch.argmin(d, dim=1)
        one = torch.nn.functional.one_hot(a, cent.shape[0]).to(x.dtype)
        cnt = one.sum(0)
        tot = one.T @ x
        cent = torch.where(cnt[:, None] > 0,
                           tot / torch.clamp(cnt[:, None], min=1), cent)
    return cent


def train_pq(x: np.ndarray, p: PQParams, metric: str = "l2", *,
             device="cuda") -> PQCodebook:
    """Per-subspace Lloyd k-means on a sample of ``x`` [N, D]."""
    n, d = x.shape
    m = p.num_subspaces
    if d % m:
        raise ValueError(f"dim {d} not divisible by M={m}")
    dsub = d // m
    k = min(p.num_centroids, n)
    rng = np.random.default_rng(p.seed)
    sample = x[rng.choice(n, size=min(p.train_sample, n), replace=False)]
    cent = np.empty((m, p.num_centroids, dsub), np.float32)
    for j in range(m):
        sub = np.ascontiguousarray(sample[:, j * dsub:(j + 1) * dsub],
                                   np.float32)
        init = sub[rng.choice(sub.shape[0], size=k, replace=False)]
        c = _lloyd(torch.as_tensor(sub, device=device),
                   torch.as_tensor(init, device=device),
                   p.train_iters).cpu().numpy()
        if k < p.num_centroids:   # tiny datasets: tile to K
            reps = -(-p.num_centroids // k)
            c = np.tile(c, (reps, 1))[: p.num_centroids]
        cent[j] = c
    return PQCodebook(centroids=cent, dim=d, metric=metric)


def encode_pq(x, cb: PQCodebook, chunk: int = 65536, *,
              device="cuda") -> np.ndarray:
    """x [N, D] (numpy or tensor) -> codes [N, M] u8."""
    m, _, dsub = cb.centroids.shape
    n = x.shape[0]
    c = torch.as_tensor(cb.centroids, device=device)
    cc = torch.sum(c * c, -1)[None]                          # [1, M, K]
    out = np.empty((n, m), np.uint8)
    for s in range(0, n, chunk):
        xs = torch.as_tensor(x[s:s + chunk], device=device).to(
            torch.float32).reshape(-1, m, dsub)
        d = (torch.sum(xs * xs, -1)[:, :, None] + cc
             - 2.0 * torch.einsum("nmd,mkd->nmk", xs, c))
        out[s:s + chunk] = torch.argmin(d, dim=-1).to(
            torch.uint8).cpu().numpy()
    return out


def lut_batch(q: torch.Tensor, cent: torch.Tensor,
              metric: str = "l2") -> torch.Tensor:
    """q [Q, D], cent [M, K, dsub] (one device) -> LUTs [Q, M, K] f32:
    each sub-vector's squared distance to each centroid (explicit
    difference), or the negated partial inner product for ``ip``
    (summing stays "smaller is better"). The dsub terms are added in
    order, the order of the device search's ``_adc_lut`` in the JAX
    package on the CPU, so the tables equal its bits."""
    m, _, dsub = cent.shape
    qs = q.reshape(q.shape[0], m, 1, dsub).to(torch.float32)
    terms = cent[None] * qs if metric == "ip" else torch.square(
        cent[None] - qs)                                     # [Q, M, K, dsub]
    acc = terms[..., 0]
    for j in range(1, dsub):
        acc = acc + terms[..., j]
    return -acc if metric == "ip" else acc


def _einsum_sum(p: torch.Tensor) -> torch.Tensor:
    """p [..., d] -> [...]: numpy's ``einsum`` reduction of a contiguous
    axis of products (4 f32 lanes; lane l adds terms l, l+4, ...; each
    16-term step folds its four 4-term chunks into the lanes last to
    first; a tail chunk is zero-padded; the lanes reduce as
    (l0+l1)+(l2+l3))."""
    d = p.shape[-1]
    pad = (-d) % 4
    if pad:
        p = torch.nn.functional.pad(p, (0, pad))
    lanes = torch.zeros(p.shape[:-1] + (4,), dtype=p.dtype, device=p.device)
    pos, cnt = 0, d
    while cnt >= 16:
        c = [p[..., pos + 4 * i:pos + 4 * i + 4] for i in range(4)]
        lanes = c[0] + (c[1] + (c[2] + (c[3] + lanes)))
        pos, cnt = pos + 16, cnt - 16
    while cnt > 0:
        lanes = p[..., pos:pos + 4] + lanes
        pos, cnt = pos + 4, cnt - 4
    return ((lanes[..., 0] + lanes[..., 1])
            + (lanes[..., 2] + lanes[..., 3]))


def lut_host(q: torch.Tensor, cent: torch.Tensor,
             metric: str = "l2") -> torch.Tensor:
    """q [Q, D], cent [M, K, dsub] (one device) -> LUTs [Q, M, K] f32 in
    the f32 order of the JAX host search's numpy ``adc_lut``: the
    squared difference summed as ``einsum`` sums it, or for ``ip`` the
    negated pairwise ``sum`` of the products."""
    m, _, dsub = cent.shape
    qs = q.reshape(q.shape[0], m, 1, dsub).to(torch.float32)
    if metric == "ip":
        prod = cent[None] * qs                               # [Q, M, K, dsub]
        return -pairwise_sum([prod[..., j] for j in range(dsub)])
    diff = cent[None] - qs
    return _einsum_sum(diff * diff)


def adc_lut_batch(q, cb: PQCodebook, *, device="cuda") -> np.ndarray:
    """q [Q, D] -> LUTs [Q, M, K] f32 (``lut_host`` on ``device``)."""
    qt = torch.as_tensor(np.asarray(q, np.float32), device=device)
    return lut_host(qt, torch.as_tensor(cb.centroids, device=device),
                    cb.metric).cpu().numpy()


def adc_lut(q, cb: PQCodebook, *, device="cuda") -> np.ndarray:
    """One query [D] -> its LUT [M, K]."""
    return adc_lut_batch(np.asarray(q).reshape(1, -1), cb,
                         device=device)[0]


def adc_distance(lut, codes, *, device="cuda") -> np.ndarray:
    """lut [M, K], codes [n, M] -> [n] approximate distances, through
    the ``pq_adc`` kernel on ``device`` (its plain version on the CPU).
    Tensors already on ``device`` are used in place, so a caller that
    keeps the codes and the LUT there moves only the [n] keys back."""
    lt = torch.as_tensor(lut, dtype=torch.float32, device=device)
    ct = torch.as_tensor(codes, dtype=torch.uint8, device=device)
    return ops.pq_adc_batch(ct, lt[None])[0].cpu().numpy()


def reconstruct(codes: np.ndarray, cb: PQCodebook) -> np.ndarray:
    """Decode codes back to vectors (for error bounds in tests)."""
    m = cb.centroids.shape[0]
    parts = [cb.centroids[j, codes[:, j].astype(np.int64)]
             for j in range(m)]
    return np.concatenate(parts, axis=1)
