"""SIFT-shaped vectors made from a seed (a configuration's ``"generator":
"sift"``).

BIGANN's base set is SIFT descriptors: 128 non-negative integers in
[0, 255], each a histogram of gradient orientations normalised to unit
length, clipped at 0.2, normalised again and scaled by 512, with a low
intrinsic dimension. The generator keeps that shape: a Gaussian mixture
in a low-dimensional latent space, mapped linearly into 128-d, with
small isotropic noise, rectified (a histogram has no negative bins),
then SIFT's own normalisation, clip and rounding. Values are stored as
f32, as the segment stores them.

The data set is fixed by the configuration (``data_seed``: the mixture
and the base rows, in one order), as a deployment's data is: a run's
seed draws the queries, on a stream of their own, from the base's own
mixture, so queries are never base rows. (Ordering the rows by the run's
seed changed the build, and recall@10 with it, between 0.267 and 0.304
over one data set.)
"""
from __future__ import annotations

import copy
import dataclasses

import torch

from segbench.data import generator


@dataclasses.dataclass
class Mixture:
    centers: torch.Tensor      # [C, L]
    spreads: torch.Tensor      # [C]
    weights: torch.Tensor      # [C], sums to 1
    proj: torch.Tensor         # [L, D]
    bias: torch.Tensor         # [D]


def mixture(spec: dict, seed: int, device) -> Mixture:
    """The latent mixture and its map into ``spec["dim"]`` dimensions."""
    g = generator(seed, "mixture", device)
    c, lat, dim = spec["clusters"], spec["latent_dim"], spec["dim"]
    kw = dict(generator=g, device=device)
    centers = torch.randn(c, lat, **kw)
    lo, hi = spec["spread"]
    spreads = lo + (hi - lo) * torch.rand(c, **kw)
    # cluster sizes vary, lognormally, as visual words' do
    weights = torch.exp(spec["size_sigma"] * torch.randn(c, **kw))
    weights = weights / weights.sum()
    proj = torch.randn(lat, dim, **kw) / lat ** 0.5
    b_mean, b_std = spec["bias"]
    bias = b_mean + b_std * torch.randn(dim, **kw)
    return Mixture(centers, spreads, weights, proj, bias)


def sample(mix: Mixture, spec: dict, n: int, seed: int, stream: str,
           device, chunk: int = 1 << 18) -> torch.Tensor:
    """``n`` rows [n, D] f32 of integer values in [0, spec["clip"]]."""
    g = generator(seed, stream, device)
    out = torch.empty((n, spec["dim"]), dtype=torch.float32, device=device)
    kw = dict(generator=g, device=device)
    for s in range(0, n, chunk):
        m = min(chunk, n - s)
        a = torch.multinomial(mix.weights, m, replacement=True, generator=g)
        z = (mix.centers[a] + mix.spreads[a, None]
             * torch.randn(m, mix.centers.shape[1], **kw))
        v = z @ mix.proj + mix.bias + spec["noise"] * torch.randn(
            m, spec["dim"], **kw)
        v = torch.relu(v)
        # SIFT's normalisation: unit length, clip, unit length, x512
        v = v / v.norm(dim=1, keepdim=True).clamp_min(1e-12)
        v = v.clamp_max(spec["unit_clip"])
        v = v / v.norm(dim=1, keepdim=True).clamp_min(1e-12)
        out[s:s + m] = torch.round(v * spec["scale"]).clamp_(
            0, spec["clip"])
    return out


def base(spec: dict, n: int, device) -> torch.Tensor:
    """The configuration's ``n`` base rows."""
    mix = mixture(spec, spec["data_seed"], device)
    return sample(mix, spec, n, spec["data_seed"], "base", device)


def queries(spec: dict, n: int, seed: int, stream: str, device
            ) -> torch.Tensor:
    """``n`` rows of one named stream of the run's ``seed``, from the
    base's own mixture."""
    mix = mixture(spec, spec["data_seed"], device)
    return sample(mix, spec, n, seed, stream, device)


def tiny(spec: dict) -> dict:
    """The data group cut for a CPU test run: 16 clusters, so that a few
    hundred rows still hold several rows of each."""
    spec = copy.deepcopy(spec)
    spec["clusters"] = 16
    return spec
