"""Text-to-Image-shaped vectors made from a seed (a configuration's
``"generator": "text2image"``).

The shape is that of the Text-to-Image set of the big-ann-benchmarks
NeurIPS'21 track (Yandex): base rows are image embeddings (SE-ResNeXt-101,
200-d float32), queries are text embeddings of a DSSM-style model trained
into the image space with a triplet-type loss, and similarity is the inner
product. The track calls the set cross-modal: queries and base have
different distributions. No file of that set is read; this model makes
rows of its shape from a seed.

The model. Both modalities embed the same topics, so they share latent
clusters: ``clusters`` centres in a ``latent_dim``-d space, N(0, I), each
with a within-topic spread drawn from ``spread`` (a standard deviation in
latent units, the centres' own scale being 1).

* An image row draws a topic from the image weights (lognormal sizes,
  ``size_sigma``), a latent point around its centre, and maps it by the
  image map A (``latent_dim`` x ``dim``, N(0, 1/latent_dim)). The mapped
  point is scaled to unit length, isotropic noise of norm about
  ``image_noise`` is added (the image tower's features the topics do not
  explain), and the row is scaled again to a norm drawn lognormal with
  ``norm_sigma``: image embeddings are not unit length, and the inner
  product's answers depend on the norms.
* A text row draws its topic from weights of its own (``query_size_sigma``,
  drawn apart from the image weights: what people search for is not what
  the image collection holds), a latent point as above, and maps it by the
  text map B = A + ``text_perturb`` x E, with E independent of A and of
  A's scale: the two towers agree on a topic only up to a seeded
  perturbation. To the unit-length text point it adds a fixed offset of
  norm ``modality_offset`` in one seeded direction (the modality gap that
  two-tower embeddings show: each modality sits in a cone of its own) and
  isotropic noise of norm about ``text_noise``, and is scaled to unit
  length: the ranking of a query's answers does not depend on its norm.

That puts queries off the base's manifold (the perturbation and the
offset lie mostly outside the span of A, where the base has only its
noise) while their nearest base rows by inner product still share their
topic, as a text query's relevant images do.

Sizes and shapes this file's model chooses, for a configuration's
``assumed``: ``latent_dim`` 32 (the span the topics vary in), ``clusters``
256, ``spread`` U(0.5, 1.0), ``size_sigma`` and ``query_size_sigma`` 0.5,
``image_noise`` 0.25, ``text_noise`` 0.25, ``norm_sigma`` 0.25,
``text_perturb`` 0.5, ``modality_offset`` 0.5 (``DATA_GROUP`` below). None
is a figure of the real data set.

The data set is fixed by the configuration (``data_seed``: the topics, the
maps, the offset and the base rows); a run's seed draws the queries, on
streams of their own.
"""
from __future__ import annotations

import copy
import dataclasses

import torch

from segbench.data import generator

# the data group of a Text-to-Image configuration, as this model was
# measured with (PERF.md)
DATA_GROUP = {
    "generator": "text2image",
    "data_seed": 0,
    "dim": 200,
    "latent_dim": 32,
    "clusters": 256,
    "spread": [0.5, 1.0],
    "size_sigma": 0.5,
    "query_size_sigma": 0.5,
    "image_noise": 0.25,
    "text_noise": 0.25,
    "norm_sigma": 0.25,
    "text_perturb": 0.5,
    "modality_offset": 0.5,
}


@dataclasses.dataclass
class Model:
    centers: torch.Tensor      # [C, L]
    spreads: torch.Tensor      # [C]
    image_weights: torch.Tensor    # [C], sums to 1
    text_weights: torch.Tensor     # [C], sums to 1
    image_map: torch.Tensor    # [L, D]
    text_map: torch.Tensor     # [L, D]
    offset: torch.Tensor       # [D], norm spec["modality_offset"]


def model(spec: dict, device) -> Model:
    """The topics, both maps and the modality offset of ``data_seed``."""
    g = generator(spec["data_seed"], "text2image-model", device)
    c, lat, dim = spec["clusters"], spec["latent_dim"], spec["dim"]
    kw = dict(generator=g, device=device)
    centers = torch.randn(c, lat, **kw)
    lo, hi = spec["spread"]
    spreads = lo + (hi - lo) * torch.rand(c, **kw)

    def weights(sigma):
        w = torch.exp(sigma * torch.randn(c, **kw))
        return w / w.sum()
    image_w = weights(spec["size_sigma"])
    text_w = weights(spec["query_size_sigma"])
    image_map = torch.randn(lat, dim, **kw) / lat ** 0.5
    text_map = image_map + spec["text_perturb"] * torch.randn(
        lat, dim, **kw) / lat ** 0.5
    offset = torch.randn(dim, **kw)
    offset = spec["modality_offset"] * offset / offset.norm()
    return Model(centers, spreads, image_w, text_w, image_map, text_map,
                 offset)


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / v.norm(dim=1, keepdim=True).clamp_min(1e-12)


def draw(spec: dict, n: int, seed: int, stream: str, side: str, device,
         chunk: int = 1 << 18):
    """(rows [n, D] f32, topics [n] int64): ``n`` rows of one stream,
    image rows for ``side`` "image", text rows for "text"."""
    m = model(spec, device)
    text = side == "text"
    weights = m.text_weights if text else m.image_weights
    proj = m.text_map if text else m.image_map
    noise = spec["text_noise" if text else "image_noise"]
    dim = spec["dim"]
    g = generator(seed, stream, device)
    kw = dict(generator=g, device=device)
    out = torch.empty((n, dim), dtype=torch.float32, device=device)
    topics = torch.empty(n, dtype=torch.int64, device=device)
    for s in range(0, n, chunk):
        k = min(chunk, n - s)
        a = torch.multinomial(weights, k, replacement=True, generator=g)
        z = m.centers[a] + m.spreads[a, None] * torch.randn(
            k, m.centers.shape[1], **kw)
        v = _unit(z @ proj)
        if text:
            v = v + m.offset
        # noise of norm about ``noise``: D entries of variance noise^2 / D
        v = v + noise / dim ** 0.5 * torch.randn(k, dim, **kw)
        v = _unit(v)
        if not text:
            v = v * torch.exp(spec["norm_sigma"] * torch.randn(
                k, 1, **kw))
        out[s:s + k] = v
        topics[s:s + k] = a
    return out, topics


def base(spec: dict, n: int, device) -> torch.Tensor:
    """The configuration's ``n`` base rows: image embeddings."""
    return draw(spec, n, spec["data_seed"], "base", "image", device)[0]


def queries(spec: dict, n: int, seed: int, stream: str, device
            ) -> torch.Tensor:
    """``n`` rows of one named stream of the run's ``seed``: text
    embeddings."""
    return draw(spec, n, seed, stream, "text", device)[0]


def tiny(spec: dict) -> dict:
    """The data group cut for a CPU test run: 16 topics, so that a few
    hundred rows still hold several rows of each."""
    spec = copy.deepcopy(spec)
    spec["clusters"] = 16
    return spec
