"""Text-embedding-like corpus: unit-norm rows around a common direction.

A stand-in of the shape of OpenAI text-embedding-ada-002 vectors (each
row of norm 1, as the model returns them), made with torch on the device.
Such embeddings are anisotropic: they share a mean direction, so that two
unrelated texts have a cosine near 0.7, and related texts gather in
topics around it. Each row is

    normalise(sqrt(mean_share) m + sqrt(centre_share) c_k
              + sqrt(noise_share / d) n)

with m a unit direction and c_1 .. c_K the `centres` unit topic
directions (all from the seed), k drawn uniformly, and n standard normal
in every coordinate. In high d the three parts are nearly orthogonal and
the shares sum to 1, so a row's norm before the normalisation is about
1, two rows of different topics have a cosine near mean_share, and two
of one topic near mean_share + centre_share.
"""
from __future__ import annotations

import math

import torch


def centres(spec: dict, gen: torch.Generator) -> torch.Tensor:
    """[centres + 1, d]: row 0 the mean direction, then the topics."""
    raw = torch.randn((int(spec["centres"]) + 1, int(spec["dims"])), generator=gen,
                      device=gen.device, dtype=torch.float32)
    return raw / raw.norm(dim=1, keepdim=True)


def draw(spec: dict, centres: torch.Tensor, n: int, gen: torch.Generator) -> torch.Tensor:
    d = centres.shape[1]
    pick = torch.randint(1, centres.shape[0], (n,), generator=gen, device=gen.device)
    x = torch.randn((n, d), generator=gen, device=gen.device, dtype=torch.float32)
    x.mul_(math.sqrt(float(spec["noise_share"]) / d))
    x.add_(centres[pick], alpha=math.sqrt(float(spec["centre_share"])))
    x.add_(centres[0], alpha=math.sqrt(float(spec["mean_share"])))
    return x.div_(x.norm(dim=1, keepdim=True))
