"""SIFT-like corpus: byte-valued clustered descriptors in [low, high]^d.

The arithmetic of the repository's SIFT-like synthetic (`bench.py`, the
`else` arm of its corpus choice), made with torch on the device: the
centres uniform in [low, high]^d, each row a centre drawn uniformly plus
N(0, noise_sd^2) noise per coordinate, clipped to [low, high].
"""
from __future__ import annotations

import torch


def centres(spec: dict, gen: torch.Generator) -> torch.Tensor:
    lo, hi = float(spec["low"]), float(spec["high"])
    c = torch.rand((int(spec["centres"]), int(spec["dims"])), generator=gen,
                   device=gen.device, dtype=torch.float32)
    return c.mul_(hi - lo).add_(lo)


def draw(spec: dict, centres: torch.Tensor, n: int, gen: torch.Generator) -> torch.Tensor:
    pick = torch.randint(0, centres.shape[0], (n,), generator=gen, device=gen.device)
    x = torch.randn((n, centres.shape[1]), generator=gen, device=gen.device,
                    dtype=torch.float32)
    x.mul_(float(spec["noise_sd"])).add_(centres[pick])
    return x.clamp_(float(spec["low"]), float(spec["high"]))
