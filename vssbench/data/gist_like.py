"""GIST-like corpus: non-negative clustered descriptors.

The arithmetic of the repository's GIST-like synthetic (`bench.py`, its
gist arm), made with torch on the device: the centres uniform in
[0, 1)^d, each row |centre + noise_sd * N(0, 1)| with the centre drawn
uniformly.
"""
from __future__ import annotations

import torch


def centres(spec: dict, gen: torch.Generator) -> torch.Tensor:
    return torch.rand((int(spec["centres"]), int(spec["dims"])), generator=gen,
                      device=gen.device, dtype=torch.float32)


def draw(spec: dict, centres: torch.Tensor, n: int, gen: torch.Generator) -> torch.Tensor:
    pick = torch.randint(0, centres.shape[0], (n,), generator=gen, device=gen.device)
    x = torch.randn((n, centres.shape[1]), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return x.mul_(float(spec["noise_sd"])).add_(centres[pick]).abs_()
