"""Shape and padding helpers.

Reproduces `vss_tpu/utils/shapes.py` on torch tensors.
"""
from __future__ import annotations

import torch


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pad_dim(x: torch.Tensor, axis: int, target: int, value=0) -> torch.Tensor:
    """Pad `x` along `axis` up to `target` with `value` (no copy if already there)."""
    cur = x.shape[axis]
    if cur == target:
        return x
    if cur > target:
        raise ValueError(f"cannot pad axis {axis} from {cur} down to {target}")
    shape = list(x.shape)
    shape[axis] = target - cur
    fill = torch.full(shape, value, dtype=x.dtype, device=x.device)
    return torch.cat([x, fill], dim=axis)


def pad_to(x: torch.Tensor, axis: int, multiple: int, value=0) -> torch.Tensor:
    """Pad along `axis` to the next multiple of `multiple`."""
    return pad_dim(x, axis, round_up(x.shape[axis], multiple), value)


def next_pow2(x: int, cap: int | None = None) -> int:
    """Smallest power of two >= x (>= 1); optionally clamped to `cap`."""
    p = 1
    while p < x:
        p *= 2
    return min(p, cap) if cap is not None else p
