"""Shard slots for sharded indexes.

Reproduces `vss_tpu/parallel/mesh.py:12-30`. The JAX package builds a 1-D
`jax.sharding.Mesh` over distinct devices, and its tests get eight of them
as virtual XLA:CPU devices. A `Mesh` here is an ordered list of shard
slots, one `torch.device` each, and a device may hold several slots: four
slots on `cuda:0` is the port's counterpart of those virtual devices, and
what lets a 4-shard checkpoint open on one card. With several processes
(`parallel/multihost.py`) each slot also names the rank that owns it.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch

from vss_tpu_torch.utils import resolve_device

__all__ = ["Mesh", "make_mesh", "on_device", "SHARD_AXIS"]

SHARD_AXIS = "shards"


class Mesh:
    """Shard slots in order: `devices[s]` holds shard s. `owners[s]` is the
    rank of the process that holds it; None means every slot belongs to
    this process. The one axis is named SHARD_AXIS."""

    axis = SHARD_AXIS

    def __init__(self, devices: Sequence, owners: Optional[Sequence[int]] = None):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one shard slot")
        if owners is not None:
            owners = tuple(int(o) for o in owners)
            if len(owners) != len(self.devices):
                raise ValueError(f"{len(owners)} owners for {len(self.devices)} slots")
            if list(owners) != sorted(owners):
                raise ValueError("each rank must own a contiguous range of slots")
        self.owners = owners

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_shards: Optional[int] = None, device=None) -> Mesh:
    """`n_shards` slots placed round-robin over the visible devices of
    `device`'s type (CUDA unless "cpu" is passed): every CUDA card, or the
    one CPU. `n_shards` defaults to the number of those devices; more
    slots than devices put several shards on one device."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devices = [torch.device(dev.type)]
    n = len(devices) if n_shards is None else int(n_shards)
    if n < 1:
        raise ValueError(f"a mesh needs at least one shard slot, got {n_shards}")
    return Mesh([devices[s % len(devices)] for s in range(n)])


def on_device(dev: torch.device):
    """Make `dev` the current CUDA device for a shard's work (the kernels
    launch on the current device); nothing for the CPU."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()
