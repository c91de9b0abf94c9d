"""HNSW graph representation: flat structure-of-arrays tensors.

Reproduces `vss_tpu/index/graph.py`:

  vectors   [cap, d]        vector tape, slot-indexed (f32 / bf16 / int8)
  adj0      [cap, M0]       base-layer adjacency, -1 padded
  upper_adj [upper_cap, M]  levels >= 1, compact rows, -1 padded
  upper_row [cap, Lmax]     (slot, level-1) -> row in upper_adj, -1 if none
  levels    [cap]           node's max level (0 = base only)
  valid     [cap]           slot occupied AND not tombstoned
  slot_to_rowid [cap]       slot -> user row id (-1 = unoccupied)
  entry, max_level, count   0-d int32 tensors

Static hyperparameters live in `HNSWConfig`; the arrays in `HNSWGraph`,
a dataclass of tensors on one device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from vss_tpu_torch.utils import resolve_device

__all__ = [
    "HNSWConfig", "HNSWGraph", "cast_to_tape", "empty_graph", "grow_graph",
    "sample_levels", "check_rowids_int32",
]

DEFAULT_M = 16
DEFAULT_EF_CONSTRUCTION = 128
DEFAULT_EF_SEARCH = 64
DEFAULT_MAX_LEVELS = 6


@dataclasses.dataclass(frozen=True)
class HNSWConfig:
    """Static HNSW hyperparameters (hashable)."""

    dims: int
    metric: str = "l2sq"
    m: int = DEFAULT_M
    m0: int = 0  # 0 -> defaults to 2*m
    ef_construction: int = DEFAULT_EF_CONSTRUCTION
    ef_search: int = DEFAULT_EF_SEARCH
    max_levels: int = DEFAULT_MAX_LEVELS
    # vector tape precision: 'f32', 'bf16' or 'int8' (global symmetric
    # scale; absolute distances are rescaled on output)
    storage_dtype: str = "f32"
    # final exact rescoring against a full-precision side tape: 'auto' =
    # 'f32' for int8 tapes, 'none' otherwise
    rerank: str = "auto"

    def __post_init__(self):
        if self.m0 == 0:
            object.__setattr__(self, "m0", 2 * self.m)
        if self.storage_dtype not in ("f32", "bf16", "int8"):
            raise ValueError(
                "storage_dtype must be 'f32', 'bf16' or 'int8', "
                f"got {self.storage_dtype!r}"
            )
        if self.rerank not in ("auto", "none", "f32", "bf16"):
            raise ValueError(
                "rerank must be 'auto', 'none', 'f32' or 'bf16', "
                f"got {self.rerank!r}"
            )

    @property
    def rerank_dtype(self) -> Optional[torch.dtype]:
        """Resolved rerank tape dtype, or None when disabled."""
        r = self.rerank
        if r == "auto":
            r = "f32" if self.storage_dtype == "int8" else "none"
        return {"none": None, "f32": torch.float32, "bf16": torch.bfloat16}[r]

    @property
    def inv_log_m(self) -> float:
        return 1.0 / math.log(self.m)

    @property
    def vector_dtype(self) -> torch.dtype:
        return {
            "f32": torch.float32,
            "bf16": torch.bfloat16,
            "int8": torch.int8,
        }[self.storage_dtype]


@dataclasses.dataclass
class HNSWGraph:
    """Graph state: tensors on one device."""

    vectors: torch.Tensor  # [cap, d]
    adj0: torch.Tensor  # i32 [cap, M0]
    upper_adj: torch.Tensor  # i32 [upper_cap, M]
    upper_row: torch.Tensor  # i32 [cap, Lmax]
    levels: torch.Tensor  # i32 [cap]
    valid: torch.Tensor  # bool [cap]
    slot_to_rowid: torch.Tensor  # i32 [cap]
    entry: torch.Tensor  # i32 0-d: entry slot (-1 if empty)
    max_level: torch.Tensor  # i32 0-d
    count: torch.Tensor  # i32 0-d: live (valid) nodes

    @property
    def capacity(self) -> int:
        return self.vectors.shape[0]

    @property
    def upper_capacity(self) -> int:
        return self.upper_adj.shape[0]

    @property
    def device(self) -> torch.device:
        return self.vectors.device

    def clone(self) -> "HNSWGraph":
        """A graph with its own copy of every tensor."""
        return HNSWGraph(**{
            f.name: getattr(self, f.name).clone() for f in dataclasses.fields(self)
        })

    def to(self, device) -> "HNSWGraph":
        return HNSWGraph(**{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
        })


def _i32(v: int, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.int32, device=device)


def empty_graph(config: HNSWConfig, capacity: int,
                upper_capacity: Optional[int] = None, device=None) -> HNSWGraph:
    """Allocate an empty graph with the given slot capacity."""
    dev = resolve_device(device)
    if upper_capacity is None:
        # ~1/(m-1) of nodes have some upper level; 4x headroom, min 64
        upper_capacity = max(64, 4 * capacity // max(config.m - 1, 1))

    def full(shape, fill, dtype):
        return torch.full(shape, fill, dtype=dtype, device=dev)

    return HNSWGraph(
        vectors=torch.zeros((capacity, config.dims), dtype=config.vector_dtype, device=dev),
        adj0=full((capacity, config.m0), -1, torch.int32),
        upper_adj=full((upper_capacity, config.m), -1, torch.int32),
        upper_row=full((capacity, config.max_levels), -1, torch.int32),
        levels=full((capacity,), 0, torch.int32),
        valid=full((capacity,), False, torch.bool),
        slot_to_rowid=full((capacity,), -1, torch.int32),
        entry=_i32(-1, dev),
        max_level=_i32(-1, dev),
        count=_i32(0, dev),
    )


def grow_graph(graph: HNSWGraph, config: HNSWConfig, new_capacity: int,
               new_upper_capacity: Optional[int] = None) -> HNSWGraph:
    """Return a graph with larger capacity, contents preserved."""
    cap = graph.capacity
    if new_upper_capacity is None:
        new_upper_capacity = max(
            graph.upper_capacity, 4 * new_capacity // max(config.m - 1, 1)
        )
    if new_capacity < cap or new_upper_capacity < graph.upper_capacity:
        raise ValueError("grow_graph cannot shrink")

    def pad(x, n, fill):
        extra = torch.full((n - x.shape[0],) + tuple(x.shape[1:]), fill,
                           dtype=x.dtype, device=x.device)
        return torch.cat([x, extra])

    return HNSWGraph(
        vectors=pad(graph.vectors, new_capacity, 0),
        adj0=pad(graph.adj0, new_capacity, -1),
        upper_adj=pad(graph.upper_adj, new_upper_capacity, -1),
        upper_row=pad(graph.upper_row, new_capacity, -1),
        levels=pad(graph.levels, new_capacity, 0),
        valid=pad(graph.valid, new_capacity, False),
        slot_to_rowid=pad(graph.slot_to_rowid, new_capacity, -1),
        entry=graph.entry,
        max_level=graph.max_level,
        count=graph.count,
    )


def sample_levels(n: int, config: HNSWConfig, seed: int = 0) -> np.ndarray:
    """Node levels ~ floor(-ln(U) / ln(M)), drawn with NumPy so the same
    seed gives the same levels as the JAX package."""
    rng = np.random.default_rng(seed)
    u = rng.random(n)
    lv = np.floor(-np.log(u) * config.inv_log_m).astype(np.int32)
    return np.minimum(lv, config.max_levels)


def check_rowids_int32(rowids) -> None:
    """The slot -> rowid tape is int32; reject rowids outside its range."""
    rowids = np.asarray(rowids)
    if rowids.size and (
        int(rowids.max()) > 2**31 - 1 or int(rowids.min()) < 0
    ):
        raise ValueError(
            "rowid out of the int32 range supported by the HNSW index "
            f"(got {int(rowids.min())}..{int(rowids.max())})"
        )


def cast_to_tape(x: torch.Tensor, config: HNSWConfig) -> torch.Tensor:
    """Cast (scaled-unit) f32 vectors to the tape dtype. int8 tapes round
    half to even (as jnp.round) and clip to +-127."""
    if config.storage_dtype == "int8":
        return torch.clamp(torch.round(x), -127, 127).to(torch.int8)
    return x.to(config.vector_dtype)
