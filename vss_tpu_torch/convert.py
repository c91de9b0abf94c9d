"""Carry vss_tpu state across to the port (new: no counterpart in
`vss_tpu`).

Takes plain numpy arrays (read out of the JAX package with
`np.asarray`), so this module needs nothing of JAX. bf16 arrays
(ml_dtypes' numpy bfloat16) are moved bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

import numpy as np
import torch

from vss_tpu_torch.index.dense import HNSWIndex
from vss_tpu_torch.index.graph import HNSWConfig, HNSWGraph
from vss_tpu_torch.utils import resolve_device

__all__ = ["graph_from_arrays", "index_from_state", "tensor_from_array"]

GRAPH_FIELDS = tuple(f.name for f in dataclasses.fields(HNSWGraph))


def tensor_from_array(a, device=None) -> torch.Tensor:
    """A numpy array (bf16 included) as a tensor on `device`."""
    a = np.array(a)  # a writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def graph_from_arrays(arrays: dict, device=None) -> HNSWGraph:
    """An HNSWGraph from the ten fields of vss_tpu's HNSWGraph."""
    dev = resolve_device(device)
    missing = [f for f in GRAPH_FIELDS if f not in arrays]
    if missing:
        raise ValueError(f"graph arrays lack {missing}")
    return HNSWGraph(**{f: tensor_from_array(arrays[f], dev) for f in GRAPH_FIELDS})


def index_from_state(
    config: HNSWConfig,
    arrays: dict,
    *,
    vector_scale: float = 1.0,
    rerank_tape=None,
    rowid_to_slot: dict,
    next_slot: int,
    deleted_count: int = 0,
    free_slots: Iterable[int] = (),
    upper_used: int = 0,
    scale_max_abs: float = 0.0,
    scale_overflow: int = 0,
    insert_seed: int = 0,
    dirty: bool = False,
    device=None,
) -> HNSWIndex:
    """An HNSWIndex holding vss_tpu index state: the graph arrays plus the
    host-side bookkeeping of `vss_tpu.index.dense.HNSWIndex`. The keyword
    defaults are those of a fresh index."""
    idx = HNSWIndex(config, capacity=64, device=device)
    idx.graph = graph_from_arrays(arrays, idx.device)
    idx.vector_scale = float(vector_scale)
    idx.rerank_tape: Optional[torch.Tensor] = (
        None if rerank_tape is None else tensor_from_array(rerank_tape, idx.device)
    )
    idx.rowid_to_slot = {int(r): int(s) for r, s in rowid_to_slot.items()}
    idx.next_slot = int(next_slot)
    idx.deleted_count = int(deleted_count)
    idx.free_slots = [int(s) for s in free_slots]
    idx.upper_used = int(upper_used)
    idx.scale_max_abs = float(scale_max_abs)
    idx.scale_overflow = int(scale_overflow)
    idx._insert_seed = int(insert_seed)
    idx.dirty = bool(dirty)
    return idx
