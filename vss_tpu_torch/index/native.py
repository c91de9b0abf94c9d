"""Native (C++) host-side graph construction.

Reproduces `vss_tpu/index/native.py`: a ctypes wrapper around
`csrc/hnsw_builder.cpp` (the same source, copied unchanged, so a
one-thread build gives the same adjacency as the JAX package's). The
library is built with g++ into `vss_tpu_torch/_build/` at first use.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from vss_tpu_torch import csrc
from vss_tpu_torch.index.graph import HNSWConfig, HNSWGraph, cast_to_tape, sample_levels
from vss_tpu_torch.utils import resolve_device

__all__ = ["build_graph_native", "native_available"]

_METRIC_IDS = {"l2sq": 0, "cosine": 1, "ip": 2}


def _lib():
    fn = csrc.load("hnsw_builder").vss_hnsw_build
    fn.restype = ctypes.c_int
    i32p = ctypes.POINTER(ctypes.c_int32)
    fn.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        i32p, ctypes.c_int32, i32p, i32p, i32p, i32p, i32p,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int32,
    ]
    return fn


def native_available() -> bool:
    """Whether the C++ builder builds and loads here."""
    try:
        _lib()
        return True
    except csrc.NativeUnavailable:
        return False


def build_graph_native(
    vectors,
    config: HNSWConfig,
    *,
    seed: int = 0,
    rowids: Optional[np.ndarray] = None,
    capacity: Optional[int] = None,
    n_threads: int = 0,
    device=None,
) -> tuple[HNSWGraph, int]:
    """Build on the host with the C++ builder (n_threads=0: all cores);
    returns (graph on `device`, upper rows used)."""
    dev = resolve_device(device)
    vectors = np.ascontiguousarray(np.asarray(vectors, np.float32))
    n, d = vectors.shape
    if d != config.dims:
        raise ValueError(f"vectors have {d} columns, config.dims is {config.dims}")
    levels = np.ascontiguousarray(sample_levels(n, config, seed))
    cap = max(capacity or 0, n + 8)
    upper_cap = max(64, int(levels.sum()) + 1)

    adj0 = np.full((cap, config.m0), -1, np.int32)
    upper_adj = np.full((upper_cap, config.m), -1, np.int32)
    upper_row = np.full((cap, config.max_levels), -1, np.int32)
    entry = ctypes.c_int32(-1)
    max_level = ctypes.c_int32(-1)
    upper_used = ctypes.c_int64(0)

    def i32p(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

    rc = _lib()(
        vectors.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n, d, config.m, config.m0, config.ef_construction,
        _METRIC_IDS[str(config.metric)],
        i32p(levels), config.max_levels,
        i32p(adj0), i32p(upper_adj), i32p(upper_row),
        ctypes.byref(entry), ctypes.byref(max_level), ctypes.byref(upper_used),
        n_threads,
    )
    if rc != 0:
        raise RuntimeError(f"native build failed (rc={rc})")

    if rowids is None:
        rowids = np.arange(n, dtype=np.int64)
    tape = torch.zeros((cap, d), dtype=torch.float32, device=dev)
    tape[:n] = torch.from_numpy(vectors).to(dev)
    lv = np.zeros(cap, np.int32)
    lv[:n] = levels
    valid = np.zeros(cap, bool)
    valid[:n] = True
    srow = np.full(cap, -1, np.int32)
    srow[:n] = np.asarray(rowids, np.int64).astype(np.int32)

    def t(a):
        return torch.from_numpy(a).to(dev)

    graph = HNSWGraph(
        vectors=cast_to_tape(tape, config),
        adj0=t(adj0),
        upper_adj=t(upper_adj),
        upper_row=t(upper_row),
        levels=t(lv),
        valid=t(valid),
        slot_to_rowid=t(srow),
        entry=torch.tensor(entry.value, dtype=torch.int32, device=dev),
        max_level=torch.tensor(max_level.value, dtype=torch.int32, device=dev),
        count=torch.tensor(n, dtype=torch.int32, device=dev),
    )
    return graph, int(upper_used.value)
