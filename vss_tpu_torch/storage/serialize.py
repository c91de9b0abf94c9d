"""Index checkpoint serialization.

Reproduces `vss_tpu/storage/serialize.py` on torch tensors, in the same
`VSSTPU01` format, so a checkpoint written by either package loads in
the other:

    magic "VSSTPU01"  (8 bytes)
    u64 header_len    (little-endian)
    header JSON       (config, counters, free ring, array table)
    raw array bytes   (in array-table order, C-contiguous)

Arrays are trimmed to their used extents (next_slot / upper_used) so the
file size tracks live data, not capacity; load re-pads to a fresh
capacity. Works against any file-like object so the same format flows
through plain files or the block store (`storage/blockfile.py`).

bf16 arrays keep the dtype string "bfloat16" of the JAX package's
ml_dtypes arrays; their bytes are written and read here as 16-bit
integers and viewed as `torch.bfloat16`, so nothing needs ml_dtypes.
"""
from __future__ import annotations

import dataclasses
import json
import struct
from typing import BinaryIO

import numpy as np
import torch

from vss_tpu_torch.index.dense import _RESERVE, HNSWIndex
from vss_tpu_torch.index.graph import HNSWConfig, HNSWGraph, empty_graph
from vss_tpu_torch.utils import resolve_device, round_up

__all__ = [
    "serialize_index", "deserialize_index", "save_index", "load_index", "view_index",
]

MAGIC = b"VSSTPU01"

# the graph's array fields, in the order the JAX package writes them
_GRAPH_ARRAYS = (
    "vectors", "adj0", "upper_adj", "upper_row", "levels", "valid", "slot_to_rowid",
)
# numpy dtype name <-> torch dtype; "bfloat16" travels as int16 bytes
_TORCH_DTYPES = {
    "float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8,
    "int32": torch.int32, "bool": torch.bool,
}
_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}


def _host_array(t: torch.Tensor) -> tuple[str, np.ndarray]:
    """(dtype name, numpy array of the tensor's bytes) on the host."""
    t = t.detach().cpu().contiguous()
    name = _NAMES[t.dtype]
    if t.dtype == torch.bfloat16:
        return name, t.view(torch.int16).numpy()
    return name, t.numpy()


def _np_dtype(name: str) -> np.dtype:
    return np.dtype(np.int16) if name == "bfloat16" else np.dtype(name)


def _tensor(a: np.ndarray, name: str, device) -> torch.Tensor:
    t = torch.from_numpy(a)
    if name == "bfloat16":
        t = t.view(torch.bfloat16)
    return t.to(device)


def serialize_index(idx: HNSWIndex, stream: BinaryIO) -> None:
    g = idx.graph
    n = idx.next_slot
    u = idx.upper_used
    arrays = {f: _host_array(getattr(g, f)[: u if f == "upper_adj" else n])
              for f in _GRAPH_ARRAYS}
    arrays["free_slots"] = ("int32", np.asarray(idx.free_slots, np.int32))
    if idx.rerank_tape is not None:
        arrays["rerank"] = _host_array(idx.rerank_tape[:n])
    table = [
        {"name": k, "dtype": dt, "shape": list(v.shape)}
        for k, (dt, v) in arrays.items()
    ]
    header = {
        "version": 1,
        "config": dataclasses.asdict(idx.config),
        "next_slot": n,
        "upper_used": u,
        "entry": int(g.entry),
        "max_level": int(g.max_level),
        "count": int(g.count),
        "deleted_count": idx.deleted_count,
        "vector_scale": idx.vector_scale,
        "scale_max_abs": idx.scale_max_abs,
        "scale_overflow": idx.scale_overflow,
        "arrays": table,
    }
    hbytes = json.dumps(header).encode()
    stream.write(MAGIC)
    stream.write(struct.pack("<Q", len(hbytes)))
    stream.write(hbytes)
    for _, v in arrays.values():
        stream.write(np.ascontiguousarray(v).tobytes())


def _read_header(stream: BinaryIO) -> tuple[dict, int]:
    """(header, byte offset of the first array)."""
    magic = stream.read(8)
    if magic != MAGIC:
        raise ValueError(f"bad checkpoint magic {magic!r}")
    (hlen,) = struct.unpack("<Q", stream.read(8))
    header = json.loads(stream.read(hlen).decode())
    if header["version"] != 1:
        raise ValueError(f"unsupported checkpoint version {header['version']}")
    return header, 16 + hlen


def _restore_bookkeeping(idx: HNSWIndex, header: dict, arrays: dict) -> None:
    """The host-side state a loaded index needs to search and insert
    exactly like the saved one."""
    n = header["next_slot"]
    idx.next_slot = n
    idx.upper_used = header["upper_used"]
    idx.free_slots = [int(s) for s in np.asarray(arrays["free_slots"])]
    idx.deleted_count = header["deleted_count"]
    idx.vector_scale = float(header.get("vector_scale", 1.0))
    idx.scale_max_abs = float(header.get("scale_max_abs", idx.vector_scale * 127.0))
    idx.scale_overflow = int(header.get("scale_overflow", 0))
    valid = np.asarray(arrays["valid"])
    rowids = np.asarray(arrays["slot_to_rowid"])
    idx.rowid_to_slot = {int(rowids[s]): int(s) for s in np.flatnonzero(valid)}
    idx._insert_seed = n
    idx.dirty = False


def deserialize_index(stream: BinaryIO, device=None) -> HNSWIndex:
    """An index on `device` (CUDA unless "cpu" is passed) from a
    checkpoint stream, re-padded to a fresh capacity with insert
    headroom."""
    dev = resolve_device(device)
    header, _ = _read_header(stream)
    config = HNSWConfig(**header["config"])
    arrays, dtypes = {}, {}
    for spec in header["arrays"]:
        dt = _np_dtype(spec["dtype"])
        shape = tuple(spec["shape"])
        nbytes = dt.itemsize * int(np.prod(shape)) if shape else dt.itemsize
        buf = stream.read(nbytes)
        if len(buf) != nbytes:
            raise ValueError("truncated checkpoint")
        arrays[spec["name"]] = np.frombuffer(buf, dt).reshape(shape).copy()
        dtypes[spec["name"]] = spec["dtype"]

    n = header["next_slot"]
    u = header["upper_used"]
    cap = max(64, round_up(n + _RESERVE, 64))
    upper_cap = max(64, u + 64 + 1)
    idx = HNSWIndex(config, capacity=cap, device=dev)
    g = empty_graph(config, cap, upper_cap, device=dev)

    def place(base, name):
        data = arrays[name]
        if data.shape[0]:
            # dtype guard, as in the JAX package: the copy casts to the
            # tape's dtype (in-range by construction)
            base[: data.shape[0]] = _tensor(data, dtypes[name], dev).to(base.dtype)
        return base

    fields = {f: place(getattr(g, f), f) for f in _GRAPH_ARRAYS}
    idx.graph = HNSWGraph(
        **fields,
        entry=torch.tensor(header["entry"], dtype=torch.int32, device=dev),
        max_level=torch.tensor(header["max_level"], dtype=torch.int32, device=dev),
        count=torch.tensor(header["count"], dtype=torch.int32, device=dev),
    )
    if "rerank" in arrays:
        rr = _tensor(arrays["rerank"], dtypes["rerank"], dev)
        tape = torch.zeros((cap, config.dims), dtype=rr.dtype, device=dev)
        tape[: rr.shape[0]] = rr
        idx.rerank_tape = tape
    else:
        # checkpoint written without a side tape: don't rescore against zeros
        idx.rerank_tape = None
    _restore_bookkeeping(idx, header, arrays)
    return idx


def save_index(idx: HNSWIndex, path: str) -> None:
    with open(path, "wb") as f:
        serialize_index(idx, f)
    idx.dirty = False


def load_index(path: str, view: bool = False, device=None) -> HNSWIndex:
    if view:
        return view_index(path, device=device)
    with open(path, "rb") as f:
        return deserialize_index(f, device=device)


def view_index(path: str, device=None) -> HNSWIndex:
    """Load without re-padding: the analog of usearch's `view()`
    (duckdb-vss `src/include/usearch/index.hpp:3276-3310`).

    On `device="cpu"` the graph tensors are `torch.from_numpy` over
    copy-on-write memory maps of the checkpoint file: no array bytes are
    read until an operation touches them, and a write lands in private
    memory, never in the file. On `cuda` a file cannot be mapped into
    device memory, so each array is read and uploaded once, here. Either
    way the view has no insert headroom: the first DML grows (and so
    copies) the graph."""
    dev = resolve_device(device)
    with open(path, "rb") as f:
        header, off = _read_header(f)
    config = HNSWConfig(**header["config"])
    arrays, tensors = {}, {}
    for spec in header["arrays"]:
        dt = _np_dtype(spec["dtype"])
        shape = tuple(spec["shape"])
        count = int(np.prod(shape)) if shape else 1
        if count == 0:
            a = np.zeros(shape, dt)
        else:
            a = np.memmap(path, dtype=dt, mode="c", offset=off, shape=shape)
        off += dt.itemsize * count
        arrays[spec["name"]] = a
        tensors[spec["name"]] = _tensor(a, spec["dtype"], dev)

    idx = HNSWIndex(config, capacity=64, device=dev)
    # capacity == stored extent, no reserve slack
    idx.graph = HNSWGraph(
        **{f: tensors[f] for f in _GRAPH_ARRAYS},
        entry=torch.tensor(header["entry"], dtype=torch.int32, device=dev),
        max_level=torch.tensor(header["max_level"], dtype=torch.int32, device=dev),
        count=torch.tensor(header["count"], dtype=torch.int32, device=dev),
    )
    idx.rerank_tape = tensors.get("rerank")
    _restore_bookkeeping(idx, header, arrays)
    return idx
