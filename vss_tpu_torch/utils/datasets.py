"""Loaders for the standard ANN-benchmark vector file formats.

Reproduces `vss_tpu/utils/datasets.py` (numpy only, no change of
behaviour). SIFT1M (128-d bytes) and GIST1M (960-d floats) are
distributed in the TexMex `.fvecs`/`.bvecs`/`.ivecs` formats: each vector
is a little-endian int32 dimension count followed by `dim` values (f32 /
u8 / i32 respectively). No dataset ships with the repository; these
readers feed a real corpus, where one is at hand, to the same code the
synthetic corpora go through.

Memory-maps and reshapes: loading 1M x 128 f32 touches no Python loops.
"""
from __future__ import annotations

import os

import numpy as np

__all__ = ["read_fvecs", "read_bvecs", "read_ivecs", "read_vecs"]


def _vecs(path: str, scalar: np.dtype, scalar_bytes: int) -> np.ndarray:
    raw = np.memmap(path, dtype=np.uint8, mode="r")
    if raw.size < 4:
        raise ValueError(f"{path}: truncated (no header)")
    dim = int(np.frombuffer(raw[:4].tobytes(), dtype="<i4")[0])
    if dim <= 0 or dim > 1_000_000:
        raise ValueError(f"{path}: implausible dimension {dim}")
    row_bytes = 4 + dim * scalar_bytes
    if raw.size % row_bytes:
        raise ValueError(
            f"{path}: size {raw.size} not a multiple of row size {row_bytes}"
        )
    n = raw.size // row_bytes
    mat = raw.reshape(n, row_bytes)
    dims = mat[:, :4].reshape(n * 4).view("<i4")[::1].reshape(n, 1)[:, 0]
    if not (dims == dim).all():
        raise ValueError(f"{path}: ragged dimensions (not a vecs matrix)")
    body = np.ascontiguousarray(mat[:, 4:])
    return body.reshape(n, dim * scalar_bytes).view(scalar).reshape(n, dim)


def read_fvecs(path: str) -> np.ndarray:
    """[n, d] float32 (SIFT/GIST base & query files)."""
    return np.asarray(_vecs(path, np.dtype("<f4"), 4), np.float32)


def read_bvecs(path: str) -> np.ndarray:
    """[n, d] uint8 returned as float32 (SIFT1B learn/base files)."""
    return _vecs(path, np.dtype(np.uint8), 1).astype(np.float32)


def read_ivecs(path: str) -> np.ndarray:
    """[n, k] int32 (ground-truth neighbor-id files)."""
    return np.asarray(_vecs(path, np.dtype("<i4"), 4), np.int32)


def read_vecs(path: str) -> np.ndarray:
    """Dispatch on extension; .npy passes through np.load."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".fvecs":
        return read_fvecs(path)
    if ext == ".bvecs":
        return read_bvecs(path)
    if ext == ".ivecs":
        # ground-truth neighbor IDS, not vector data: keep int32 — a
        # float32 cast silently corrupts ids above 2^24 (SIFT1B gnd
        # files; ADVICE r3)
        return read_ivecs(path)
    if ext == ".npy":
        return np.asarray(np.load(path), np.float32)
    raise ValueError(f"unknown vector file format: {path}")
