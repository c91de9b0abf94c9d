"""Python wrapper over the native linked-block store.

Reproduces `vss_tpu/storage/blockfile.py`. Single-file database
container: named byte streams in fixed-size block chains with block
reuse (`csrc/blockstore.cpp`, the JAX package's source copied, built by
g++ into `_build/` at first use). Host storage, not a kernel: where no
toolchain is available `blockstore_available()` is False and
`Database.checkpoint` writes a checkpoint directory instead.
"""
from __future__ import annotations

import ctypes

from vss_tpu_torch.csrc import NativeUnavailable, load

__all__ = ["BlockStore", "blockstore_available"]


def _lib():
    lib = load("blockstore")
    lib.bs_open.restype = ctypes.c_void_p
    lib.bs_open.argtypes = [ctypes.c_char_p, ctypes.c_uint32]
    lib.bs_close.restype = ctypes.c_int
    lib.bs_close.argtypes = [ctypes.c_void_p]
    lib.bs_put.restype = ctypes.c_int
    lib.bs_put.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64
    ]
    lib.bs_length.restype = ctypes.c_int64
    lib.bs_length.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.bs_get.restype = ctypes.c_int
    lib.bs_get.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64
    ]
    lib.bs_delete.restype = ctypes.c_int
    lib.bs_delete.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.bs_total_blocks.restype = ctypes.c_int64
    lib.bs_total_blocks.argtypes = [ctypes.c_void_p]
    lib.bs_free_blocks.restype = ctypes.c_int64
    lib.bs_free_blocks.argtypes = [ctypes.c_void_p]
    lib.bs_list.restype = ctypes.c_int64
    lib.bs_list.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64]
    return lib


def blockstore_available() -> bool:
    try:
        _lib()
        return True
    except NativeUnavailable:
        return False


class BlockStore:
    """Named byte streams in one block-structured file."""

    def __init__(self, path: str, block_size: int = 262144):
        self._lib = _lib()
        self._h = self._lib.bs_open(path.encode(), block_size)
        if not self._h:
            raise IOError(f"cannot open block store at {path}")
        self.path = path

    def put(self, name: str, data: bytes):
        if len(name.encode()) > 55:
            raise IOError(
                f"block store stream name too long (max 55 bytes): '{name}'"
            )
        rc = self._lib.bs_put(self._h, name.encode(), data, len(data))
        if rc != 0:
            raise IOError(f"block store write failed for '{name}'")

    def get(self, name: str) -> bytes:
        n = self._lib.bs_length(self._h, name.encode())
        if n < 0:
            raise KeyError(name)
        buf = ctypes.create_string_buffer(max(int(n), 1))
        rc = self._lib.bs_get(self._h, name.encode(), buf, n)
        if rc != 0:
            raise IOError(f"block store read failed for '{name}'")
        return buf.raw[:n]

    def delete(self, name: str):
        if self._lib.bs_delete(self._h, name.encode()) != 0:
            raise KeyError(name)

    def __contains__(self, name: str) -> bool:
        return self._lib.bs_length(self._h, name.encode()) >= 0

    def list(self) -> list[str]:
        n = self._lib.bs_list(self._h, None, 0)
        if n <= 0:
            return []
        buf = ctypes.create_string_buffer(int(n))
        self._lib.bs_list(self._h, buf, n)
        return buf.raw[:n].decode().split("\n")

    @property
    def total_blocks(self) -> int:
        return int(self._lib.bs_total_blocks(self._h))

    @property
    def free_blocks(self) -> int:
        return int(self._lib.bs_free_blocks(self._h))

    def close(self):
        if self._h:
            rc = self._lib.bs_close(self._h)
            self._h = None
            if rc != 0:
                raise IOError("block store close/flush failed")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
