"""Persistence: checkpoint serialization, the WAL and block-based storage.

Reproduces `vss_tpu/storage/__init__.py`.
"""
from vss_tpu_torch.storage.serialize import (
    deserialize_index,
    load_index,
    save_index,
    serialize_index,
    view_index,
)

__all__ = [
    "serialize_index",
    "deserialize_index",
    "save_index",
    "load_index",
    "view_index",
]
