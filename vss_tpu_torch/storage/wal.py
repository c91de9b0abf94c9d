"""Write-ahead log for DML between checkpoints.

Reproduces `vss_tpu/storage/wal.py` with the same record format, so a
WAL written by either package replays in the other.

The reference serializes its index into the WAL at commit
(duckdb-vss `src/hnsw/hnsw_index.cpp:574-585`), but WAL playback for
extension indexes is broken upstream — its own test only exercises the
checkpoint path (`test/sql/hnsw/hnsw_insert_wal.test:6`). This WAL
actually replays: DML against a WAL-enabled database appends one
JSON-line record per statement (fsync'd), and `Database.open` replays any
records newer than the checkpoint through the normal DML path — which
maintains the indexes as a side effect, so index state after recovery
matches index state before the crash without re-serializing any graph
bytes per commit.

Record format (one JSON object per line):
    {"op": "insert", "table": t, "data": {col: [values...]}}
    {"op": "delete", "table": t, "rowids": [...]}
    {"op": "update", "table": t, "rowids": [...], "data": {...}}
Vector cells are lists of floats; NULLs are JSON null. A truncated final
line (mid-crash write) is ignored on replay.
"""
from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

__all__ = ["WriteAheadLog", "encode_value", "decode_column"]


def encode_value(v):
    """One cell -> JSON-safe value."""
    if v is None:
        return None
    if isinstance(v, (np.floating, float)):
        f = float(v)
        return None if np.isnan(f) else f
    if isinstance(v, (np.integer, int)):
        return int(v)
    if isinstance(v, np.ndarray):
        if v.dtype == object:
            return [encode_value(x) for x in v]
        if v.ndim == 1 and v.dtype.kind == "f" and np.isnan(v).all():
            return None  # NULL vector
        return [float(x) for x in v]
    if isinstance(v, (list, tuple)):
        return [encode_value(x) for x in v]
    return str(v)


def encode_data(data: dict) -> dict:
    out = {}
    for c, vals in data.items():
        if isinstance(vals, np.ndarray) and vals.ndim == 2:
            out[c] = [encode_value(row) for row in vals]
        else:
            out[c] = [encode_value(v) for v in np.asarray(vals, object)]
    return out


def decode_column(vals: list):
    """JSON column -> the list form Table.append accepts (None = NULL)."""
    return [
        np.asarray(v, np.float32) if isinstance(v, list) else v for v in vals
    ]


class WriteAheadLog:
    """Append-only JSON-line DML log with fsync-per-record durability."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "a", encoding="utf-8")

    def append(self, record: dict) -> None:
        self._f.write(json.dumps(record) + "\n")
        self._f.flush()
        os.fsync(self._f.fileno())

    def truncate(self) -> None:
        """Checkpoint completed: drop everything logged so far."""
        self._f.close()
        self._f = open(self.path, "w", encoding="utf-8")
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None

    @staticmethod
    def replay(path: str, db) -> int:
        """Apply logged DML records to `db` (index-maintaining path).
        Returns the number of records applied; a torn trailing line is
        skipped silently."""
        if not os.path.exists(path):
            return 0
        applied = 0
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    break  # torn tail from a crash mid-append
                op = rec["op"]
                if op == "insert":
                    data = {
                        c: decode_column(v) for c, v in rec["data"].items()
                    }
                    db.insert(rec["table"], data)
                elif op == "delete":
                    db.delete(rec["table"], rec["rowids"])
                elif op == "update":
                    data = {
                        c: decode_column(v) for c, v in rec["data"].items()
                    }
                    db.update(rec["table"], rec["rowids"], data)
                applied += 1
        return applied
