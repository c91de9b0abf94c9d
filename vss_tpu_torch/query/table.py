"""Tables, the database catalog, DML with index maintenance, settings,
pragmas, and database-level checkpointing.

Covers the roles DuckDB itself plays for the reference (storage, catalog,
transaction-ish DML hooks) plus the extension's registration surface
(duckdb-vss `src/hnsw/hnsw_index.cpp:700-724`): the `HNSW` index
type, the `hnsw_enable_experimental_persistence` / `hnsw_ef_search`
settings, `pragma_hnsw_index_info()` and `PRAGMA hnsw_compact_index`.

Option validation mirrors the reference's binder errors verbatim
(`src/hnsw/hnsw_index_plan.cpp:33-99`) since its test suite asserts the
exact messages (`test/sql/hnsw/hnsw_options.test`).

Reproduces `vss_tpu/query/table.py`. A database lives on one device
(`Database(device=...)`, CUDA unless "cpu" is passed): its indexes and
its cached vector columns are tensors there; the tables themselves stay
numpy columns on the host. Checkpoints have the JAX package's layout (the
same catalog, table `.npz` files and `index_<name>.vss` streams, in a
directory or a `.vssdb` block file), so either package opens what the
other wrote, sharded indexes (`parallel/`) included: a sharded index
takes the JAX package's `index_<name>.sharded` directory or its
`index:<name>:shard<s>` block-file streams, and opens on
`make_mesh(n_shards, device)`.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Any, Optional, Sequence

import numpy as np
import torch

from vss_tpu_torch.index.dense import HNSWIndex
from vss_tpu_torch.index.graph import HNSWConfig
from vss_tpu_torch.utils import resolve_device

__all__ = ["Table", "Database", "BinderError", "host"]


def host(t: torch.Tensor) -> np.ndarray:
    """A result tensor (on any device) on the host as numpy. `np.asarray`
    of a CUDA tensor fails, so every device result the query layer reads
    passes through here."""
    return t.detach().cpu().numpy()


class BinderError(ValueError):
    """Plan/DDL-time validation error (DuckDB BinderException analog)."""


ALLOWED_METRICS = ("l2sq", "cosine", "ip")


class Table:
    """Columnar table: scalar columns are 1-D NumPy arrays; vector columns
    are 2-D float32 [n, dims] (the ARRAY(FLOAT, N) analog). Rows carry
    stable int64 rowids; deletes tombstone positions. `device` is where
    `device_column` caches the vector columns (CUDA when None)."""

    def __init__(self, name: str, columns: dict[str, np.ndarray], device=None):
        self.name = name
        self.device = device
        self.columns: dict[str, np.ndarray] = {}
        n = None
        for cname, data in columns.items():
            arr = np.asarray(data)
            if arr.ndim == 2:
                arr = arr.astype(np.float32)
            elif arr.ndim != 1:
                raise BinderError(
                    f"column '{cname}' must be 1-D (scalar) or 2-D (vector)"
                )
            if n is None:
                n = arr.shape[0]
            elif arr.shape[0] != n:
                raise BinderError("column length mismatch")
            self.columns[cname] = arr
        n = n or 0
        self.rowids = np.arange(n, dtype=np.int64)
        self.row_valid = np.ones(n, bool)
        self.next_rowid = n
        self._device_cache: dict[str, Any] = {}
        self._version = 0
        # guards DML commits; readers work on immutable-array snapshots
        # (the analog of the reference's shared-lock reads,
        # hnsw_index.cpp:331-333 — queries never serialize behind DML)
        self._mutex = threading.Lock()

    # ------------------------------------------------------------ basics
    @property
    def num_rows(self) -> int:
        return int(self.row_valid.sum())

    def column_names(self) -> list[str]:
        return list(self.columns)

    def is_vector_column(self, name: str) -> bool:
        return self.columns[name].ndim == 2

    def vector_dims(self, name: str) -> int:
        if not self.is_vector_column(name):
            raise BinderError("HNSW index keys must be of type FLOAT[N]")
        return self.columns[name].shape[1]

    def _bump(self):
        self._version += 1
        self._device_cache.clear()

    def device_column(self, name: str):
        """Vector column + validity as tensors on the table's device
        (cached per version): the input of BRUTE_FORCE_TOPK. NULL vectors
        (NaN rows) are excluded from validity, mirroring the reference's
        IS NOT NULL handling."""
        cached = self._device_cache.get(name)
        if cached is None:
            col = self.columns[name]
            valid = self.row_valid & ~np.isnan(col).any(axis=1)
            dev = resolve_device(self.device)
            cached = (torch.from_numpy(np.nan_to_num(col)).to(dev),
                      torch.from_numpy(valid).to(dev))
            self._device_cache[name] = cached
        return cached

    def vector_null_mask(self, name: str) -> np.ndarray:
        """True where the vector is NULL (stored as an all/any-NaN row)."""
        return np.isnan(self.columns[name]).any(axis=1)

    # ------------------------------------------------------------ access
    def chunk(
        self,
        positions: Optional[np.ndarray] = None,
        columns: Optional[Sequence[str]] = None,
    ) -> dict[str, np.ndarray]:
        """Materialize rows as a column chunk (adds __rowid__).

        `columns` restricts which columns materialize — the projection
        pushdown surface (the reference's scan supports it,
        `hnsw_index_scan.cpp:70-89`); None materializes everything."""
        with self._mutex:
            cols, rowids, valid = self.columns, self.rowids, self.row_valid
        if positions is None:
            positions = np.flatnonzero(valid)
        names = cols if columns is None else columns
        out = {c: cols[c][positions] for c in names}
        out["__rowid__"] = rowids[positions]
        return out

    def positions_of_rowids(self, rowids: np.ndarray) -> np.ndarray:
        """rowid -> physical position, -1 for misses.

        Rowids are appended in increasing order today, but nothing forces
        that to stay true (a future physical reorder would otherwise
        silently corrupt fetches), so the binary search runs over a
        sort-order view cached per table version."""
        rowids = np.asarray(rowids, np.int64)
        n = len(self.rowids)
        if n == 0:
            return np.full(len(rowids), -1, np.int64)
        key = "__rowid_order__"
        cached = self._device_cache.get(key)
        if cached is None:
            order = np.argsort(self.rowids, kind="stable")
            cached = (order, self.rowids[order])
            self._device_cache[key] = cached
        order, sorted_ids = cached
        j = np.searchsorted(sorted_ids, rowids)
        j = np.clip(j, 0, n - 1)
        pos = order[j]
        ok = (sorted_ids[j] == rowids) & self.row_valid[pos]
        return np.where(ok, pos, -1)

    def fetch(
        self, rowids: np.ndarray, columns: Optional[Sequence[str]] = None
    ) -> dict[str, np.ndarray]:
        """DataTable::Fetch analog: rows by rowid, dropping misses/deleted."""
        pos = self.positions_of_rowids(rowids)
        return self.chunk(pos[pos >= 0], columns=columns)

    # ------------------------------------------------------------ DML
    def append(self, data: dict[str, np.ndarray]) -> np.ndarray:
        """INSERT rows. Conversion + validation happen into a staging dict
        first; `self.columns` is only touched after every column passes, so
        a rejected INSERT leaves the table untouched (all-or-nothing)."""
        cols = set(self.columns)
        if set(data) != cols:
            raise BinderError(
                f"INSERT columns {sorted(data)} != table columns {sorted(cols)}"
            )
        staged: dict[str, np.ndarray] = {}
        n = None
        for cname, vals in data.items():
            col = self.columns[cname]
            if isinstance(vals, (list, tuple)) and any(v is None for v in vals):
                # NULL mapping: vectors -> NaN rows; float scalars -> NaN;
                # object (VARCHAR) keeps None; integers cannot hold NULL
                if col.ndim == 2:
                    dims = col.shape[1]
                    vals = [
                        np.full(dims, np.nan, np.float32) if v is None else v
                        for v in vals
                    ]
                elif col.dtype.kind == "f":
                    vals = [np.nan if v is None else v for v in vals]
                elif col.dtype == object:
                    vals = list(vals)
                else:
                    raise BinderError(
                        f"NULL is not supported for integer column '{cname}'"
                    )
            if col.dtype == object and isinstance(vals, (list, tuple)):
                arr = np.empty(len(vals), object)
                arr[:] = vals
            else:
                arr = np.asarray(vals)
            if col.ndim == 2:
                arr = arr.astype(np.float32)
                if arr.ndim == 1:
                    arr = arr[None, :]
                if arr.shape[1] != col.shape[1]:
                    raise BinderError("vector dimension mismatch on INSERT")
            n = arr.shape[0] if n is None else n
            if arr.shape[0] != n:
                raise BinderError("column length mismatch on INSERT")
            staged[cname] = arr
        n = n or 0
        # commit: build every new array first, publish them under the
        # mutex in one short critical section — concurrent snapshot
        # readers see either the old state or the new one, never a torn mix
        new_cols = {
            c: np.concatenate([self.columns[c], staged[c]]) for c in staged
        }
        with self._mutex:
            new_ids = np.arange(
                self.next_rowid, self.next_rowid + n, dtype=np.int64
            )
            self.next_rowid += n
            self.columns = new_cols
            self.rowids = np.concatenate([self.rowids, new_ids])
            self.row_valid = np.concatenate([self.row_valid, np.ones(n, bool)])
            self._bump()
        return new_ids

    def delete_rowids(self, rowids: Sequence[int]) -> np.ndarray:
        pos = self.positions_of_rowids(np.asarray(list(rowids), np.int64))
        pos = pos[pos >= 0]
        deleted = self.rowids[pos]
        # copy-on-write so in-flight snapshot readers keep a stable view
        new_valid = self.row_valid.copy()
        new_valid[pos] = False
        with self._mutex:
            self.row_valid = new_valid
            self._bump()
        return deleted


def _encode_table_arrays(t: Table) -> dict[str, np.ndarray]:
    """npz-safe arrays for a table. Object (VARCHAR) columns cannot go
    through np.savez as-is — numpy pickles them, and np.load with the safe
    default allow_pickle=False then cannot read the checkpoint back (and
    allow_pickle=True would execute pickled payloads on open). Store them
    as fixed-width unicode arrays plus a null mask instead."""
    arrs: dict[str, np.ndarray] = {}
    for name, col in t.columns.items():
        if col.dtype == object:
            arrs[f"__vstr__{name}"] = np.asarray(
                ["" if v is None else str(v) for v in col], dtype=str
            )
            arrs[f"__vnull__{name}"] = np.asarray(
                [v is None for v in col], bool
            )
        else:
            arrs[name] = col
    arrs["__rowids__"] = t.rowids
    arrs["__valid__"] = t.row_valid
    return arrs


def _decode_table_columns(data) -> dict[str, np.ndarray]:
    """Inverse of `_encode_table_arrays` (columns only, in saved order)."""
    cols: dict[str, np.ndarray] = {}
    for k in data.files:
        if k.startswith("__vstr__"):
            name = k[len("__vstr__"):]
            strs = data[k]
            nulls = data[f"__vnull__{name}"]
            out = np.empty(len(strs), object)
            out[:] = [
                None if null else s for s, null in zip(strs.tolist(), nulls)
            ]
            cols[name] = out
        elif not k.startswith("__"):
            cols[k] = data[k]
    return cols


class IndexEntry:
    """Catalog entry for one index. On restart the underlying index may be
    a deferred loader: the reference defers deserialization to the first
    index bind (`hnsw_index.cpp:221-239`), and `Database.open` mirrors that
    — touching `.index` triggers the load; `.loaded` inspects without
    loading."""

    def __init__(self, name, table, column, index=None, loader=None,
                 meta=None):
        self.name = name
        self.table = table
        self.column = column
        self._index = index
        self._loader = loader
        self.meta = dict(meta or {})

    @property
    def loaded(self) -> bool:
        return self._index is not None

    @property
    def index(self):
        if self._index is None:
            self._index = self._loader()
            self._index.dirty = False
        return self._index


class Database:
    """In-process database: catalog of tables + HNSW indexes + settings,
    on one device (CUDA unless `device="cpu"` is passed; raises when no
    GPU is present and none is asked for)."""

    def __init__(self, path: Optional[str] = None, device=None):
        self.device = resolve_device(device)
        self.tables: dict[str, Table] = {}
        self.indexes: dict[str, IndexEntry] = {}
        self.settings: dict[str, Any] = {
            "hnsw_ef_search": 0,
            "hnsw_enable_experimental_persistence": False,
            # extension beyond the reference: push WHERE predicates into
            # the index scan (filtered_search) so k matching rows come
            # back, instead of post-filtering the k nearest. Default ON:
            # the reference's pull-up-only plan can return fewer than k
            # rows under a filter (its own where_clause_segfault.test
            # only passes by traversal luck); with pushdown the pulled-up
            # recheck still runs above the scan, so results are a strict
            # superset of the reference's. Matches index_dense.hpp's
            # filtered_search (`index_dense.hpp:1816-1828`).
            "hnsw_pushdown_filters": True,
            # extension beyond the reference: cost-based choice between
            # the index and the exact scan (query/cost.py). Off by
            # default so plan shapes stay reference-parity.
            "hnsw_cost_model": False,
            # DuckDB core pragma the reference tests use
            # (hnsw_rewrite.test:20, hnsw_join_macro.test:22): disables
            # all plan rewrites so queries run in parsed logical shape
            "disable_optimizer": False,
        }
        self.path = path  # set -> "disk-backed" (persistence gate applies)
        # coarse catalog/DML lock (the reference gets per-index rwlocks
        # from DuckDB's StorageLock; one re-entrant lock suffices for an
        # in-process engine whose heavy work happens on-device)
        self._lock = threading.RLock()
        # write-ahead log (optional; see `storage/wal.py`). Unlike the
        # reference — whose extension-index WAL playback is broken
        # upstream (hnsw_insert_wal.test:6) — this one actually replays.
        self._wal = None
        self._replaying = False

    # single-file block-structured store suffixes: .vssdb is ours; .db
    # matches the reference tests' `load __TEST_DIR__/x.db` paths (a
    # DuckDB database file — the analog of one block-managed file, which
    # is also the only storage whose block reclaim is observable via
    # pragma_database_size, hnsw_reclaim_storage.test_slow)
    _BLOCKFILE_SUFFIXES = (".vssdb", ".db")

    @classmethod
    def _is_blockfile_path(cls, path: Optional[str]) -> bool:
        return path is not None and path.endswith(cls._BLOCKFILE_SUFFIXES)

    @staticmethod
    def _wal_path_for(path: str) -> str:
        if Database._is_blockfile_path(path):
            return path + ".wal"
        return os.path.join(path, "wal.jsonl")

    def enable_wal(self, wal_path: Optional[str] = None) -> str:
        """Log DML to a write-ahead log; `Database.open` replays records
        newer than the checkpoint through the index-maintaining DML path."""
        from vss_tpu_torch.storage.wal import WriteAheadLog

        if wal_path is None:
            if self.path is None:
                raise BinderError(
                    "enable_wal needs a path for an in-memory database"
                )
            wal_path = self._wal_path_for(self.path)
        os.makedirs(os.path.dirname(os.path.abspath(wal_path)), exist_ok=True)
        self._wal = WriteAheadLog(wal_path)
        return wal_path

    def _log_wal(self, record: dict) -> None:
        if self._wal is not None and not self._replaying:
            self._wal.append(record)

    # ------------------------------------------------------------ settings
    def set_setting(self, name: str, value):
        if name not in self.settings:
            raise BinderError(f"unrecognized configuration parameter '{name}'")
        self.settings[name] = value

    # ------------------------------------------------------------ catalog
    def create_table(self, name: str, columns: dict[str, np.ndarray]) -> Table:
        with self._lock:
            if name in self.tables:
                raise BinderError(f"table '{name}' already exists")
            t = Table(name, columns, device=self.device)
            self.tables[name] = t
            return t

    def table(self, name: str) -> Table:
        if name not in self.tables:
            raise BinderError(f"table '{name}' does not exist")
        return self.tables[name]

    def drop_table(self, name: str):
        with self._lock:
            self.table(name)
            for iname in [i for i, e in self.indexes.items() if e.table == name]:
                del self.indexes[iname]
            del self.tables[name]

    # ------------------------------------------------------------ indexes
    def create_hnsw_index(
        self,
        name: str,
        table: str,
        column: str,
        *,
        metric: str = "l2sq",
        ef_construction: int = 128,
        ef_search: int = 64,
        m: int = 16,
        m0: "int | None" = None,
        storage: str = "f32",
        wave_size: int = 1024,
        seed: int = 0,
        sharded: bool = False,
        mesh=None,
    ) -> IndexEntry:
        """CREATE INDEX ... USING HNSW. Validation mirrors
        hnsw_index_plan.cpp:21-99 (messages included)."""
        with self._lock:
            return self._create_hnsw_index_locked(
                name, table, column, metric=metric,
                ef_construction=ef_construction, ef_search=ef_search, m=m,
                m0=m0, storage=storage, wave_size=wave_size, seed=seed,
                sharded=sharded, mesh=mesh,
            )

    def _create_hnsw_index_locked(
        self, name, table, column, *, metric, ef_construction, ef_search,
        m, m0, storage, wave_size, seed, sharded, mesh,
    ) -> IndexEntry:
        if self.path is not None and not self.settings[
            "hnsw_enable_experimental_persistence"
        ]:
            raise BinderError(
                "HNSW indexes can only be created in in-memory databases, or "
                "when the configuration option "
                "'hnsw_enable_experimental_persistence' is set to true."
            )
        if not isinstance(metric, str):
            raise BinderError("HNSW index 'metric' must be a string")
        if metric not in ALLOWED_METRICS:
            allowed = ", ".join(f"'{x}'" for x in ALLOWED_METRICS)
            raise BinderError(f"HNSW index 'metric' must be one of: {allowed}")
        for label, val, lo in (
            ("ef_construction", ef_construction, 1),
            ("ef_search", ef_search, 1),
            ("M", m, 2),
            # None = option not given (defaults to 2*M); an explicit 0 is
            # rejected like the reference does (hnsw_index_plan.cpp:33-80)
            ("M0", 2 * m if m0 is None else m0, 2),
        ):
            if not isinstance(val, (int, np.integer)) or isinstance(val, bool):
                raise BinderError(f"HNSW index '{label}' must be an integer")
            if val < lo:
                raise BinderError(f"HNSW index '{label}' must be at least {lo}")
        if storage not in ("f32", "bf16", "int8"):
            raise BinderError(
                "HNSW index 'storage' must be one of: 'f32', 'bf16', 'int8'"
            )
        if name in self.indexes:
            raise BinderError(f"index '{name}' already exists")
        t = self.table(table)
        if column not in t.columns:
            raise BinderError(f"column '{column}' does not exist")
        dims = t.vector_dims(column)  # raises for non-vector columns
        cfg = HNSWConfig(
            dims=dims,
            metric=metric,
            m=m,
            m0=m0 or 0,
            ef_construction=ef_construction,
            ef_search=ef_search,
            storage_dtype=storage,
        )
        # CREATE INDEX skips NULL rows (the planner's IS NOT NULL filter,
        # hnsw_index_plan.cpp:101-139): only live non-NULL rows are indexed
        live = np.flatnonzero(t.row_valid & ~t.vector_null_mask(column))
        if sharded:
            from vss_tpu_torch.parallel import ShardedHNSWIndex, make_mesh

            idx = ShardedHNSWIndex.build(
                t.columns[column][live],
                cfg,
                mesh or make_mesh(device=self.device),
                rowids=t.rowids[live],
                wave_size=wave_size,
                seed=seed,
            )
        else:
            idx = HNSWIndex.build(
                t.columns[column][live],
                cfg,
                rowids=t.rowids[live],
                wave_size=wave_size,
                seed=seed,
                device=self.device,
            )
        entry = IndexEntry(name=name, table=table, column=column, index=idx)
        self.indexes[name] = entry
        return entry

    def drop_index(self, name: str):
        with self._lock:
            if name not in self.indexes:
                raise BinderError(f"index '{name}' does not exist")
            del self.indexes[name]

    def indexes_on(self, table: str, column: Optional[str] = None):
        return [
            e
            for e in self.indexes.values()
            if e.table == table and (column is None or e.column == column)
        ]

    # ------------------------------------------------------------ DML
    def insert(self, table: str, data: dict) -> np.ndarray:
        with self._lock:
            if self._wal is not None and not self._replaying:
                from vss_tpu_torch.storage.wal import encode_data

                self._log_wal(
                    {"op": "insert", "table": table, "data": encode_data(data)}
                )
            return self._insert_locked(table, data)

    def _insert_locked(self, table: str, data: dict) -> np.ndarray:
        t = self.table(table)
        new_ids = t.append(data)
        pos = t.positions_of_rowids(new_ids)
        for e in self.indexes_on(table):
            vecs = t.columns[e.column][pos]
            # NULL vectors are skipped, like HNSWIndex::Construct
            # (`hnsw_index.cpp:467-470`)
            ok = ~np.isnan(vecs).any(axis=1)
            if ok.any():
                e.index.insert(vecs[ok], new_ids[ok])
        return new_ids

    def delete(self, table: str, rowids: Sequence[int]) -> int:
        with self._lock:
            self._log_wal(
                {"op": "delete", "table": table,
                 "rowids": [int(r) for r in rowids]}
            )
            return self._delete_locked(table, rowids)

    def _delete_locked(self, table: str, rowids: Sequence[int]) -> int:
        t = self.table(table)
        deleted = t.delete_rowids(rowids)
        for e in self.indexes_on(table):
            e.index.delete(deleted.tolist())
        return len(deleted)

    def update(self, table: str, rowids: Sequence[int], data: dict) -> np.ndarray:
        """UPDATE = DELETE + INSERT (the reference index contract,
        SURVEY §3.5). Atomic under the DML lock."""
        with self._lock:
            if self._wal is not None and not self._replaying:
                from vss_tpu_torch.storage.wal import encode_data

                self._log_wal(
                    {"op": "update", "table": table,
                     "rowids": [int(r) for r in rowids],
                     "data": encode_data(data)}
                )
            t = self.table(table)
            pos = t.positions_of_rowids(np.asarray(list(rowids), np.int64))
            pos = pos[pos >= 0]
            old = {c: v[pos].copy() for c, v in t.columns.items()}
            old.update(data)
            self._delete_locked(table, rowids)
            return self._insert_locked(table, old)

    # ------------------------------------------------------------ pragmas
    def hnsw_index_info(self) -> list[dict]:
        """pragma_hnsw_index_info() analog (hnsw_index_pragmas.cpp:41-173)."""
        out = []
        for e in self.indexes.values():
            st = e.index.stats()
            st.update(
                {"index_name": e.name, "table_name": e.table, "column": e.column}
            )
            out.append(st)
        return out

    def hnsw_compact_index(self, name: str):
        """PRAGMA hnsw_compact_index('name')."""
        if name not in self.indexes:
            raise BinderError(f"index '{name}' does not exist")
        self.indexes[name].index.compact()

    # ------------------------------------------------------------ queries
    def execute(self, plan):
        """Run a query plan. Queries take NO catalog lock: table columns
        and index graphs are immutable snapshots (DML publishes fresh
        arrays under per-table mutexes), so reads never serialize behind
        writers — the analog of the reference's shared-lock searches
        (`hnsw_index.cpp:331-333`), minus the lock."""
        from vss_tpu_torch.query.exec import run_plan
        from vss_tpu_torch.query.rewrite import optimize

        return run_plan(self, optimize(self, plan))

    def execute_unoptimized(self, plan):
        """Run without optimizer rewrites (PRAGMA disable_optimizer analog,
        used by parity tests)."""
        from vss_tpu_torch.query.exec import run_plan

        return run_plan(self, plan)

    def explain(self, plan) -> str:
        from vss_tpu_torch.query.ir import format_plan
        from vss_tpu_torch.query.rewrite import optimize

        return format_plan(optimize(self, plan))

    def explain_analyze(self, plan) -> tuple[str, dict]:
        """Run the optimized plan with per-operator timings (EXPLAIN
        ANALYZE). Returns (report, result chunk)."""
        from vss_tpu_torch.query.exec import explain_analyze
        from vss_tpu_torch.query.rewrite import optimize

        return explain_analyze(self, optimize(self, plan))

    def sql(self, text: str):
        """Execute a SQL statement (see `query/sql.py`)."""
        from vss_tpu_torch.query.sql import execute_sql

        return execute_sql(self, text)

    # ------------------------------------------------------------ persist
    def checkpoint(self, path: Optional[str] = None):
        """Write tables + indexes + catalog to disk.

        A path ending in '.vssdb' produces a single block-structured file
        (native linked-block store, `storage/blockfile.py`); any other
        path is a checkpoint directory."""
        from vss_tpu_torch.storage.serialize import save_index

        path = path or self.path
        if path is None:
            raise BinderError("no checkpoint path given for in-memory database")
        from vss_tpu_torch.storage.blockfile import blockstore_available

        if self._is_blockfile_path(path) and blockstore_available():
            self._checkpoint_blockstore(path)
            self.path = path
            if self._wal is not None:
                self._wal.truncate()
            return
        os.makedirs(path, exist_ok=True)
        catalog = {"tables": {}, "indexes": {}, "settings": self.settings}
        for name, t in self.tables.items():
            arrs = _encode_table_arrays(t)
            np.savez_compressed(os.path.join(path, f"table_{name}.npz"), **arrs)
            catalog["tables"][name] = {"next_rowid": t.next_rowid}
        from vss_tpu_torch.parallel.sharded import ShardedHNSWIndex

        for name, e in self.indexes.items():
            meta = {"table": e.table, "column": e.column}
            target = os.path.join(path, f"index_{name}.vss")
            if not e.loaded and os.path.exists(target):
                # deferred index, stream already on disk: nothing to write
                pass
            elif isinstance(e.index, ShardedHNSWIndex):
                e.index.save(os.path.join(path, f"index_{name}.sharded"))
                meta["sharded"] = True
            elif not os.path.exists(target) or e.index.dirty:
                save_index(e.index, target)
            catalog["indexes"][name] = meta
        with open(os.path.join(path, "catalog.json"), "w") as f:
            json.dump(catalog, f)
        self.path = path
        if self._wal is not None:
            self._wal.truncate()

    def database_size(self) -> dict:
        """Block-level storage accounting — the `pragma_database_size()`
        surface the reference's reclaim test reads (total_blocks /
        used_blocks over the block-managed file). Directory checkpoints
        and in-memory databases report zero blocks (DuckDB's in-memory
        database does the same)."""
        from vss_tpu_torch.storage.blockfile import BlockStore, blockstore_available

        out = {
            "database_size": 0, "block_size": 0,
            "total_blocks": 0, "used_blocks": 0, "free_blocks": 0,
            "wal_size": 0, "memory_usage": 0, "memory_limit": 0,
        }
        p = self.path
        if (
            p is not None and self._is_blockfile_path(p)
            and os.path.isfile(p) and blockstore_available()
        ):
            with BlockStore(p) as bs:
                total = bs.total_blocks
                free = bs.free_blocks
                out.update(
                    database_size=os.path.getsize(p),
                    block_size=bs.block_size
                    if hasattr(bs, "block_size") else 0,
                    total_blocks=total,
                    used_blocks=total - free,
                    free_blocks=free,
                )
        return out

    def _checkpoint_blockstore(self, path: str):
        import io

        from vss_tpu_torch.storage.blockfile import BlockStore
        from vss_tpu_torch.storage.serialize import serialize_index

        with BlockStore(path) as bs:
            catalog = {"tables": {}, "indexes": {}, "settings": self.settings}
            live = set()
            for name, t in self.tables.items():
                arrs = _encode_table_arrays(t)
                buf = io.BytesIO()
                np.savez_compressed(buf, **arrs)
                bs.put(f"table:{name}", buf.getvalue())
                live.add(f"table:{name}")
                catalog["tables"][name] = {"next_rowid": t.next_rowid}
            from vss_tpu_torch.parallel.sharded import ShardedHNSWIndex

            for name, e in self.indexes.items():
                key = f"index:{name}"
                meta = {"table": e.table, "column": e.column}
                if not e.loaded and key in bs:
                    # deferred index with its stream already present
                    live.add(key)
                    catalog["indexes"][name] = meta
                    continue
                if isinstance(e.index, ShardedHNSWIndex):
                    meta["sharded"] = e.index.n_shards
                    meta["config"] = dataclasses.asdict(e.index.config)
                    maps = e.index._shard_maps()
                    for s in range(e.index.n_shards):
                        skey = f"{key}:shard{s}"
                        if e.index.dirty or skey not in bs:
                            buf = io.BytesIO()
                            serialize_index(e.index._extract_shard(s, maps[s]), buf)
                            bs.put(skey, buf.getvalue())
                        live.add(skey)
                    e.index.dirty = False
                elif key not in bs or e.index.dirty:
                    buf = io.BytesIO()
                    serialize_index(e.index, buf)
                    bs.put(key, buf.getvalue())
                    e.index.dirty = False
                    live.add(key)
                else:
                    live.add(key)
                catalog["indexes"][name] = meta
            # drop streams for dropped tables/indexes (block reclaim)
            for stream in bs.list():
                if stream.startswith(("table:", "index:")) and stream not in live:
                    bs.delete(stream)
            bs.put("catalog", json.dumps(catalog).encode())

    @classmethod
    def _open_blockstore(cls, path: str, device=None) -> "Database":
        import io

        from vss_tpu_torch.storage.blockfile import BlockStore
        from vss_tpu_torch.storage.serialize import deserialize_index

        with BlockStore(path) as bs:
            catalog = json.loads(bs.get("catalog").decode())
            db = cls(path=path, device=device)
            db.settings.update(catalog.get("settings", {}))
            for name, meta in catalog["tables"].items():
                data = np.load(io.BytesIO(bs.get(f"table:{name}")))
                cols = _decode_table_columns(data)
                t = Table(name, cols, device=db.device)
                t.rowids = data["__rowids__"]
                t.row_valid = data["__valid__"]
                t.next_rowid = meta["next_rowid"]
                db.tables[name] = t
            for name, meta in catalog["indexes"].items():
                if meta.get("sharded"):
                    from vss_tpu_torch.parallel.sharded import ShardedHNSWIndex

                    sidx = ShardedHNSWIndex.from_shards(
                        HNSWConfig(**meta["config"]), int(meta["sharded"]), None, db.device,
                        lambda s, dev, key=f"index:{name}": deserialize_index(
                            io.BytesIO(bs.get(f"{key}:shard{s}")), device=dev))
                    db.indexes[name] = IndexEntry(
                        name=name, table=meta["table"], column=meta["column"], index=sidx,
                        meta=meta,
                    )
                    continue

                # deferred load: reopen the store and pull the stream
                # on first index bind (hnsw_index.cpp:221-239 analog)
                def _loader(p=path, key=f"index:{name}", dev=db.device):
                    with BlockStore(p) as bs2:
                        return deserialize_index(io.BytesIO(bs2.get(key)), device=dev)

                db.indexes[name] = IndexEntry(
                    name=name, table=meta["table"],
                    column=meta["column"], loader=_loader, meta=meta,
                )
        return db

    @classmethod
    def open(cls, path: str, device=None) -> "Database":
        """Open a checkpoint (a directory or a `.vssdb` block file, written
        by either package) on `device`, and replay its WAL."""
        from vss_tpu_torch.storage.serialize import load_index

        if cls._is_blockfile_path(path) and os.path.isfile(path):
            db = cls._open_blockstore(path, device=device)
            db._replay_wal()
            return db
        with open(os.path.join(path, "catalog.json")) as f:
            catalog = json.load(f)
        db = cls(path=path, device=device)
        db.settings.update(catalog.get("settings", {}))
        for name, meta in catalog["tables"].items():
            data = np.load(os.path.join(path, f"table_{name}.npz"))
            cols = _decode_table_columns(data)
            t = Table(name, cols, device=db.device)
            t.rowids = data["__rowids__"]
            t.row_valid = data["__valid__"]
            t.next_rowid = meta["next_rowid"]
            db.tables[name] = t
        for name, meta in catalog["indexes"].items():
            if meta.get("sharded"):
                from vss_tpu_torch.parallel.sharded import ShardedHNSWIndex

                db.indexes[name] = IndexEntry(
                    name=name, table=meta["table"], column=meta["column"],
                    index=ShardedHNSWIndex.load(
                        os.path.join(path, f"index_{name}.sharded"), device=db.device),
                    meta=meta,
                )
                continue
            # deferred: no vector bytes move until the first bind
            db.indexes[name] = IndexEntry(
                name=name, table=meta["table"], column=meta["column"],
                loader=(lambda p=os.path.join(path, f"index_{name}.vss"),
                        dev=db.device: load_index(p, device=dev)),
                meta=meta,
            )
        db._replay_wal()
        return db

    def _replay_wal(self) -> None:
        """Apply DML logged after the last checkpoint, then keep logging
        to the same file."""
        from vss_tpu_torch.storage.wal import WriteAheadLog

        wal_path = self._wal_path_for(self.path)
        if not os.path.exists(wal_path):
            return
        self._replaying = True
        try:
            WriteAheadLog.replay(wal_path, self)
        finally:
            self._replaying = False
        self.enable_wal(wal_path)
