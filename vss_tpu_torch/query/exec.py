"""Physical plan execution.

Execution model: a plan runs to a single result chunk (dict of NumPy
columns). The heavy operators dispatch to the device kernels —
`HNSW_INDEX_SCAN` runs the batched beam search and then fetches base rows
by rowid exactly like the reference scan function
(duckdb-vss `src/hnsw/hnsw_index_scan.cpp:95-121`: the index yields
row-ids only; visible distances are recomputed by projections);
`BRUTE_FORCE_TOPK` runs the exact scan (K3, or K4 past k=64);
`HNSW_INDEX_JOIN` batches all outer rows through one multi-query search
(the reference does STANDARD_VECTOR_SIZE/k rows per batch,
`hnsw_optimize_join.cpp:135` — a CPU chunking concern; here the whole
outer side is one batch).

Reproduces `vss_tpu/query/exec.py`. The index and `bruteforce_topk`
return tensors on the database's device; every result read on the host
goes through `table.host` (`.cpu().numpy()`). The JAX package pads each
batch to a power of two (`_bucket`) to bound XLA recompiles; PyTorch
does not recompile per shape, so the port passes the batch as it is:
the first B rows are the same either way.
"""
from __future__ import annotations

import numpy as np
import torch

from vss_tpu_torch.ops.topk import bruteforce_topk
from vss_tpu_torch.query.functions import resolve_function
from vss_tpu_torch.query.ir import (
    BruteForceTopK,
    Filter,
    HNSWIndexJoinNode,
    HNSWIndexScan,
    KNNJoin,
    Limit,
    MinByAgg,
    PlanNode,
    Projection,
    Scan,
    TopK,
)
from vss_tpu_torch.query.table import Database, host

__all__ = ["run_plan", "explain_analyze", "analyze_plan"]


def _is_null(vals: np.ndarray) -> np.ndarray:
    if vals.dtype.kind == "f":
        nan = np.isnan(vals)
        return nan.any(axis=1) if vals.ndim == 2 else nan
    if vals.dtype == object:
        return np.asarray([v is None for v in vals])
    return np.zeros(len(vals), bool)


def _expr_cache_key(e):
    """Content-exact, hashable key for an Expr tree (or field value).

    repr()/str() are unusable as cache keys here: numpy truncates array
    reprs past the user-settable print threshold and Const.__str__
    abbreviates vectors as "[n-vec]", so two DIFFERENT vector predicates
    could collide and serve the wrong cached filter mask. Arrays key on
    (dtype, shape, raw bytes); dataclass Exprs key structurally."""
    import dataclasses

    from vss_tpu_torch.query.ir import Expr

    if isinstance(e, Expr) and dataclasses.is_dataclass(e):
        return (type(e).__name__,) + tuple(
            _expr_cache_key(getattr(e, f.name))
            for f in dataclasses.fields(e)
        )
    if isinstance(e, (list, tuple)):
        return ("seq",) + tuple(_expr_cache_key(x) for x in e)
    if isinstance(e, np.ndarray):
        return ("nd", str(e.dtype), e.shape,
                np.ascontiguousarray(e).tobytes())
    return ("v", repr(e))


# bound on cached device filter masks per table: a workload with
# per-query literals (price < ?) would otherwise grow one device mask
# per distinct predicate forever (ADVICE r3)
_FILTER_MASK_CACHE_CAP = 32


def _device_filter_mask(t, entry, index_name, pushed_filter):
    """Slot mask (a bool tensor on the index's device) for a pushed
    predicate, cached per
    (predicate content, table version, graph identity). Only the FIRST
    use of a predicate pays the host pass (predicate eval + isin over
    the slot tape). The cache invalidates with the table's
    _device_cache on any table DML (`Table._bump`); the graph-identity
    check catches index-side changes (insert/delete/compact publish a
    fresh graph object). The reference applies the predicate inside the
    search (index_dense.hpp:1816-1828); here it is a pure device mask
    shared by the graph path and the exact-scan path."""
    if pushed_filter is None:
        return None
    g = getattr(entry.index, "graph", None) or getattr(
        entry.index, "graphs", None
    )
    key = ("__filter_mask__", index_name, _expr_cache_key(pushed_filter))
    cached = t._device_cache.get(key)
    if cached is not None and g is not None and cached[0]() is g:
        return cached[1]
    # evaluate the predicate over just its referenced columns, then lift
    # allowed rowids to a slot mask with one vectorized isin (sort-based,
    # not a per-slot hash probe)
    cols = _expr_columns(pushed_filter)
    chunk = t.chunk(columns=[c for c in cols if c in t.columns])
    ok = np.asarray(pushed_filter.evaluate(chunk), bool)
    allowed = chunk["__rowid__"][ok]
    # both layouts: [cap] single-shard, [S, cap] sharded
    srow = entry.index.slot_rowid_array()
    filter_mask = torch.from_numpy(np.isin(srow, allowed)).to(entry.index.device)
    if g is not None:
        # the validity token is a WEAKREF to the graph object: a
        # superseded graph (compact/insert publishes a new one) must not
        # stay pinned in device memory by stale mask entries (ADVICE
        # r3). Tuples/lists (sharded `graphs`) don't support weakref —
        # hold those strongly; the LRU cap still bounds them.
        import weakref

        try:
            token = weakref.ref(g)
        except TypeError:
            token = (lambda obj: (lambda: obj))(g)
        fkeys = [
            k for k in t._device_cache
            if isinstance(k, tuple) and k and k[0] == "__filter_mask__"
        ]
        if len(fkeys) >= _FILTER_MASK_CACHE_CAP:
            t._device_cache.pop(fkeys[0], None)  # oldest-in
        t._device_cache[key] = (token, filter_mask)
    return filter_mask


def _expr_columns(e) -> set:
    """Column names referenced by an expression tree."""
    from vss_tpu_torch.query.ir import ColumnRef

    out = set()

    def walk(x):
        if isinstance(x, ColumnRef):
            out.add(x.name)
        for c in x.children():
            walk(c)

    walk(e)
    return out


def _unpack_agg(item):
    """Aggregate item: (fn, arg[, orders[, filter]])."""
    fn, arg, *rest = item
    orders = rest[0] if len(rest) > 0 else None
    filt = rest[1] if len(rest) > 1 else None
    return fn, arg, orders, filt


def _order_positions(chunk, keys, n, rowid_tiebreak=True):
    """Row order under a multi-key ORDER BY. Each key is (Expr, ascending);
    NULLs (NaN / None) sort last in either direction, matching DuckDB's
    default null order. Ties break by rowid for determinism."""
    cols = []
    if rowid_tiebreak and "__rowid__" in chunk:
        cols.append(np.asarray(chunk["__rowid__"]))
    else:
        cols.append(np.arange(n))
    for e, asc in reversed(keys):
        vals = np.asarray(e.evaluate(chunk))
        if vals.dtype == object:
            null = np.asarray([v is None for v in vals])
            filled = np.where(null, "", vals)
            _, codes = np.unique(filled.astype(str), return_inverse=True)
            key = codes.astype(np.float64)
            key = np.where(null, np.inf, key if asc else -key)
        else:
            key = vals.astype(np.float64)
            null = np.isnan(key)
            key = np.where(null, np.inf, key if asc else -key)
        cols.append(key)
    return np.lexsort(tuple(cols))


def _sort_subset(chunk, keys, positions):
    """Order a row subset by aggregate-internal ORDER BY keys."""
    sub = {c: np.asarray(v)[positions] for c, v in chunk.items()}
    order = _order_positions(sub, keys, len(positions), rowid_tiebreak=False)
    return positions[order]


def _search_index(
    db: Database, index_name: str, queries: np.ndarray, k: int,
    filter_mask=None,
):
    """Batched index search with ef from the hnsw_ef_search setting
    (`hnsw_index.cpp:318-329`: per-scan ef = max(setting, index default))."""
    entry = db.indexes[index_name]
    setting = int(db.settings.get("hnsw_ef_search") or 0)
    ef = max(setting, entry.index.config.ef_search, k)
    d, rows = entry.index.search(queries, k=k, ef=ef, filter_mask=filter_mask)
    return host(d), host(rows)


def analyze_plan(db: Database, node: PlanNode) -> tuple[dict, dict]:
    """Run the plan timing each operator: ({id(node): (seconds, rows)},
    result chunk). An operator's seconds include its children's. On a
    CUDA database the device is synchronised before each clock reading,
    so an operator's time holds its device work and not only its
    enqueue."""
    import time

    def now() -> float:
        if db.device.type == "cuda":
            torch.cuda.synchronize(db.device)
        return time.perf_counter()

    timings: dict[int, tuple[float, int]] = {}

    def timed_run(n: PlanNode) -> dict[str, np.ndarray]:
        t0 = now()
        out = _run_plan_inner(db, n, timed_run)
        dt = now() - t0
        rows = len(next(iter(out.values()))) if out else 0
        timings[id(n)] = (dt, rows)
        return out

    return timings, timed_run(node)


def explain_analyze(db: Database, node: PlanNode) -> tuple[str, dict]:
    """Run the plan with per-operator wall time + row counts (the EXPLAIN
    ANALYZE surface the reference gets from DuckDB; `analyze_plan`).
    Returns (report text, result chunk)."""
    timings, result = analyze_plan(db, node)

    def fmt(n: PlanNode, depth: int) -> list[str]:
        dt, rows = timings.get(id(n), (0.0, 0))
        own = dt - sum(timings.get(id(c), (0.0, 0))[0] for c in n.children())
        lines = [
            "  " * depth
            + f"{n.label()}  [{own * 1e3:.2f}ms, {rows} rows]"
        ]
        # operator detail line, matching the reference's analyze boxes
        # ("HNSW Index: <name>", asserted by where_clause_segfault.test:43)
        idx_name = getattr(n, "index_name", None)
        if idx_name is not None:
            lines.append("  " * (depth + 1) + f"HNSW Index: {idx_name}")
        for c in n.children():
            lines.extend(fmt(c, depth + 1))
        return lines

    return "\n".join(fmt(node, 0)), result


def run_plan(db: Database, node: PlanNode) -> dict[str, np.ndarray]:
    def run(n):
        return run_plan(db, n)

    return _run_plan_inner(db, node, run)


def _run_plan_inner(db: Database, node: PlanNode, run) -> dict[str, np.ndarray]:
    if isinstance(node, Scan):
        return db.table(node.table).chunk()

    from vss_tpu_torch.query.ir import ChunkSource, GroupByAggregate, SimpleAggregate

    if isinstance(node, ChunkSource):
        return dict(node.data)

    if isinstance(node, GroupByAggregate):
        chunk = run(node.child)
        n = len(next(iter(chunk.values()))) if chunk else 0
        # factorize composite group keys; when the running key-product
        # cardinality would overflow int64, re-compact codes first (at
        # most n distinct codes ever exist, and n << 2^62)
        codes = np.zeros(n, np.int64)
        card = 1
        uniques = []
        for key in node.keys:
            u, inv = np.unique(np.asarray(chunk[key]), return_inverse=True)
            if card > (1 << 62) // (len(u) + 1):
                codes = np.unique(codes, return_inverse=True)[1].astype(np.int64)
                card = max(n, 1)
            codes = codes * (len(u) + 1) + inv
            card = card * (len(u) + 1)
            uniques.append((key, u, inv))
        group_codes, first_pos, ginv = np.unique(
            codes, return_index=True, return_inverse=True
        )
        out: dict[str, np.ndarray] = {
            key: np.asarray(chunk[key])[first_pos] for key in node.keys
        }
        n_groups = len(group_codes)
        for name, item in node.items.items():
            fn, arg, orders, filt = _unpack_agg(item)
            fmask = (
                np.asarray(filt.evaluate(chunk), bool)
                if filt is not None
                else np.ones(n, bool)
            )
            if fn == "list":
                # per-group ordered value list (DuckDB list() aggregate)
                lists = []
                for g in range(n_groups):
                    pos = np.flatnonzero((ginv == g) & fmask)
                    if orders:
                        pos = _sort_subset(chunk, orders, pos)
                    lists.append(np.asarray(arg.evaluate(chunk))[pos].tolist())
                arr = np.empty(n_groups, object)
                arr[:] = lists
                out[name] = arr
                continue
            if fn == "count" and arg is None:
                out[name] = np.bincount(
                    ginv, weights=fmask.astype(np.float64), minlength=n_groups
                ).astype(np.int64)
                continue
            if fn == "any_value":
                # first non-filtered value per group (DuckDB: first
                # non-NULL; group order here is stable input order)
                vals_a = np.asarray(arg.evaluate(chunk))
                res = np.empty(n_groups, object)
                for g in range(n_groups):
                    pos = np.flatnonzero((ginv == g) & fmask)
                    res[g] = vals_a[pos[0]].tolist() if len(pos) else None
                out[name] = res
                continue
            if fn == "bool_and":
                bv = np.asarray(arg.evaluate(chunk)).astype(bool)
                res = np.ones(n_groups, bool)
                np.logical_and.at(res, ginv[fmask], bv[fmask])
                out[name] = res
                continue
            vals = np.asarray(arg.evaluate(chunk), np.float64)
            vals = np.where(fmask, vals, np.nan)
            # SQL aggregate semantics: NULLs (NaN-encoded) are skipped;
            # a group whose inputs are all NULL aggregates to NULL (NaN)
            null = _is_null(vals)
            nn = np.bincount(
                ginv, weights=(~null).astype(np.float64), minlength=n_groups
            )
            if fn == "count":
                out[name] = nn.astype(np.int64)
            elif fn == "sum":
                s = np.bincount(
                    ginv, weights=np.where(null, 0.0, vals), minlength=n_groups
                )
                out[name] = np.where(nn > 0, s, np.nan)
            elif fn == "avg":
                s = np.bincount(
                    ginv, weights=np.where(null, 0.0, vals), minlength=n_groups
                )
                out[name] = np.where(nn > 0, s / np.maximum(nn, 1), np.nan)
            elif fn in ("min", "max"):
                red = np.full(n_groups, np.inf if fn == "min" else -np.inf)
                ufn = np.minimum if fn == "min" else np.maximum
                masked = np.where(null, np.inf if fn == "min" else -np.inf, vals)
                ufn.at(red, ginv, masked)
                out[name] = np.where(nn > 0, red, np.nan)
            else:
                raise NotImplementedError(f"aggregate '{fn}'")
        return out

    if isinstance(node, SimpleAggregate):
        chunk = run(node.child)
        n = len(next(iter(chunk.values()))) if chunk else 0
        out = {}
        for name, item in node.items.items():
            fn, arg, orders, filt = _unpack_agg(item)
            fmask = (
                np.asarray(filt.evaluate(chunk), bool)
                if filt is not None and n
                else np.ones(n, bool)
            )
            if fn == "list":
                pos = np.flatnonzero(fmask)
                if orders:
                    pos = _sort_subset(chunk, orders, pos)
                vals = np.asarray(arg.evaluate(chunk))[pos] if n else []
                arr = np.empty(1, object)
                arr[0] = list(vals.tolist() if n else [])
                out[name] = arr
                continue
            if fn == "count" and arg is None:
                out[name] = np.asarray([int(fmask.sum())])
                continue
            vals = np.asarray(arg.evaluate(chunk)) if n else np.asarray([])
            if n and filt is not None:
                vals = vals[fmask]
            if fn == "count":
                out[name] = np.asarray([int(np.sum(~_is_null(vals)))])
                continue
            if fn == "bool_and":
                out[name] = np.asarray(
                    [bool(np.all(vals.astype(bool))) if len(vals) else None]
                )
                continue
            # SQL semantics: skip NULLs; empty / all-NULL input -> NULL
            nonnull = vals[~_is_null(vals)] if n else vals
            m = len(nonnull)
            if fn == "sum":
                out[name] = np.asarray([nonnull.sum() if m else None])
            elif fn == "avg":
                out[name] = np.asarray([nonnull.mean() if m else None])
            elif fn == "min":
                out[name] = np.asarray([nonnull.min() if m else None])
            elif fn == "max":
                out[name] = np.asarray([nonnull.max() if m else None])
            else:
                raise NotImplementedError(f"aggregate '{fn}'")
        return out

    if isinstance(node, Filter):
        chunk = run(node.child)
        mask = np.asarray(node.predicate.evaluate(chunk), bool)
        return {c: v[mask] for c, v in chunk.items()}

    if isinstance(node, Projection):
        chunk = run(node.child)
        return {name: np.asarray(e.evaluate(chunk)) for name, e in node.exprs.items()}

    if isinstance(node, Limit):
        chunk = run(node.child)
        return {c: v[: node.k] for c, v in chunk.items()}

    if isinstance(node, TopK):
        chunk = run(node.child)
        n = len(next(iter(chunk.values()))) if chunk else 0
        keys = [(node.order, node.ascending)] + list(node.tail or ())
        order = _order_positions(chunk, keys, n)[: node.k]
        return {c: v[order] for c, v in chunk.items()}

    from vss_tpu_torch.query.ir import Extend

    if isinstance(node, Extend):
        chunk = dict(run(node.child))
        for name, e in node.exprs.items():
            chunk[name] = np.asarray(e.evaluate(chunk))
        return chunk

    if isinstance(node, MinByAgg):
        chunk = run(node.child)
        n = len(next(iter(chunk.values()))) if chunk else 0
        if node.filter is not None and n:
            mask = np.asarray(node.filter.evaluate(chunk), bool)
            chunk = {c: np.asarray(v)[mask] for c, v in chunk.items()}
            n = int(mask.sum())
        order = _order_positions(
            chunk, [(node.order, not node.descending)], n
        )[: node.k]
        vals = np.asarray(node.value.evaluate(chunk))[order]
        return {node.output: np.asarray([vals.tolist()], dtype=object)}

    if isinstance(node, HNSWIndexScan):
        entry = db.indexes[node.index_name]
        t = db.table(node.table)
        q = np.asarray(node.query, np.float32)[None, :]
        filter_mask = _device_filter_mask(
            t, entry, node.index_name, node.pushed_filter
        )
        _, rows = _search_index(
            db, node.index_name, q, node.k, filter_mask=filter_mask
        )
        rows = rows[0]
        return t.fetch(rows[rows >= 0], columns=node.projection)

    if isinstance(node, BruteForceTopK):
        t = db.table(node.table)
        q = torch.from_numpy(np.asarray(node.query, np.float32)[None, :])
        if node.via_index is not None:
            # EXACT_SCAN_TOPK: storage-native scan over the index tape
            # (+ exact f32 rerank) — the planner-selected serving path.
            # Pushed filters mask slots BEFORE top-k, so k applies to
            # the filtered set (exact filtered search).
            entry = db.indexes[node.via_index]
            filter_mask = _device_filter_mask(
                t, entry, node.via_index, node.pushed_filter
            )
            _, rows = entry.index.scan_search(
                q, node.k, filter_mask=filter_mask
            )
            rows = host(rows)[0]
            return t.fetch(rows[rows >= 0], columns=node.projection)
        vecs, valid = t.device_column(node.column)
        fdef = resolve_function(node.metric_function)
        d, slots = bruteforce_topk(
            q, vecs, node.k, fdef.index_metric, valid_mask=valid,
            device=vecs.device,
        )
        slots = host(slots)[0]
        rows = t.rowids[slots[slots >= 0]]
        return t.fetch(rows, columns=node.projection)

    if isinstance(node, HNSWIndexJoinNode):
        left = run(node.left)
        entry = db.indexes[node.index_name]
        t = db.table(node.table)
        queries = np.asarray(node.left_vector.evaluate(left), np.float32)
        if queries.ndim != 2:
            raise ValueError("knn join left vector must evaluate to [n, d]")
        nL = queries.shape[0]
        if nL == 0:
            out = {f"l_{c}": v[:0] for c, v in left.items()}
            out.update({f"r_{c}": v[:0] for c, v in t.chunk().items()})
            out["row_number"] = np.zeros(0, np.int64)
            return out
        _, rows = _search_index(
            db, node.index_name, np.nan_to_num(queries), node.k
        )
        # NULL outer vectors produce no matches
        rows = np.where(np.isnan(queries).any(1)[:, None], -1, rows)
        # expand: left row i repeated per valid match, with 1-based rank
        # (the reference emits a row_number column, hnsw_optimize_join.cpp:130)
        valid = rows >= 0
        counts = valid.sum(1)
        left_sel = np.repeat(np.arange(nL), counts)
        flat_rows = rows[valid]
        ranks = np.concatenate([np.arange(1, c + 1) for c in counts]) if nL else []
        out = {f"l_{c}": v[left_sel] for c, v in left.items()}
        inner = t.fetch(flat_rows)
        for c, v in inner.items():
            out[f"r_{c}"] = v
        out["row_number"] = np.asarray(ranks, np.int64)
        return out

    from vss_tpu_torch.query.ir import IndexedLateralJoin, LateralJoin

    if isinstance(node, LateralJoin):
        return _exec_lateral_brute(db, node, run)

    if isinstance(node, IndexedLateralJoin):
        return _exec_lateral_indexed(db, node, run)

    if isinstance(node, KNNJoin):
        # exact join: via the index tape's batched scan when the planner
        # routed it (EXACT_SCAN_JOIN — one tape stream amortized over
        # the whole outer batch), else the f32 table-column fallback
        left = run(node.left)
        t = db.table(node.right_table)
        queries = np.asarray(node.left_vector.evaluate(left), np.float32)
        fdef = resolve_function(node.metric_function)
        nL = queries.shape[0]
        if nL == 0:
            out = {f"l_{c}": v[:0] for c, v in left.items()}
            out.update({f"r_{c}": v[:0] for c, v in t.chunk().items()})
            out["row_number"] = np.zeros(0, np.int64)
            return out
        qp = np.nan_to_num(queries)
        if node.via_index is not None:
            entry = db.indexes[node.via_index]
            _, rows_all = entry.index.scan_search(qp, node.k)
            rows_all = host(rows_all)
            rows_all = np.where(
                np.isnan(queries).any(1)[:, None], -1, rows_all
            )
            valid_m = rows_all >= 0
            counts = valid_m.sum(1)
            left_sel = np.repeat(np.arange(nL), counts)
            rows = rows_all[valid_m]
        else:
            vecs, valid = t.device_column(node.right_column)
            d, slots = bruteforce_topk(
                torch.from_numpy(qp), vecs, node.k, fdef.index_metric,
                valid_mask=valid, device=vecs.device,
            )
            slots = host(slots)
            slots = np.where(np.isnan(queries).any(1)[:, None], -1, slots)
            valid_m = slots >= 0
            counts = valid_m.sum(1)
            left_sel = np.repeat(np.arange(nL), counts)
            flat_slots = slots[valid_m]
            rows = t.rowids[flat_slots]
        ranks = np.concatenate([np.arange(1, c + 1) for c in counts]) if nL else []
        out = {f"l_{c}": v[left_sel] for c, v in left.items()}
        inner = t.fetch(rows)
        for c, v in inner.items():
            out[f"r_{c}"] = v
        out["row_number"] = np.asarray(ranks, np.int64)
        return out

    raise NotImplementedError(f"cannot execute {type(node).__name__}")


def _broadcast_row(val, dtype, n):
    """One outer-row value broadcast to n rows (scalar or vector)."""
    v = np.asarray(val)
    if v.ndim >= 1:
        return np.broadcast_to(v, (n,) + v.shape)
    out = np.empty(n, dtype)
    out[:] = val
    return out


def _qualified_scope(chunk, table, alias):
    """chunk keys + `table.col` / `alias.col` qualified duplicates."""
    scope = dict(chunk)
    for c, v in chunk.items():
        if "." in c or c.startswith("__"):
            continue
        scope[f"{table}.{c}"] = v
        if alias != table:
            scope[f"{alias}.{c}"] = v
    return scope


def _lateral_output(node, left, left_sel, sub_vals):
    """Assemble the join output chunk: outer columns (sliced by left_sel)
    then sub-item columns, with qualified duplicates of the outer names."""
    out: dict[str, np.ndarray] = {}
    for c, v in left.items():
        out[c] = np.asarray(v)[left_sel]
        if "." not in c and not c.startswith("__"):
            out[f"{node.left_table}.{c}"] = out[c]
            if node.left_alias != node.left_table:
                out[f"{node.left_alias}.{c}"] = out[c]
    for name, _ in node.sub_items:
        out[name] = sub_vals[name]
        out[f"{node.right_alias}.{name}"] = sub_vals[name]
    return out


def _exec_lateral_brute(db: Database, node, run) -> dict[str, np.ndarray]:
    """Unoptimized lateral top-k join: per outer row, order ALL inner rows
    by the subquery's keys (NULLs last) and keep k — the semantics DuckDB's
    un-rewritten delim-join plan produces. Correlated outer columns and
    select aliases resolve left-to-right inside the subquery scope."""
    left = run(node.left)
    t = db.table(node.right_table)
    inner = t.chunk()
    nL = len(next(iter(left.values()))) if left else 0
    nR = len(inner["__rowid__"])
    base_scope = _qualified_scope(inner, node.right_table, node.right_alias)

    left_idx: list[np.ndarray] = []
    sub_parts: dict[str, list] = {name: [] for name, _ in node.sub_items}
    for i in range(nL):
        scope = dict(base_scope)
        for c, v in left.items():
            if "." in c:
                continue
            col = _broadcast_row(np.asarray(v)[i], np.asarray(v).dtype, nR)
            if not c.startswith("__"):
                scope[f"{node.left_table}.{c}"] = col
                if node.left_alias != node.left_table:
                    scope[f"{node.left_alias}.{c}"] = col
            if c not in scope:  # inner scope wins for unqualified names
                scope[c] = col
        vals_i = {}
        for name, e in node.sub_items:
            v = np.asarray(e.evaluate(scope))
            scope[name] = v
            vals_i[name] = v
        order = _order_positions(scope, node.order_keys, nR)
        if node.where is not None:
            ok = np.asarray(node.where.evaluate(scope), bool)
            order = order[ok[order]]
        sel = order[: node.k]
        left_idx.append(np.full(len(sel), i))
        for name in vals_i:
            sub_parts[name].append(vals_i[name][sel])
    left_sel = (
        np.concatenate(left_idx) if left_idx else np.zeros(0, np.int64)
    )
    sub_vals = {
        name: (
            np.concatenate(parts)
            if parts
            else np.zeros(0)
        )
        for name, parts in sub_parts.items()
    }
    return _lateral_output(node, left, left_sel, sub_vals)


def _exec_lateral_indexed(db: Database, node, run) -> dict[str, np.ndarray]:
    """Index-accelerated lateral join: one batched multi-query search for
    all outer rows, one bulk fetch, vectorized sub-item evaluation — the
    PhysicalHNSWIndexJoin execution shape (`hnsw_optimize_join.cpp:111-167`)
    without its STANDARD_VECTOR_SIZE/k batching (the whole outer side is
    one device batch here)."""
    left = run(node.left)
    t = db.table(node.table)
    louter = _qualified_scope(left, node.left_table, node.left_alias)
    queries = np.asarray(node.outer_vector.evaluate(louter), np.float32)
    nL = queries.shape[0]
    if nL == 0:
        return _lateral_output(
            node, left, np.zeros(0, np.int64),
            {name: np.zeros(0) for name, _ in node.sub_items},
        )
    _, rows = _search_index(db, node.index_name, np.nan_to_num(queries), node.k)
    # NULL outer vectors produce no matches on the index path (the brute
    # plan keeps them with NULL distances; the reference only rewrites
    # single-order-key plans, where its operator behaves the same way)
    rows = np.where(np.isnan(queries).any(1)[:, None], -1, rows)
    valid = rows >= 0
    counts = valid.sum(1)
    left_sel = np.repeat(np.arange(nL), counts)
    flat_rows = rows[valid]
    fetched = t.fetch(flat_rows)
    nF = len(fetched["__rowid__"])
    scope = _qualified_scope(fetched, node.table, node.right_alias)
    for c, v in left.items():
        if "." in c:
            continue
        col = np.asarray(v)[left_sel]
        if not c.startswith("__"):
            scope[f"{node.left_table}.{c}"] = col
            if node.left_alias != node.left_table:
                scope[f"{node.left_alias}.{c}"] = col
        if c not in scope:
            scope[c] = col
    sub_vals = {}
    for name, e in node.sub_items:
        v = np.asarray(e.evaluate(scope))
        scope[name] = v
        sub_vals[name] = v
    assert nF == len(left_sel), "index fetch dropped rows"
    return _lateral_output(node, left, left_sel, sub_vals)
