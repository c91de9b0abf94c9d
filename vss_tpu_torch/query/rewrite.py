"""Optimizer rewrite rules.

Reproduces `vss_tpu/query/rewrite.py` (numpy only); the operator names
are the same, so `EXPLAIN` prints the same plan text in both packages.

The four plan rewrites the reference installs as DuckDB optimizer
extensions, re-expressed over our IR:

  1. expression rule: (1.0 - array_cosine_similarity(a, b)) ->
     array_cosine_distance(a, b)                (hnsw_optimize_expr.cpp)
  2. TopN -> HNSW_INDEX_SCAN                    (hnsw_optimize_scan.cpp)
  3. min_by(col, dist, k) -> index scan          (hnsw_optimize_topk.cpp)
  4. k-NN lateral join -> HNSW_INDEX_JOIN        (hnsw_optimize_join.cpp)

plus one extra with no reference counterpart: an un-indexed
TopN over a distance expression lowers to the exact brute-force operator
(`BruteForceTopK`) that runs the exact distance scan, instead of a scalar
sort. Filters under a rewritten TopN are pulled up above the index scan,
matching the reference's post-filter semantics
(`hnsw_optimize_scan.cpp:168-198`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from vss_tpu_torch.ops.distance import Metric
from vss_tpu_torch.query.functions import resolve_function
from vss_tpu_torch.query.ir import (
    BinOp,
    BruteForceTopK,
    ColumnRef,
    Const,
    Expr,
    Filter,
    Func,
    HNSWIndexJoinNode,
    HNSWIndexScan,
    KNNJoin,
    MinByAgg,
    Not,
    PlanNode,
    Projection,
    Scan,
    TopK,
)
from vss_tpu_torch.query.table import Database

__all__ = ["optimize", "match_distance_order"]

# k must stay under the reference's vector-chunk unit for these rewrites
# (hnsw_optimize_topk.cpp:172, hnsw_optimize_join.cpp:458)
MAX_K = 2048

_ITEMSIZE = {"f32": 4, "bf16": 2, "int8": 1}


def _cost_prefers_exact(db: Database, entry, n_rows: int, n_queries: int,
                        k: int) -> bool:
    """Hybrid planner decision (no reference counterpart — the reference
    always picks the index; see query/cost.py): with the opt-in
    `hnsw_cost_model` setting, estimate the exact scan vs the beam
    search for this (corpus, batch) and skip the index rewrite when the
    scan is cheaper. Exactness only improves results, so the flip is
    always sound."""
    if not db.settings.get("hnsw_cost_model"):
        return False
    from vss_tpu_torch.query.cost import prefer_exact

    cfg = entry.index.config
    ef = max(int(db.settings.get("hnsw_ef_search") or 0), cfg.ef_search, k)
    # price the operator that would actually run: indexes with a
    # native-scannable tape serve the exact path via the storage-native
    # segmin scan (int8 streams 4x fewer bytes than the f32 matmul)
    tape_scan = _scan_via_index(entry)
    return prefer_exact(
        n_rows, cfg.dims, _ITEMSIZE.get(cfg.storage_dtype, 4), n_queries,
        ef, cfg.m0, tape_scan=tape_scan,
    )


def _scan_via_index(entry) -> bool:
    """Whether this index can serve the exact path from its own tape
    (single-shard dense index with a supported storage dtype)."""
    return (
        entry is not None
        and hasattr(entry.index, "scan_search")
        and entry.index.config.storage_dtype in ("int8", "bf16", "f32")
    )


# --------------------------------------------------------- expression rule
def rewrite_expr(e: Expr) -> Expr:
    """(1.0 - array_cosine_similarity(a,b)) -> array_cosine_distance(a,b)."""
    if isinstance(e, BinOp):
        left = rewrite_expr(e.left)
        right = rewrite_expr(e.right)
        if (
            e.op == "-"
            and isinstance(left, Const)
            and np.ndim(left.value) == 0
            and float(np.asarray(left.value)) == 1.0
            and isinstance(right, Func)
            and right.name == "array_cosine_similarity"
        ):
            return Func("array_cosine_distance", right.args)
        return BinOp(e.op, left, right)
    if isinstance(e, Func):
        f = Func(e.name, [rewrite_expr(a) for a in e.args])
        f.orders, f.filter = e.orders, e.filter
        return f
    if isinstance(e, Not):
        return Not(rewrite_expr(e.child))
    from vss_tpu_torch.query.ir import Cast

    if isinstance(e, Cast):
        return Cast(rewrite_expr(e.child), e.type_name, e.dims)
    return e


def _rewrite_plan_exprs(node: PlanNode) -> PlanNode:
    if isinstance(node, Filter):
        return Filter(_rewrite_plan_exprs(node.child), rewrite_expr(node.predicate))
    if isinstance(node, Projection):
        return Projection(
            _rewrite_plan_exprs(node.child),
            {k: rewrite_expr(v) for k, v in node.exprs.items()},
        )
    if isinstance(node, TopK):
        return dataclasses.replace(
            node,
            child=_rewrite_plan_exprs(node.child),
            order=rewrite_expr(node.order),
            tail=None if node.tail is None else [
                (rewrite_expr(e), asc) for e, asc in node.tail
            ],
        )
    if isinstance(node, MinByAgg):
        return dataclasses.replace(
            node,
            child=_rewrite_plan_exprs(node.child),
            value=rewrite_expr(node.value),
            order=rewrite_expr(node.order),
        )
    if isinstance(node, KNNJoin):
        return KNNJoin(
            _rewrite_plan_exprs(node.left),
            node.right_table,
            rewrite_expr(node.left_vector),
            node.right_column,
            node.k,
            node.metric_function,
        )
    from vss_tpu_torch.query.ir import Extend, LateralJoin

    if isinstance(node, LateralJoin):
        return dataclasses.replace(
            node,
            left=_rewrite_plan_exprs(node.left),
            sub_items=[(n, rewrite_expr(e)) for n, e in node.sub_items],
            order_keys=[(rewrite_expr(e), asc) for e, asc in node.order_keys],
            where=None if node.where is None else rewrite_expr(node.where),
        )
    if isinstance(node, Extend):
        return Extend(
            _rewrite_plan_exprs(node.child),
            {k: rewrite_expr(v) for k, v in node.exprs.items()},
        )
    return node


# --------------------------------------------------------- index matching
def match_distance_order(order: Expr):
    """Match `distance_fn(column, const_vector)` (either argument order),
    the analog of TryMatchDistanceFunction + TryBindIndexExpression
    (`hnsw_index.cpp:610-689`). Returns (function_name, column_name,
    query_vector) or None."""
    if not isinstance(order, Func):
        return None
    try:
        fdef = resolve_function(order.name)
    except ValueError:
        return None
    if fdef.index_metric is None or len(order.args) != 2:
        return None
    a, b = order.args
    if isinstance(a, ColumnRef) and isinstance(b, Const):
        col, q = a, b
    elif isinstance(b, ColumnRef) and isinstance(a, Const):
        col, q = b, a
    else:
        return None
    qv = np.asarray(q.value, np.float32)
    if qv.ndim != 1:
        return None
    return order.name, col.name, qv


def _find_index(db: Database, table: str, column: str, fn_name: str, dims: int):
    fdef = resolve_function(fn_name)
    for e in db.indexes_on(table, column):
        if (
            Metric.parse(e.index.config.metric) == fdef.index_metric
            and e.index.config.dims == dims
        ):
            return e
    return None


def _peel_filters(node: PlanNode):
    """Collect a Filter* chain down to a Scan. Returns (filters, scan) or
    None if the chain has any other shape."""
    filters = []
    while isinstance(node, Filter):
        filters.append(node.predicate)
        node = node.child
    if isinstance(node, Scan):
        return filters, node
    return None


# --------------------------------------------------------- plan rules
def _rewrite_topk(db: Database, node: TopK) -> Optional[PlanNode]:
    if not node.ascending or not (0 < node.k < MAX_K):
        return None
    if node.tail:
        # secondary order keys block the rewrite, like the reference's
        # single-order window match (hnsw_optimize_join.cpp:479)
        return None
    m = match_distance_order(node.order)
    if m is None:
        return None
    fn_name, col, qv = m
    peeled = _peel_filters(node.child)
    if peeled is None:
        return None
    filters, scan = peeled
    t = db.table(scan.table)
    if col not in t.columns or not t.is_vector_column(col):
        return None
    if t.vector_dims(col) != qv.shape[0]:
        return None
    entry = _find_index(db, scan.table, col, fn_name, qv.shape[0])
    if entry is not None and _cost_prefers_exact(
        db, entry, t.num_rows, 1, node.k
    ):
        # hybrid planner: the exact scan is cheaper than the beam for
        # this (corpus, batch). Serve it from the INDEX TAPE when the
        # index supports it (EXACT_SCAN_TOPK: storage-native scan +
        # rerank; filters become a slot mask, so k applies to the
        # filtered set); otherwise fall back to the f32 table column.
        if _scan_via_index(entry):
            pushed = None
            if filters:
                pred = filters[0]
                for f in filters[1:]:
                    pred = BinOp("and", pred, f)
                pushed = pred
            new = BruteForceTopK(
                scan.table, col, qv, node.k, fn_name,
                via_index=entry.name, pushed_filter=pushed,
            )
            for pred in reversed(filters):  # cheap recheck above
                new = Filter(new, pred)
            return new
        if not filters:
            entry = None
    if entry is not None:
        if (
            filters
            and db.settings.get("hnsw_pushdown_filters")
            and getattr(entry.index, "supports_filter_pushdown", False)
        ):
            # push the conjunction into the scan (filtered_search); keep
            # the filters above as a cheap recheck
            pred = filters[0]
            for f in filters[1:]:
                from vss_tpu_torch.query.ir import BinOp as _BinOp

                pred = _BinOp("and", pred, f)
            new: PlanNode = HNSWIndexScan(
                scan.table, entry.name, qv, node.k, pushed_filter=pred
            )
        else:
            new = HNSWIndexScan(scan.table, entry.name, qv, node.k)
    else:
        # exact fallback — only safe with no filters below the TopN
        # (the brute-force operator applies k before filters would run)
        if filters:
            return None
        new = BruteForceTopK(scan.table, col, qv, node.k, fn_name)
    # filter pull-up: index scan produces k rows, filters apply after
    for pred in reversed(filters):
        new = Filter(new, pred)
    return new


def _rewrite_minby(db: Database, node: MinByAgg) -> Optional[PlanNode]:
    if not (0 < node.k < MAX_K):
        return None
    if node.descending:
        # max_by orders away from the index's ascending traversal
        return None
    m = match_distance_order(node.order)
    if m is None:
        return None
    fn_name, col, qv = m
    peeled = _peel_filters(node.child)
    if peeled is None:
        return None
    filters, scan = peeled
    t = db.table(scan.table)
    if col not in t.columns or not t.is_vector_column(col):
        return None
    if t.vector_dims(col) != qv.shape[0]:
        return None
    entry = _find_index(db, scan.table, col, fn_name, qv.shape[0])
    if entry is None:
        return None
    child: PlanNode = HNSWIndexScan(scan.table, entry.name, qv, node.k)
    for pred in reversed(filters):
        child = Filter(child, pred)
    # FILTER clause preserved through the rewrite, applied over the k
    # scanned rows (hnsw_optimize_topk.cpp:193 keeps it on the new list())
    return MinByAgg(
        child, node.value, node.order, node.k, node.output,
        filter=node.filter,
    )


def _match_lateral_distance(db: Database, node) -> Optional[tuple]:
    """Match a LateralJoin whose single ASC order key is
    `distance_fn(outer_vec, inner_indexed_col)` — the shape the reference's
    join optimizer accepts (`hnsw_optimize_join.cpp:457-557`: one ASC
    window order on the distance projection, k < 2048, correlated outer
    column vs indexed inner column).

    Returns (fn_name, outer_vec_expr, inner_col) or None."""
    if node.where is not None:
        return None
    if len(node.order_keys) != 1:
        return None
    key, asc = node.order_keys[0]
    if not asc:
        return None
    # the key may reference a subquery alias of the distance expression
    # (the reference's window references the projection's distance column)
    aliases = dict(node.sub_items)
    if isinstance(key, ColumnRef) and key.name in aliases:
        key = aliases[key.name]
    if not isinstance(key, Func) or len(key.args) != 2:
        return None
    try:
        fdef = resolve_function(key.name)
    except ValueError:
        return None
    if fdef.index_metric is None:
        return None
    inner_t = db.table(node.right_table)
    outer_t = db.table(node.left_table)

    def classify(e):
        """'inner'/'outer' column reference, or None."""
        if not isinstance(e, ColumnRef):
            return None
        name = e.name
        if "." in name:
            qual, col = name.split(".", 1)
            if qual in (node.right_table, node.right_alias):
                return ("inner", col) if col in inner_t.columns else None
            if qual in (node.left_table, node.left_alias):
                return ("outer", col) if col in outer_t.columns else None
            return None
        # unqualified: inner scope first, then outer
        if name in inner_t.columns:
            return ("inner", name)
        if name in outer_t.columns:
            return ("outer", name)
        return None

    a, b = classify(key.args[0]), classify(key.args[1])
    if a is None or b is None:
        return None
    sides = {a[0]: a[1], b[0]: b[1]}
    if set(sides) != {"inner", "outer"}:
        return None
    inner_col, outer_col = sides["inner"], sides["outer"]
    if not inner_t.is_vector_column(inner_col):
        return None
    if not outer_t.is_vector_column(outer_col):
        return None
    if inner_t.vector_dims(inner_col) != outer_t.vector_dims(outer_col):
        return None
    return key.name, ColumnRef(outer_col), inner_col


def _rewrite_lateral(db: Database, node) -> Optional[PlanNode]:
    from vss_tpu_torch.query.ir import IndexedLateralJoin

    if not (0 < node.k < MAX_K):
        return None
    m = _match_lateral_distance(db, node)
    if m is None:
        return None
    fn_name, outer_vec, inner_col = m
    dims = db.table(node.right_table).vector_dims(inner_col)
    entry = _find_index(db, node.right_table, inner_col, fn_name, dims)
    if entry is None:
        return None
    # hybrid planner: the exact join amortizes one table stream over
    # the whole outer batch; for large batches it beats per-row beams
    if _cost_prefers_exact(
        db, entry, db.table(node.right_table).num_rows,
        db.table(node.left_table).num_rows, node.k,
    ):
        return None
    return IndexedLateralJoin(
        optimize(db, node.left), node.left_table, node.left_alias,
        node.right_table, node.right_alias, entry.name, outer_vec,
        node.sub_items, node.k,
    )


def _rewrite_knn_join(db: Database, node: KNNJoin) -> Optional[PlanNode]:
    if node.via_index is not None:  # already planner-routed
        return None
    if not (0 < node.k < MAX_K):
        return None
    fdef = resolve_function(node.metric_function)
    if fdef.index_metric is None:
        return None
    t = db.table(node.right_table)
    if not t.is_vector_column(node.right_column):
        return None
    dims = t.vector_dims(node.right_column)
    entry = _find_index(db, node.right_table, node.right_column,
                        node.metric_function, dims)
    if entry is None:
        return None
    # hybrid planner (see _rewrite_lateral): outer cardinality is known
    # when the left side bottoms out in a table scan
    peeled = _peel_filters(node.left)
    if peeled is not None and _cost_prefers_exact(
        db, entry, t.num_rows, db.table(peeled[1].table).num_rows, node.k
    ):
        if _scan_via_index(entry):
            # batched exact join from the index tape — the scan path's
            # best regime (one tape stream amortized over the batch)
            return dataclasses.replace(
                node, left=optimize(db, node.left), via_index=entry.name
            )
        return None
    return HNSWIndexJoinNode(
        optimize(db, node.left), node.right_table, entry.name,
        node.left_vector, node.k,
    )


def optimize(db: Database, node: PlanNode) -> PlanNode:
    """Apply expression rewrites, plan rewrites (top-down), then push
    projections into the physical scans.

    `PRAGMA disable_optimizer` (a DuckDB core pragma the reference's
    tests use, e.g. `hnsw_rewrite.test:20`) turns the whole pass off —
    plans execute in their parsed logical shape."""
    if db.settings.get("disable_optimizer"):
        return node
    node = _rewrite_plan_exprs(node)
    node = _optimize_node(db, node)
    return _pushdown_projections(db, node)


def _expr_cols(e: Expr) -> set:
    out = set()

    def walk(x):
        if isinstance(x, ColumnRef):
            out.add(x.name)
        for c in x.children():
            walk(c)

    walk(e)
    return out


def _pushdown_projections(db: Database, node: PlanNode) -> PlanNode:
    """Projection pushdown into index / brute-force scans: when a
    Projection sits above a Filter/TopK/Limit chain ending in a scan
    operator, the scan fetches only the referenced base columns — the
    analog of the reference's `projection_pushdown=true` scan flag
    (`hnsw_index_scan.cpp:70-89, 170-185`)."""
    from vss_tpu_torch.query.ir import Limit

    if isinstance(node, Projection):
        needed = set()
        for e in node.exprs.values():
            needed |= _expr_cols(e)
        chain = []
        cur = node.child
        while isinstance(cur, (Filter, TopK, Limit)):
            if isinstance(cur, Filter):
                needed |= _expr_cols(cur.predicate)
            elif isinstance(cur, TopK):
                needed |= _expr_cols(cur.order)
                for e, _asc in cur.tail or ():
                    needed |= _expr_cols(e)
            chain.append(cur)
            cur = cur.child
        if (
            isinstance(cur, (HNSWIndexScan, BruteForceTopK))
            and cur.projection is None
        ):
            t = db.table(cur.table)
            proj = [c for c in t.column_names() if c in needed]
            leaf: PlanNode = dataclasses.replace(cur, projection=proj)
            for op in reversed(chain):
                leaf = dataclasses.replace(op, child=leaf)
            return Projection(leaf, node.exprs)
        return Projection(_pushdown_projections(db, node.child), node.exprs)
    # generic recursion over single-child wrappers
    for attr in ("child", "left"):
        if hasattr(node, attr):
            try:
                return dataclasses.replace(
                    node, **{attr: _pushdown_projections(db, getattr(node, attr))}
                )
            except TypeError:
                return node
    return node


def _optimize_node(db: Database, node: PlanNode) -> PlanNode:
    if isinstance(node, TopK):
        repl = _rewrite_topk(db, node)
        if repl is not None:
            return repl
        return dataclasses.replace(node, child=_optimize_node(db, node.child))
    if isinstance(node, MinByAgg):
        repl = _rewrite_minby(db, node)
        if repl is not None:
            return repl
        return dataclasses.replace(node, child=_optimize_node(db, node.child))
    if isinstance(node, KNNJoin):
        repl = _rewrite_knn_join(db, node)
        if repl is not None:
            return repl
        return dataclasses.replace(node, left=_optimize_node(db, node.left))
    from vss_tpu_torch.query.ir import Extend as _Extend
    from vss_tpu_torch.query.ir import LateralJoin as _LateralJoin

    if isinstance(node, _LateralJoin):
        repl = _rewrite_lateral(db, node)
        if repl is not None:
            return repl
        return dataclasses.replace(node, left=_optimize_node(db, node.left))
    if isinstance(node, _Extend):
        return _Extend(_optimize_node(db, node.child), node.exprs)
    if isinstance(node, Filter):
        return Filter(_optimize_node(db, node.child), node.predicate)
    if isinstance(node, Projection):
        return Projection(_optimize_node(db, node.child), node.exprs)
    if isinstance(node, HNSWIndexJoinNode):
        return HNSWIndexJoinNode(
            _optimize_node(db, node.left), node.table, node.index_name,
            node.left_vector, node.k,
        )
    from vss_tpu_torch.query.ir import Limit, SimpleAggregate

    if isinstance(node, Limit):
        return Limit(_optimize_node(db, node.child), node.k)
    if isinstance(node, SimpleAggregate):
        return SimpleAggregate(_optimize_node(db, node.child), node.items)
    from vss_tpu_torch.query.ir import GroupByAggregate

    if isinstance(node, GroupByAggregate):
        return GroupByAggregate(
            _optimize_node(db, node.child), node.keys, node.items
        )
    return node
