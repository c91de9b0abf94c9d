"""Logical plan IR + expression trees.

Reproduces `vss_tpu/query/ir.py` (numpy only).

A compact stand-in for the slice of DuckDB's logical algebra the reference
extension operates on: scans, filters, projections, top-N, the `min_by`
top-k aggregate, and the lateral k-NN join. The optimizer rules in
`vss_tpu_torch.query.rewrite` pattern-match these nodes exactly the way the
reference's `OptimizerExtension`s match DuckDB plans
(duckdb-vss `src/hnsw/hnsw_optimize_{expr,scan,topk,join}.cpp`).

Expressions evaluate with NumPy on host-resident column chunks; vector
math heavy enough to matter (distance + top-k) never goes through this
interpreter — the optimizers rewrite it onto the index / the exact
brute-force kernels first.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import numpy as np

from vss_tpu_torch.query.functions import resolve_function

__all__ = [
    "Expr", "ColumnRef", "Const", "Func", "BinOp", "Not", "Cast",
    "PlanNode", "Scan", "Filter", "Projection", "Extend", "TopK", "Limit",
    "MinByAgg", "KNNJoin", "HNSWIndexScan", "HNSWIndexJoinNode", "BruteForceTopK",
    "ChunkSource",
    "SimpleAggregate",
    "GroupByAggregate",
    "LateralJoin",
    "IndexedLateralJoin",
]


# --------------------------------------------------------------- expressions
class Expr:
    def evaluate(self, chunk: dict[str, np.ndarray]) -> np.ndarray:
        raise NotImplementedError

    def children(self) -> Sequence["Expr"]:
        return ()


@dataclasses.dataclass
class ColumnRef(Expr):
    name: str

    def evaluate(self, chunk):
        if self.name in chunk:
            return chunk[self.name]
        # qualified ref over a source that carries bare names (plain
        # scans): `t.col` resolves to `col` when the exact key is absent
        if "." in self.name:
            base = self.name.split(".")[-1]
            if base in chunk:
                return chunk[base]
        return chunk[self.name]  # KeyError with the original name

    def __str__(self):
        return self.name


@dataclasses.dataclass
class Const(Expr):
    value: Any

    def evaluate(self, chunk):
        n = len(next(iter(chunk.values()))) if chunk else 1
        v = np.asarray(self.value)
        if v.ndim >= 1:  # vector constant: broadcast over rows
            return np.broadcast_to(v, (n,) + v.shape)
        return np.full(n, v)

    def __str__(self):
        v = np.asarray(self.value)
        return f"[{v.size}-vec]" if v.ndim >= 1 else repr(self.value)


@dataclasses.dataclass
class Func(Expr):
    name: str
    args: list[Expr]
    # aggregate-only extensions: list(x ORDER BY k1, k2) carries its order
    # keys; agg(...) FILTER (WHERE p) carries the filter predicate
    orders: Optional[list[tuple["Expr", bool]]] = None
    filter: Optional["Expr"] = None

    def evaluate(self, chunk):
        f = resolve_function(self.name)
        vals = [a.evaluate(chunk) for a in self.args]
        if f.needs_chunk:
            return f.fn(chunk, *vals)
        return f.fn(*vals)

    def children(self):
        return self.args

    def __str__(self):
        return f"{self.name}({', '.join(map(str, self.args))})"


_BINOPS = {
    "+": np.add, "-": np.subtract, "*": np.multiply, "/": np.divide,
    # SQL modulo takes the dividend's sign (DuckDB's rule), as C's fmod
    "%": np.fmod,
    "<": np.less, "<=": np.less_equal, ">": np.greater, ">=": np.greater_equal,
    "=": np.equal, "==": np.equal, "!=": np.not_equal,
    "and": np.logical_and, "or": np.logical_or,
}


@dataclasses.dataclass
class BinOp(Expr):
    op: str
    left: Expr
    right: Expr

    def evaluate(self, chunk):
        out = _BINOPS[self.op](
            self.left.evaluate(chunk), self.right.evaluate(chunk)
        )
        # vector (in)equality: `vec = [1,2,3]` compares whole rows (the
        # reference's ARRAY equality), so reduce the per-component result
        if self.op in ("=", "==", "!=") and np.ndim(out) > 1:
            red = np.any if self.op == "!=" else np.all
            out = red(out, axis=tuple(range(1, np.ndim(out))))
        return out

    def children(self):
        return (self.left, self.right)

    def __str__(self):
        return f"({self.left} {self.op} {self.right})"


@dataclasses.dataclass
class Not(Expr):
    child: Expr

    def evaluate(self, chunk):
        return np.logical_not(self.child.evaluate(chunk))

    def children(self):
        return (self.child,)

    def __str__(self):
        return f"(not {self.child})"


@dataclasses.dataclass
class Cast(Expr):
    """`expr::TYPE[n]` — the reference tests cast array literals and
    expression arrays to FLOAT[n] (`test/sql/hnsw/hnsw_basic.test:22`).
    Numeric casts convert; FLOAT[n] asserts/coerces the row width."""

    child: Expr
    type_name: str  # upper-case SQL type
    dims: Optional[int] = None  # array size for TYPE[n]

    def evaluate(self, chunk):
        v = np.asarray(self.child.evaluate(chunk))
        if self.dims is not None:
            out = v.astype(np.float32)
            if out.ndim >= 1 and out.shape[-1] != self.dims:
                raise ValueError(
                    f"cannot cast array of size {out.shape[-1]} to "
                    f"{self.type_name}[{self.dims}]"
                )
            return out
        if self.type_name in ("FLOAT", "REAL"):
            return v.astype(np.float32)
        if self.type_name == "DOUBLE":
            return v.astype(np.float64)
        if self.type_name in ("INT", "INTEGER", "BIGINT", "SMALLINT"):
            return v.astype(np.int64)
        if self.type_name in ("VARCHAR", "TEXT", "STRING"):
            return v.astype(object)
        if self.type_name in ("BOOL", "BOOLEAN"):
            return v.astype(bool)
        raise ValueError(f"unsupported cast to {self.type_name}")

    def children(self):
        return (self.child,)

    def __str__(self):
        d = f"[{self.dims}]" if self.dims is not None else ""
        return f"({self.child}::{self.type_name}{d})"


# --------------------------------------------------------------- logical plan
class PlanNode:
    def children(self) -> Sequence["PlanNode"]:
        return ()

    def label(self) -> str:
        return type(self).__name__


@dataclasses.dataclass
class Scan(PlanNode):
    table: str

    def label(self):
        return f"SEQ_SCAN({self.table})"


@dataclasses.dataclass
class Filter(PlanNode):
    child: PlanNode
    predicate: Expr

    def children(self):
        return (self.child,)

    def label(self):
        return f"FILTER({self.predicate})"


@dataclasses.dataclass
class Projection(PlanNode):
    child: PlanNode
    exprs: dict[str, Expr]  # output name -> expression

    def children(self):
        return (self.child,)

    def label(self):
        # print `name=expr` when the expression differs from the output
        # name, so EXPLAIN shows optimizer expression rewrites (the
        # reference's hnsw_rewrite.test greps the plan for the rewritten
        # function name)
        parts = [
            k if str(v) == k else f"{k}={v}" for k, v in self.exprs.items()
        ]
        return f"PROJECTION({', '.join(parts)})"


@dataclasses.dataclass
class TopK(PlanNode):
    """ORDER BY <order> ASC/DESC [, tail...] LIMIT k."""

    child: PlanNode
    order: Expr
    k: int
    ascending: bool = True
    # secondary order keys; their presence blocks the index rewrite, like
    # the reference's single-order match (`hnsw_optimize_join.cpp:479`)
    tail: Optional[list[tuple[Expr, bool]]] = None

    def children(self):
        return (self.child,)

    def label(self):
        extra = "".join(
            f", {'ASC' if asc else 'DESC'} {e}" for e, asc in (self.tail or ())
        )
        return (
            f"TOP_N(k={self.k}, {'ASC' if self.ascending else 'DESC'} "
            f"{self.order}{extra})"
        )


@dataclasses.dataclass
class Limit(PlanNode):
    child: PlanNode
    k: int

    def children(self):
        return (self.child,)

    def label(self):
        return f"LIMIT({self.k})"


@dataclasses.dataclass
class MinByAgg(PlanNode):
    """SELECT min_by(value, order, k) [FILTER (WHERE p)] — the reference's
    TopK aggregate (`hnsw_optimize_topk.cpp:54-58`). Produces one row
    holding a list. `descending=True` is max_by. The FILTER predicate is
    preserved through the index rewrite, applied over the scanned rows —
    exactly the reference's behavior (`hnsw_optimize_topk.cpp:193`)."""

    child: PlanNode
    value: Expr
    order: Expr
    k: int
    output: str = "min_by"
    filter: Optional[Expr] = None
    descending: bool = False

    def children(self):
        return (self.child,)

    def label(self):
        name = "max_by" if self.descending else "min_by"
        f = f" FILTER({self.filter})" if self.filter is not None else ""
        return f"AGG({name}({self.value}, {self.order}, {self.k}){f})"


@dataclasses.dataclass
class KNNJoin(PlanNode):
    """For each left row, the k nearest right rows — the logical form of the
    reference's LATERAL (... ORDER BY dist LIMIT k) shape
    (`hnsw_optimize_join.cpp:352-433`)."""

    left: PlanNode
    right_table: str
    left_vector: Expr  # evaluated against left rows -> [n, d]
    right_column: str
    k: int
    metric_function: str = "array_distance"
    # set by the hybrid planner: serve the exact join from this index's
    # tape (storage-native batched scan) instead of the f32 table column
    via_index: Optional[str] = None

    def children(self):
        return (self.left,)

    def label(self):
        if self.via_index is not None:
            return (
                f"EXACT_SCAN_JOIN({self.right_table}.{self.right_column}, "
                f"index={self.via_index}, k={self.k}, "
                f"{self.metric_function})"
            )
        return (
            f"KNN_JOIN({self.right_table}.{self.right_column}, k={self.k}, "
            f"{self.metric_function})"
        )


@dataclasses.dataclass
class Extend(PlanNode):
    """Pass the child chunk through, adding computed columns (used to make
    SELECT aliases visible to GROUP BY / ORDER BY without dropping the
    underlying columns)."""

    child: PlanNode
    exprs: dict[str, Expr]

    def children(self):
        return (self.child,)

    def label(self):
        return f"EXTEND({', '.join(self.exprs)})"


@dataclasses.dataclass
class LateralJoin(PlanNode):
    """FROM <outer>, LATERAL (SELECT <items> FROM <inner> ORDER BY <keys>
    LIMIT k) — the reference's delim-join shape before optimization
    (duckdb-vss `src/hnsw/hnsw_optimize_join.cpp:352-433`).

    Per outer row: evaluate `sub_items` over all inner rows (outer columns
    are correlated into scope, aliases become available left-to-right),
    order by `order_keys` (NULLs last, like DuckDB's default null order),
    emit the first k. Output columns: outer columns then sub item columns,
    with `alias.col` qualified duplicates for disambiguation."""

    left: PlanNode  # outer source (Scan)
    left_table: str
    left_alias: str
    right_table: str
    right_alias: str
    sub_items: list[tuple[str, Expr]]  # (output name, expr) in select order
    order_keys: list[tuple[Expr, bool]]  # (expr, ascending)
    k: int
    where: Optional[Expr] = None  # subquery WHERE (inner scope)

    def children(self):
        return (self.left,)

    def label(self):
        keys = ", ".join(
            f"{e}{'' if asc else ' DESC'}" for e, asc in self.order_keys
        )
        return (
            f"LATERAL_TOPK_JOIN({self.right_table}, k={self.k}, "
            f"ORDER BY {keys})"
        )


@dataclasses.dataclass
class IndexedLateralJoin(PlanNode):
    """Index-accelerated lateral top-k join (the PhysicalHNSWIndexJoin
    analog, `hnsw_optimize_join.cpp:30-179`): one batched multi-query index
    search replaces the per-outer-row sort. Only substituted when the
    subquery's single order key is the index's distance function
    (`hnsw_optimize_join.cpp:473-498` — one ASC key required)."""

    left: PlanNode
    left_table: str
    left_alias: str
    table: str  # inner
    right_alias: str
    index_name: str
    outer_vector: Expr  # evaluated against the outer chunk -> [n, d]
    sub_items: list[tuple[str, Expr]]
    k: int

    def children(self):
        return (self.left,)

    def label(self):
        return f"HNSW_INDEX_JOIN({self.table}, {self.index_name}, k={self.k})"


# ------------------------------------------------------- physical-ish nodes
@dataclasses.dataclass
class HNSWIndexScan(PlanNode):
    """Index scan substituted by the optimizer (HNSW_INDEX_SCAN analog,
    `src/hnsw/hnsw_index_scan.cpp`).

    `pushed_filter` (set only under the hnsw_pushdown_filters setting) is
    evaluated into a row mask and searched with usearch-style
    `filtered_search` semantics — the index then returns k rows that all
    satisfy the predicate, instead of the reference's post-filter (which
    may yield fewer than k). The reference's scan explicitly does NOT
    support filter pushdown (`hnsw_index_scan.cpp:170-185`)."""

    table: str
    index_name: str
    query: np.ndarray
    k: int
    pushed_filter: Optional[Expr] = None
    # projection pushdown: fetch only these base columns (None = all),
    # mirroring hnsw_index_scan.cpp:70-89 / function flag :170-185
    projection: Optional[list[str]] = None

    def label(self):
        extra = f", filtered({self.pushed_filter})" if self.pushed_filter else ""
        if self.projection is not None:
            extra += f", cols=[{', '.join(self.projection)}]"
        return (
            f"HNSW_INDEX_SCAN({self.table}, {self.index_name}, k={self.k}{extra})"
        )


@dataclasses.dataclass
class HNSWIndexJoinNode(PlanNode):
    """Index-accelerated k-NN join (PhysicalHNSWIndexJoin analog)."""

    left: PlanNode
    table: str
    index_name: str
    left_vector: Expr
    k: int

    def children(self):
        return (self.left,)

    def label(self):
        return f"HNSW_INDEX_JOIN({self.table}, {self.index_name}, k={self.k})"


@dataclasses.dataclass
class SimpleAggregate(PlanNode):
    """Ungrouped aggregates: count(*)/count/sum/min/max/avg -> one row."""

    child: PlanNode
    items: dict[str, tuple[str, Optional[Expr]]]  # out -> (agg fn, arg)

    def children(self):
        return (self.child,)

    def label(self):
        parts = ", ".join(
            f"{fn}({arg if arg is not None else '*'})"
            for fn, arg in self.items.values()
        )
        return f"AGG({parts})"


@dataclasses.dataclass
class GroupByAggregate(PlanNode):
    """GROUP BY keys with count/sum/min/max/avg aggregates."""

    child: PlanNode
    keys: list[str]
    items: dict[str, tuple[str, Optional[Expr]]]  # out -> (agg fn, arg)

    def children(self):
        return (self.child,)

    def label(self):
        parts = ", ".join(
            f"{fn}({arg if arg is not None else '*'})"
            for fn, arg in self.items.values()
        )
        return f"GROUP_BY({', '.join(self.keys)}; {parts})"


@dataclasses.dataclass
class ChunkSource(PlanNode):
    """A materialized chunk used as a scan source (table-function results)."""

    name: str
    data: dict[str, np.ndarray]

    def label(self):
        return f"TABLE_FUNCTION({self.name})"


@dataclasses.dataclass
class BruteForceTopK(PlanNode):
    """Exact scan: the brute-force distance scan + top-k.

    Two physical forms share this node:
    - table-column scan (via_index=None): f32 device column, the
      fallback when no index exists,
    - index-tape scan (via_index set): the storage-native segmin scan
      over the index's int8/bf16 tape + exact f32 rerank
      (ops/scan.scan_topk) — the fastest operator at flagship scale,
      chosen by the hybrid planner (query/cost.py). `pushed_filter`
      (index form only) masks slots before top-k, so k applies to the
      FILTERED set — exact filtered search, unlike the graph path's
      post-hoc recheck."""

    table: str
    column: str
    query: np.ndarray
    k: int
    metric_function: str
    projection: Optional[list[str]] = None
    via_index: Optional[str] = None
    pushed_filter: Optional[Expr] = None

    def label(self):
        extra = (
            f", cols=[{', '.join(self.projection)}]"
            if self.projection is not None
            else ""
        )
        if self.via_index is not None:
            filt = (
                f", filter={self.pushed_filter}"
                if self.pushed_filter is not None
                else ""
            )
            return (
                f"EXACT_SCAN_TOPK({self.table}.{self.column}, "
                f"index={self.via_index}, k={self.k}, "
                f"{self.metric_function}{filt}{extra})"
            )
        return (
            f"BRUTE_FORCE_TOPK({self.table}.{self.column}, k={self.k}, "
            f"{self.metric_function}{extra})"
        )


def format_plan(node: PlanNode, indent: int = 0) -> str:
    lines = ["  " * indent + node.label()]
    for c in node.children():
        lines.append(format_plan(c, indent + 1))
    return "\n".join(lines)
