"""Fluent query-builder API over the plan IR.

Reproduces `vss_tpu/query/api.py`.

The ergonomic surface for Python users (the SQL front end in
`vss_tpu_torch.query.sql` lowers to the same IR):

    q = (db.query("items")
           .order_by(Func("array_distance", ColumnRef("vec"), Const(v)))
           .limit(3)
           .select("id", dist=Func("array_distance", ColumnRef("vec"), Const(v))))
    q.execute()   # -> dict of columns
    q.explain()   # -> physical plan text (shows HNSW_INDEX_SCAN when rewritten)
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np

from vss_tpu_torch.query.ir import (
    ColumnRef,
    Const,
    Expr,
    Filter,
    Func,
    KNNJoin,
    Limit,
    MinByAgg,
    PlanNode,
    Projection,
    Scan,
    TopK,
)
from vss_tpu_torch.query.table import Database

__all__ = ["Query", "col", "const", "fn"]


def col(name: str) -> ColumnRef:
    return ColumnRef(name)


def const(value) -> Const:
    return Const(value)


def fn(name: str, *args: Expr) -> Func:
    return Func(name, list(args))


class Query:
    def __init__(self, db: Database, table: str):
        self.db = db
        self._table = table
        self._filters: list[Expr] = []
        self._order: Optional[Expr] = None
        self._ascending = True
        self._limit: Optional[int] = None
        self._select: Optional[dict[str, Expr]] = None
        self._minby: Optional[tuple[Expr, Expr, int]] = None
        self._join: Optional[tuple[str, str, Expr, int, str]] = None

    # ------------------------------------------------------------ builders
    def filter(self, pred: Expr) -> "Query":
        self._filters.append(pred)
        return self

    def order_by(self, e: Expr, ascending: bool = True) -> "Query":
        self._order = e
        self._ascending = ascending
        return self

    def limit(self, k: int) -> "Query":
        self._limit = int(k)
        return self

    def select(self, *names: str, **exprs: Expr) -> "Query":
        sel: dict[str, Expr] = {n: ColumnRef(n) for n in names}
        sel.update(exprs)
        self._select = sel
        return self

    def min_by(self, value: Expr, order: Expr, k: int) -> "Query":
        """SELECT min_by(value, order, k) — k smallest by `order`."""
        self._minby = (value, order, int(k))
        return self

    def knn_join(
        self,
        right_table: str,
        right_column: str,
        left_vector: Union[Expr, np.ndarray],
        k: int,
        metric_function: str = "array_distance",
    ) -> "Query":
        """For each row, join the k nearest rows of `right_table` (the
        LATERAL ... ORDER BY dist LIMIT k shape)."""
        if not isinstance(left_vector, Expr):
            left_vector = Const(np.asarray(left_vector, np.float32))
        self._join = (right_table, right_column, left_vector, int(k), metric_function)
        return self

    # ------------------------------------------------------------ plan
    def plan(self) -> PlanNode:
        node: PlanNode = Scan(self._table)
        for f in self._filters:
            node = Filter(node, f)
        if self._minby is not None:
            value, order, k = self._minby
            return MinByAgg(node, value, order, k)
        if self._join is not None:
            rt, rc, lv, k, mf = self._join
            node = KNNJoin(node, rt, lv, rc, k, mf)
            if self._select is not None:
                node = Projection(node, self._select)
            return node
        if self._order is not None and self._limit is not None:
            node = TopK(node, self._order, self._limit, self._ascending)
        elif self._limit is not None:
            node = Limit(node, self._limit)
        if self._select is not None:
            node = Projection(node, self._select)
        return node

    # ------------------------------------------------------------ run
    def execute(self) -> dict[str, np.ndarray]:
        return self.db.execute(self.plan())

    def execute_unoptimized(self) -> dict[str, np.ndarray]:
        return self.db.execute_unoptimized(self.plan())

    def explain(self) -> str:
        return self.db.explain(self.plan())


def _query(self: Database, table: str) -> Query:
    return Query(self, table)


# attach as a Database method
Database.query = _query  # type: ignore[attr-defined]
