"""Query layer: tables, plan IR, optimizer rewrites, execution, macros.

Reproduces `vss_tpu/query/__init__.py`.
"""
from vss_tpu_torch.query.api import Query, col, const, fn
from vss_tpu_torch.query.ir import (
    BinOp,
    ColumnRef,
    Const,
    Filter,
    Func,
    KNNJoin,
    Limit,
    MinByAgg,
    Not,
    Projection,
    Scan,
    TopK,
    format_plan,
)
from vss_tpu_torch.query.macros import vss_join, vss_match
from vss_tpu_torch.query.table import BinderError, Database, Table

__all__ = [
    "Database",
    "Table",
    "BinderError",
    "Query",
    "col",
    "const",
    "fn",
    "vss_join",
    "vss_match",
    "format_plan",
    "ColumnRef",
    "Const",
    "Func",
    "BinOp",
    "Not",
    "Scan",
    "Filter",
    "Projection",
    "TopK",
    "Limit",
    "MinByAgg",
    "KNNJoin",
]
