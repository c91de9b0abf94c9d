"""SQL-surface scalar functions over ARRAY(FLOAT, N) columns.

Reproduces `vss_tpu/query/functions.py` (numpy only).

The function set the reference's optimizers match on
(duckdb-vss `src/hnsw/hnsw_index.cpp:659-689`): `array_distance`
(euclidean), `array_cosine_similarity` / `array_cosine_distance`,
`array_inner_product` / `array_negative_inner_product`, plus the operator
aliases `<->` (l2), `<=>` (cosine distance), `<#>` (negative inner
product). Index-internal ordering uses l2sq/cos/1-ip (see
vss_tpu_torch.ops.distance); the user-visible values computed here are the SQL
semantics — e.g. `array_distance` takes the square root — and, exactly
like the reference, final output distances are recomputed by projections,
never read out of the index.

Each entry maps to the index metric that accelerates it (or None).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from vss_tpu_torch.ops.distance import Metric

__all__ = ["DISTANCE_FUNCTIONS", "FunctionDef", "resolve_function"]


def _pairwise_rows(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Row-wise helper: a [n, d] vs b [n, d] or broadcast [d]."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    if b.ndim == 1:
        b = np.broadcast_to(b, a.shape)
    return a, b


def array_distance(a, b):
    a, b = _pairwise_rows(a, b)
    diff = a.astype(np.float64) - b.astype(np.float64)
    return np.sqrt((diff * diff).sum(-1)).astype(np.float32)


def array_distance_squared(a, b):
    a, b = _pairwise_rows(a, b)
    diff = a.astype(np.float64) - b.astype(np.float64)
    return (diff * diff).sum(-1).astype(np.float32)


def array_inner_product(a, b):
    a, b = _pairwise_rows(a, b)
    return (a.astype(np.float64) * b.astype(np.float64)).sum(-1).astype(np.float32)


def array_negative_inner_product(a, b):
    return -array_inner_product(a, b)


def array_cosine_similarity(a, b):
    a, b = _pairwise_rows(a, b)
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    dots = (a64 * b64).sum(-1)
    na = np.sqrt((a64 * a64).sum(-1))
    nb = np.sqrt((b64 * b64).sum(-1))
    denom = na * nb
    with np.errstate(invalid="ignore", divide="ignore"):
        cos = np.where(denom > 0, dots / np.where(denom > 0, denom, 1.0), 0.0)
    return cos.astype(np.float32)


def array_cosine_distance(a, b):
    return (1.0 - array_cosine_similarity(a, b)).astype(np.float32)


class FunctionDef:
    def __init__(
        self,
        name: str,
        fn: Callable,
        index_metric: Optional[Metric],
        ascending_means_nearest: bool = True,
        needs_chunk: bool = False,
    ):
        self.name = name
        self.fn = fn
        # which index metric gives the same ordering as ORDER BY fn(...) ASC
        self.index_metric = index_metric
        self.ascending_means_nearest = ascending_means_nearest
        # chunk-context functions (random / row_number / setseed) receive
        # the column chunk as their first argument to learn the row count
        self.needs_chunk = needs_chunk


DISTANCE_FUNCTIONS: dict[str, FunctionDef] = {
    f.name: f
    for f in [
        FunctionDef("array_distance", array_distance, Metric.L2SQ),
        FunctionDef("array_distance_squared", array_distance_squared, Metric.L2SQ),
        FunctionDef("array_cosine_distance", array_cosine_distance, Metric.COSINE),
        FunctionDef("array_cosine_similarity", array_cosine_similarity, None),
        FunctionDef(
            "array_negative_inner_product", array_negative_inner_product, Metric.IP
        ),
        FunctionDef("array_inner_product", array_inner_product, None),
    ]
}

# ------------------------------------------------------- general functions
# The non-distance scalar surface the reference's SQLLogic tests use
# (`test/sql/hnsw/*.test`): array construction, list helpers, RNG, and the
# bare row_number() window. These come from DuckDB core in the reference;
# here they are part of the SQL layer so the tests run mechanically.

_rng_state = {"rng": np.random.default_rng(0)}


def _chunk_len(chunk) -> int:
    return len(np.asarray(next(iter(chunk.values())))) if chunk else 1


def array_value(*cols):
    return np.stack(
        [np.asarray(c, np.float32) for c in cols], axis=-1
    )


def _per_row(x, f):
    x = np.asarray(x)
    out = np.empty(len(x), object)
    out[:] = [f(r) for r in x]
    return out


def list_sum(x):
    return np.asarray(
        [float(np.sum(np.asarray(r, np.float64))) if r is not None else np.nan
         for r in np.asarray(x, object)],
        np.float64,
    )


def flatten(x):
    return _per_row(
        np.asarray(x, object),
        lambda r: np.asarray(r, np.float64).ravel().tolist(),
    )


def sql_len(x):
    return np.asarray([len(r) for r in np.asarray(x, object)], np.int64)


def sql_random(chunk):
    return _rng_state["rng"].random(_chunk_len(chunk))


def sql_setseed(chunk, seed):
    s = float(np.asarray(seed).ravel()[0])
    _rng_state["rng"] = np.random.default_rng(
        np.int64(abs(s) * (1 << 31)) or 0
    )
    return np.full(_chunk_len(chunk), None, object)


def sql_row_number(chunk):
    return np.arange(1, _chunk_len(chunk) + 1, dtype=np.int64)


GENERAL_FUNCTIONS: dict[str, FunctionDef] = {
    f.name: f
    for f in [
        FunctionDef("array_value", array_value, None),
        FunctionDef("array_pack", array_value, None),  # expr array literals
        FunctionDef("list_sum", list_sum, None),
        FunctionDef("flatten", flatten, None),
        FunctionDef("len", sql_len, None),
        FunctionDef("random", sql_random, None, needs_chunk=True),
        FunctionDef("setseed", sql_setseed, None, needs_chunk=True),
        FunctionDef("row_number", sql_row_number, None, needs_chunk=True),
    ]
}

# operator aliases, as in the reference matcher (hnsw_index.cpp:671-680)
_ALIASES = {
    "<->": "array_distance",
    "<=>": "array_cosine_distance",
    "<#>": "array_negative_inner_product",
}


def resolve_function(name: str) -> FunctionDef:
    name = _ALIASES.get(name, name)
    if name in DISTANCE_FUNCTIONS:
        return DISTANCE_FUNCTIONS[name]
    if name in GENERAL_FUNCTIONS:
        return GENERAL_FUNCTIONS[name]
    raise ValueError(f"unknown function '{name}'")
