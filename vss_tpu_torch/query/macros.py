"""vss_join / vss_match: brute-force matching helpers.

Functional equivalents of the reference's SQL table macros
(duckdb-vss `src/hnsw/hnsw_index_macros.cpp:9-74`): index-independent
exact k-NN matching between two tables, but executed by `bruteforce_topk`
on the database's device (K3, or K4 past k=64) instead of a min_by
scalar aggregate.

Score semantics follow the reference exactly: l2sq scores with
`array_distance` (euclidean, ascending / min_by); cosine scores with
`array_cosine_similarity` and ip with `array_inner_product` (descending /
max_by, `hnsw_index_macros.cpp:24-25,55-56`). The selected row set is
identical either way — top-k by cosine distance ascending IS top-k by
similarity descending — only the reported score and its ordering flip.

Reproduces `vss_tpu/query/macros.py`; results come back to the host
through `table.host`.
"""
from __future__ import annotations

import numpy as np
import torch

from vss_tpu_torch.ops.distance import Metric
from vss_tpu_torch.ops.topk import bruteforce_topk
from vss_tpu_torch.query.table import BinderError, Database, host

__all__ = ["vss_join", "vss_match", "vss_match_lateral"]


def _metric_of(metric: str) -> Metric:
    try:
        return Metric.parse(metric)
    except ValueError as e:
        raise BinderError(str(e)) from e


def _user_score(d: np.ndarray, metric: Metric) -> np.ndarray:
    """Map index-internal ascending distances to the macro's user-facing
    score column: euclidean for l2sq (min_by), similarity for cosine,
    inner product for ip (both max_by)."""
    if metric == Metric.L2SQ:
        return np.sqrt(np.maximum(d, 0.0))
    # internal cosine distance = 1 - cos; internal ip = 1 - dot
    return 1.0 - d


def vss_join(
    db: Database,
    left_table: str,
    right_table: str,
    left_col: str,
    right_col: str,
    k: int,
    metric: str = "l2sq",
) -> dict[str, np.ndarray]:
    """For every left row, its k exact nearest right rows.

    Returns columns prefixed left_/right_ plus 'score' (the metric's
    distance, ascending per left row)."""
    m = _metric_of(metric)
    lt, rt = db.table(left_table), db.table(right_table)
    lq = lt.chunk()
    queries = np.asarray(lq[left_col], np.float32)
    if queries.ndim != 2:
        raise BinderError(f"'{left_col}' is not a vector column")
    rvecs, rvalid = rt.device_column(right_col)
    nL = queries.shape[0]
    if nL == 0 or rt.num_rows == 0:
        out = {f"left_{c}": v[:0] for c, v in lq.items()}
        out.update({f"right_{c}": v[:0] for c, v in rt.chunk().items()})
        out["score"] = np.zeros(0, np.float32)
        return out
    d, slots = bruteforce_topk(torch.from_numpy(queries), rvecs, k, m,
                               valid_mask=rvalid, device=rvecs.device)
    d, slots = host(d), host(slots)
    valid = slots >= 0
    counts = valid.sum(1)
    left_sel = np.repeat(np.arange(nL), counts)
    flat_slots = slots[valid]
    out = {f"left_{c}": v[left_sel] for c, v in lq.items()}
    inner = rt.chunk(flat_slots)
    for c, v in inner.items():
        out[f"right_{c}"] = v
    out["score"] = _user_score(d[valid], m).astype(np.float32)
    return out


def vss_match(
    db: Database,
    right_table: str,
    left_vector: np.ndarray,
    right_col: str,
    k: int,
    metric: str = "l2sq",
) -> dict[str, np.ndarray]:
    """k exact nearest rows of `right_table` to one query vector."""
    m = _metric_of(metric)
    rt = db.table(right_table)
    q = np.asarray(left_vector, np.float32)
    if q.ndim != 1:
        raise BinderError("vss_match expects a single query vector")
    rvecs, rvalid = rt.device_column(right_col)
    d, slots = bruteforce_topk(torch.from_numpy(q[None]), rvecs, k, m,
                               valid_mask=rvalid, device=rvecs.device)
    d, slots = host(d)[0], host(slots)[0]
    keep = slots >= 0
    out = rt.chunk(slots[keep])
    out["score"] = _user_score(d[keep], m).astype(np.float32)
    return out


def vss_match_lateral(
    db: Database,
    left_table: str,
    right_table: str,
    left_col: str,
    right_col: str,
    k: int,
    metric: str = "l2sq",
) -> dict[str, np.ndarray]:
    """Correlated `FROM lt, vss_match(rt, left_col, right_col, k)`: one
    output row per left row carrying a `matches` list of
    {'score', 'row'} structs — the reference macro's min_by/max_by shape
    (`hnsw_index_macros.cpp:48-74`), evaluated as one batched exact scan."""
    m = _metric_of(metric)
    lt, rt = db.table(left_table), db.table(right_table)
    lq = lt.chunk()
    queries = np.asarray(lq[left_col], np.float32)
    if queries.ndim != 2:
        raise BinderError(f"'{left_col}' is not a vector column")
    nL = queries.shape[0]
    out = {c: v for c, v in lq.items() if c != "__rowid__"}
    if nL == 0 or rt.num_rows == 0:
        out["matches"] = np.empty(nL, object)
        out["matches"][:] = [[] for _ in range(nL)]
        return out
    rvecs, rvalid = rt.device_column(right_col)
    d, slots = bruteforce_topk(torch.from_numpy(queries), rvecs, k, m,
                               valid_mask=rvalid, device=rvecs.device)
    d, slots = host(d), host(slots)
    scores = _user_score(np.maximum(d, 0.0), m)
    rchunk = rt.chunk()
    matches = []
    for i in range(nL):
        row_matches = []
        for j in range(slots.shape[1]):
            s = slots[i, j]
            if s < 0:
                continue
            row = {c: v[s] for c, v in rchunk.items() if c != "__rowid__"}
            row_matches.append({"score": float(scores[i, j]), "row": row})
        matches.append(row_matches)
    arr = np.empty(nL, object)
    arr[:] = matches
    out["matches"] = arr
    return out
