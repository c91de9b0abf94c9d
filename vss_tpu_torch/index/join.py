"""Index-to-index matching.

Reproduces `vss_tpu/index/join.py:19-59`: a truncated Gale-Shapley over
batched candidate lists. "Men" are the rows of index `a`, each proposing
to its nearest rows of `b` in order; "women" are the rows of `b`, holding
their best proposal so far. All proposal distances come from one batched
search of `b`; the matching itself runs on the host.
"""
from __future__ import annotations

import numpy as np
import torch

from vss_tpu_torch.index.dense import HNSWIndex
from vss_tpu_torch.ops.gather import gather_rows

__all__ = ["join_indexes"]


def join_indexes(
    a: HNSWIndex, b: HNSWIndex, proposals: int = 8, ef: int = 0
) -> dict[int, int]:
    """Match rows of `a` to rows of `b` one-to-one.

    Returns {a_rowid: b_rowid}. Rows whose `proposals` nearest candidates
    are all taken by closer proposers stay unmatched.
    """
    if a.config.dims != b.config.dims:
        raise ValueError("joined indexes must share dimensionality")
    if a.count == 0 or b.count == 0:
        return {}
    a_rows = np.asarray(sorted(a.rowid_to_slot), np.int64)
    a_vec_slots = np.asarray([a.rowid_to_slot[int(r)] for r in a_rows], np.int32)
    vecs = gather_rows(a.graph.vectors, torch.from_numpy(a_vec_slots).to(a.device)).float()
    ef = ef or max(b.config.ef_search, proposals)
    d, cand = b.search(vecs, k=proposals, ef=ef)
    d = d.cpu().numpy()
    cand = cand.cpu().numpy()

    # Gale-Shapley: iterate proposals in global distance order so each
    # woman keeps her closest proposer (equivalent to round-based GS here).
    order = np.argsort(d, axis=None, kind="stable")
    engaged_b: dict[int, tuple[float, int]] = {}  # b_row -> (dist, a_row)
    engaged_a: dict[int, int] = {}
    nA, P = d.shape
    for flat in order:
        i, j = divmod(int(flat), P)
        b_row = int(cand[i, j])
        if b_row < 0 or not np.isfinite(d[i, j]):
            continue
        a_row = int(a_rows[i])
        if a_row in engaged_a:
            continue
        cur = engaged_b.get(b_row)
        if cur is None:
            engaged_b[b_row] = (float(d[i, j]), a_row)
            engaged_a[a_row] = b_row
        # else: b_row already has a closer proposer (global order): skip
    return engaged_a
