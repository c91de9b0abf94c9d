"""Batched select-neighbors heuristic.

Reproduces `vss_tpu/index/select.py:26-105`: keep a candidate iff it is
closer to the query than to every already-kept neighbor; fill the
remaining slots from the pruned list in distance order. It runs for A
rows at once on fixed-size tensors: one [A, C, C] candidate-to-candidate
distance tensor (a batched product) followed by C steps of [A, C] mask
logic. The candidate vectors come through kernel K5
(`ops/gather.gather_rows`).
"""
from __future__ import annotations

from typing import Optional

import torch

from vss_tpu_torch.ops.distance import Metric, _epilogue
from vss_tpu_torch.ops.gather import gather_rows
from vss_tpu_torch.ops.topk import _sort_min_k

__all__ = ["select_neighbors", "pairwise_rowwise"]

_INF = float("inf")
_BIG = 1e30


def pairwise_rowwise(vecs: torch.Tensor, metric) -> torch.Tensor:
    """Per-row pairwise distances: [A, C, d] -> [A, C, C]."""
    metric = Metric.parse(metric)
    vecs = vecs.float()
    dots = torch.einsum("acd,aed->ace", vecs, vecs)
    n = (vecs * vecs).sum(-1)
    return _epilogue(dots, n[:, :, None], n[:, None, :], metric)


def select_neighbors(
    q_vecs: torch.Tensor,
    cand_i: torch.Tensor,
    cand_d: torch.Tensor,
    vectors: torch.Tensor,
    m: int,
    metric,
    active: Optional[torch.Tensor] = None,
    cand_vecs: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Pick up to `m` diverse neighbors per row from candidate lists.

    q_vecs: [A, d] the node being connected; cand_i/cand_d: [A, C]
    candidate slots (-1 = none, must be pre-deduplicated) and distances to
    q; vectors: [cap, d] slot tape. Returns chosen [A, m] i32, -1 padded,
    ordered kept-first then fill, each group ascending by distance.
    Rows with active=False return all -1. `cand_vecs` [A, C, d] skips the
    internal gather when the caller already holds the candidate vectors.
    """
    metric = Metric.parse(metric)
    A, C = cand_i.shape
    dev = cand_i.device
    if C < m:
        pad = m - C
        cand_i = torch.cat([cand_i, cand_i.new_full((A, pad), -1)], 1)
        cand_d = torch.cat([cand_d, cand_d.new_full((A, pad), _INF)], 1)
        if cand_vecs is not None:
            cand_vecs = torch.cat(
                [cand_vecs, cand_vecs.new_zeros((A, pad, cand_vecs.shape[2]))], 1)
        C = m
    cand_d = torch.where(cand_i >= 0, cand_d, _INF)
    # sort candidates ascending by distance (stable, as lax.sort_key_val)
    cand_d, order = torch.sort(cand_d, dim=1, stable=True)
    cand_i = cand_i.gather(1, order)

    if cand_vecs is None:
        cand_vecs = gather_rows(vectors, cand_i)  # [A, C, d]
    else:
        cand_vecs = cand_vecs.gather(
            1, order[:, :, None].expand(-1, -1, cand_vecs.shape[2]))
    d_cc = pairwise_rowwise(cand_vecs, metric)  # [A, C, C]

    kept = torch.zeros((A, C), dtype=torch.bool, device=dev)
    cnt = torch.zeros((A,), dtype=torch.int32, device=dev)
    for c in range(C):
        # min distance from candidate c to any kept candidate
        d_to_kept = torch.where(kept, d_cc[:, c, :], _INF).amin(1)
        dc = cand_d[:, c]
        ok = torch.isfinite(dc) & (dc < d_to_kept) & (cnt < m)
        kept[:, c] = ok
        cnt = cnt + ok.to(torch.int32)

    # kept first (ascending d), then pruned fill (ascending d), invalid
    # last. In f32 every pruned key is exactly _BIG, so the fill's order
    # is the tie rule's: the lower position of the sorted list first, as
    # lax.top_k gives it; a stable sort does the same.
    key = torch.where(kept, cand_d, torch.where(torch.isfinite(cand_d), cand_d + _BIG, _INF))
    top, pos = _sort_min_k(key, m)
    chosen = cand_i.gather(1, pos.long())
    chosen = torch.where(torch.isfinite(top), chosen, -1)
    if active is not None:
        chosen = torch.where(active[:, None], chosen, -1)
    return chosen
