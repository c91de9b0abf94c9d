"""Batched select-neighbors heuristic.

Reproduces `vss_tpu/index/select.py:26-105`: keep a candidate iff it is
closer to the query than to every already-kept neighbor; fill the
remaining slots from the pruned list in distance order.

`select_neighbors` is the wrapper of the hand-written `select_neighbors`
kernel (`csrc/select.cu`): one launch for the whole batch on CUDA tensors,
with the candidate gather (K5's work) inside it and no host sync.
`_select_neighbors_plain` is its plain version, which CPU tensors run: one
[A, C, C] candidate-to-candidate distance tensor (a batched product)
followed by C steps of [A, C] mask logic, the candidate vectors through
kernel K5 (`ops/gather.gather_rows`).
"""
from __future__ import annotations

from typing import Optional

import torch

from vss_tpu_torch import csrc
from vss_tpu_torch.ops.distance import METRIC_IDS, Metric, _epilogue
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


_SELECT = csrc.register(csrc.Kernel(
    "select_neighbors", "select", "vss_select_neighbors",
    [csrc.PTR] * 6 + [csrc.I64] + [csrc.I32] * 8,
))

# csrc/select.cu's layouts: candidate rows and per-candidate arrays in
# shared memory; rows read from device memory; the arrays too, in a
# workspace the wrapper allocates. The kernel picks the first that fits
# unless one is forced.
_SHARED, _ROWS_GLOBAL, _ALL_GLOBAL = 0, 1, 2


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

    CUDA tensors: one launch of the `select_neighbors` kernel, no host
    sync. CPU tensors: `_select_neighbors_plain`.
    """
    if cand_i.device.type == "cpu":
        return _select_neighbors_plain(q_vecs, cand_i, cand_d, vectors, m, metric, active,
                                       cand_vecs)
    return _select_launch(cand_i, cand_d, vectors, m, metric, active, cand_vecs)


def _select_launch(cand_i, cand_d, vectors, m, metric, active=None, cand_vecs=None,
                   layout=None) -> torch.Tensor:
    """One launch of the `select_neighbors` kernel over the batch. `layout`
    forces one of csrc/select.cu's layouts (default: the kernel picks the
    first that fits); a forced layout whose shared memory does not fit is
    refused."""
    metric = Metric.parse(metric)
    A, C = cand_i.shape
    dev = cand_i.device
    rows = vectors if cand_vecs is None else cand_vecs
    if rows.dtype not in (torch.float32, torch.bfloat16, torch.int8):
        rows = rows.float()  # as the plain version's `.float()` of the gathered rows
    d = rows.shape[-1]
    if cand_d.shape != (A, C) or rows.dim() != (2 if cand_vecs is None else 3) \
            or (cand_vecs is not None and rows.shape[:2] != (A, C)) \
            or (active is not None and active.shape != (A,)):
        raise ValueError(
            f"select_neighbors: cand_i {tuple(cand_i.shape)}, cand_d {tuple(cand_d.shape)}, "
            f"{'cand_vecs' if cand_vecs is not None else 'vectors'} {tuple(rows.shape)}, "
            f"active {None if active is None else tuple(active.shape)} disagree")
    out = torch.empty((A, m), dtype=torch.int32, device=dev)
    if A == 0 or m == 0:
        return out.to(cand_i.dtype)
    ids = csrc.operand(cand_i.to(torch.int32))
    dist = csrc.operand(cand_d.float())
    rows = csrc.operand(rows)
    act = None if active is None else csrc.operand(active.to(torch.bool))
    layout = -1 if layout is None else layout
    ws_row = _SELECT.function("vss_select_workspace_bytes", csrc.I64, [csrc.I32] * 4)(
        max(C, m), d, rows.element_size(), layout)
    ws = torch.empty((A * ws_row,), dtype=torch.uint8, device=dev) if ws_row else None
    operands = [t for t in (ids, dist, rows, act, out, ws) if t is not None]
    _SELECT.launch(
        operands, ids.data_ptr(), dist.data_ptr(), rows.data_ptr(),
        None if act is None else act.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), ws_row,
        A, C, m, d, csrc.dtype_code(rows.dtype), METRIC_IDS[metric],
        int(cand_vecs is not None), layout,
    )
    return out.to(cand_i.dtype)


def _select_neighbors_plain(
    q_vecs: torch.Tensor,
    cand_i: torch.Tensor,
    cand_d: torch.Tensor,
    vectors: torch.Tensor,
    m: int,
    metric,
    active: Optional[torch.Tensor] = None,
    cand_vecs: Optional[torch.Tensor] = None,
    stats: Optional[list] = None,
) -> torch.Tensor:
    """Plain version of the `select_neighbors` kernel, with its contract:
    the candidate sort, the gather through K5, the [A, C, C] distances and
    the C-step keep loop on [A, C] masks. Given a list `stats`, appends to
    it (sorted cand_d [A, C], kept [A, C]), from which a caller counts the
    kernel's work."""
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

    if stats is not None:
        stats.append((cand_d, kept))
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
