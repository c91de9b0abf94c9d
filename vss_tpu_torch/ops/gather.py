"""Row gathers: the fused gather + distance of the beam search (K1) and
the whole-row gather of the write path (K5).

Reproduces `vss_tpu/ops/gather.py:39-128` (`_gather_kernel`,
`gather_rows_pallas`, `gather_rows`) and `:142-250, 341-370`
(`_gather_dist_kernel` and its wrapper `gather_distances_pallas`).
`gather_distances` is the K1 wrapper and `gather_rows` the K5 wrapper:
the hand-written CUDA kernels (`csrc/gather.cu`) for CUDA tensors,
`_gather_distances_plain` / `_gather_rows_plain` for CPU tensors. Tables
are taken in their own dtype at any width; the TPU's i32-word packing
(`pack_table`, `plane_queries`) and 128-lane width rule existed only for
Mosaic's DMA rules and are not ported.
"""
from __future__ import annotations

from typing import Optional

import torch

from vss_tpu_torch import csrc
from vss_tpu_torch.ops.distance import METRIC_IDS, Metric, _epilogue

__all__ = ["gather_distances", "gather_rows"]

_INF = float("inf")

_K1 = csrc.register(csrc.Kernel(
    "gather_distances", "gather", "vss_gather_distances",
    [csrc.PTR, csrc.PTR, csrc.PTR, csrc.PTR, csrc.PTR,
     csrc.I32, csrc.I32, csrc.I32, csrc.I32, csrc.I32],
))

_K5 = csrc.register(csrc.Kernel(
    "gather_rows", "gather", "vss_gather_rows",
    [csrc.PTR, csrc.PTR, csrc.PTR, csrc.I64, csrc.I64, csrc.I32],
))


def _gather_distances_plain(table, ids, q, metric: Metric, qn):
    """Plain version of K1: gather the rows, score them in f32."""
    rows = table[ids.clamp(min=0).long()].float()  # [B, C, d]
    dots = torch.einsum("bcd,bd->bc", rows, q)
    xn = (rows * rows).sum(-1)
    d = _epilogue(dots, qn[:, None], xn, metric)
    return torch.where(ids >= 0, d, _INF)


def gather_distances(
    table: torch.Tensor,
    ids: torch.Tensor,
    q: torch.Tensor,
    metric,
    q_norms_sq: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """distance(q[b], table[ids[b, c]]) -> [B, C] f32; +inf where ids < 0.

    table [N, d] int8 / bf16 / f32; ids [B, C] int; q [B, d] (cast to
    f32); q_norms_sq optional [B] squared query norms."""
    metric = Metric.parse(metric)
    q = q.float()
    if q_norms_sq is None:
        q_norms_sq = (q * q).sum(-1)
    qn = q_norms_sq.float()
    if table.device.type == "cpu":
        return _gather_distances_plain(table, ids, q, metric, qn)
    B, C = ids.shape
    d = table.shape[1]
    if q.shape != (B, d) or qn.shape != (B,):
        raise ValueError(f"gather_distances: ids {tuple(ids.shape)}, q {tuple(q.shape)}, "
                         f"q norms {tuple(qn.shape)} and table {tuple(table.shape)} disagree")
    # `.float()` and `.to(int32)` return their argument when it already
    # has the type, `operand` when it is contiguous and aligned: the
    # beam's callers pay no copy here
    table = csrc.operand(table)
    ids = csrc.operand(ids.to(torch.int32))
    q = csrc.operand(q)
    qn = csrc.operand(qn)
    out = torch.empty((B, C), dtype=torch.float32, device=table.device)
    if B and C:
        _K1.launch(
            (table, ids, q, qn), ids.data_ptr(), q.data_ptr(), qn.data_ptr(),
            table.data_ptr(), out.data_ptr(), B, C, d,
            csrc.dtype_code(table.dtype), METRIC_IDS[metric],
        )
    return out


def _gather_rows_plain(table, ids, skip_neg: bool = False):
    """Plain version of K5: index the clamped ids; zeros where skipped."""
    out = table[ids.clamp(min=0).long()]
    if skip_neg:
        out = torch.where((ids >= 0)[..., None], out, torch.zeros((), dtype=table.dtype))
    return out


def gather_rows(table: torch.Tensor, ids: torch.Tensor, skip_neg: bool = False) -> torch.Tensor:
    """table[max(ids, 0)] -> ids.shape + (row,), in the table's dtype.

    table [N, row] of any dtype (vector rows, adjacency rows); ids of any
    shape, integer. Negative ids are clamped to row 0 and masked by the
    caller; with skip_neg they read nothing and give a row of zeros."""
    if table.dim() != 2:
        raise ValueError(f"gather_rows: table must be [N, row], got {tuple(table.shape)}")
    if table.device.type == "cpu":
        return _gather_rows_plain(table, ids, skip_neg)
    row = table.shape[1]
    if not table.is_contiguous():
        table = table.contiguous()
    if ids.dtype != torch.int32 or not ids.is_contiguous():
        ids = ids.to(torch.int32).contiguous()
    n = ids.numel()
    out = torch.empty(tuple(ids.shape) + (row,), dtype=table.dtype, device=table.device)
    if n and row:
        if table.shape[0] == 0:
            raise ValueError("gather_rows: ids given for an empty table")
        _K5.launch(
            (table, ids), ids.data_ptr(), table.data_ptr(), out.data_ptr(),
            n, row * table.element_size(), int(skip_neg),
        )
    return out
