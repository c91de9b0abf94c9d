"""Fused gather + distance: the beam search's hot step.

Reproduces `vss_tpu/ops/gather.py:142-250, 341-370`
(`_gather_dist_kernel` and its wrapper `gather_distances_pallas`).
`gather_distances` is the K1 wrapper: the hand-written CUDA kernel
(`csrc/gather.cu`) for CUDA tensors, `_gather_distances_plain` for CPU
tensors. The table is taken in its own dtype (int8 / bf16 / f32, any
width); the TPU's i32-word packing (`pack_table`, `plane_queries`)
existed only for Mosaic's DMA rules and is not ported.
"""
from __future__ import annotations

from typing import Optional

import torch

from vss_tpu_torch import csrc
from vss_tpu_torch.ops.distance import METRIC_IDS, Metric, _epilogue

__all__ = ["gather_distances"]

_INF = float("inf")

_K1 = csrc.register(csrc.Kernel(
    "gather_distances", "gather", "vss_gather_distances",
    [csrc.PTR, csrc.PTR, csrc.PTR, csrc.PTR, csrc.PTR,
     csrc.I32, csrc.I32, csrc.I32, csrc.I32, csrc.I32],
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
    table = csrc.operand(table)
    ids = csrc.operand(ids.to(torch.int32))
    q = csrc.operand(q)
    qn = csrc.operand(qn)
    out = torch.empty((B, C), dtype=torch.float32, device=table.device)
    if B and C:
        _K1.launch(
            (table, ids, q, qn, out), ids.data_ptr(), q.data_ptr(), qn.data_ptr(),
            table.data_ptr(), out.data_ptr(), B, C, d,
            csrc.dtype_code(table.dtype), METRIC_IDS[metric],
        )
    return out
