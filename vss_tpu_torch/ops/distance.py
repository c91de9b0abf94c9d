"""Batched distances: l2sq / cosine / inner product.

Reproduces `vss_tpu/ops/distance.py`:

    l2sq(Q, X)   = |q|^2 + |x|^2 - 2 Q X^T          (clamped at 0)
    cosine(Q, X) = 1 - (Q X^T) / (|q| |x|)          (zero-vector guarded)
    ip(Q, X)     = 1 - Q X^T

Two implementations behind one API:
  * `pairwise` - plain PyTorch, the reference implementation and the
    plain version of kernel K4;
  * `dispatch_pairwise` - the K4 wrapper: the hand-written tiled CUDA
    kernel (`csrc/distance.cu`, replacing the TPU's `_pairwise_kernel`)
    for CUDA tensors, `pairwise` for CPU tensors.

The exact paths need true f32 products; the package turns TF32 off
(`vss_tpu_torch/__init__.py`).
"""
from __future__ import annotations

import enum
from typing import Optional

import torch

from vss_tpu_torch import csrc
from vss_tpu_torch.utils import pad_to

__all__ = [
    "Metric", "pairwise", "dispatch_pairwise", "distance_one",
    "gathered_distances",
]

class Metric(enum.Enum):
    """Index-internal distance kinds."""

    L2SQ = "l2sq"
    COSINE = "cosine"
    IP = "ip"

    @classmethod
    def parse(cls, name) -> "Metric":
        if isinstance(name, Metric):
            return name
        key = str(name).lower()
        aliases = {
            "l2sq": cls.L2SQ,
            "l2": cls.L2SQ,
            "euclidean": cls.L2SQ,
            "cosine": cls.COSINE,
            "cos": cls.COSINE,
            "ip": cls.IP,
            "innerproduct": cls.IP,
            "inner_product": cls.IP,
        }
        if key not in aliases:
            raise ValueError(
                f"Unknown metric '{name}'; expected one of l2sq, cosine, ip"
            )
        return aliases[key]


# the kernels' metric codes (common.cuh `Metric`, hnsw_builder.cpp)
METRIC_IDS = {Metric.L2SQ: 0, Metric.COSINE: 1, Metric.IP: 2}


def _epilogue(dots, qn, xn, metric: Metric):
    """Shared distance epilogue; qn and xn broadcast against dots."""
    if metric == Metric.L2SQ:
        # clamp guards tiny negative values from cancellation (NaN stays)
        return torch.clamp(qn + xn - 2.0 * dots, min=0.0)
    if metric == Metric.COSINE:
        denom = torch.sqrt(qn * xn)
        pos = denom > 0.0
        cos = torch.where(pos, dots / torch.where(pos, denom, 1.0), 0.0)
        # both zero vectors -> distance 0; one zero vector -> 1
        both_zero = (qn == 0.0) & (xn == 0.0)
        return torch.where(both_zero, 0.0, 1.0 - cos)
    if metric == Metric.IP:
        return 1.0 - dots
    raise ValueError(metric)


def pairwise(q: torch.Tensor, x: torch.Tensor, metric) -> torch.Tensor:
    """[nq, d] x [nx, d] -> [nq, nx] f32 distances, plain PyTorch.

    Exact f32 products: the l2sq form |q|^2+|x|^2-2qx cancels
    catastrophically, and reduced precision reorders near-tied
    neighbors."""
    metric = Metric.parse(metric)
    q = q.float()
    x = x.float()
    dots = q @ x.T
    qn = (q * q).sum(-1, keepdim=True)
    xn = (x * x).sum(-1, keepdim=True).T
    return _epilogue(dots, qn, xn, metric)


_K4 = csrc.register(csrc.Kernel(
    "pairwise", "distance", "vss_pairwise",
    [csrc.PTR, csrc.PTR, csrc.PTR, csrc.I32, csrc.I64, csrc.I32, csrc.I32],
))


def dispatch_pairwise(q: torch.Tensor, x: torch.Tensor, metric) -> torch.Tensor:
    """Pairwise distances through kernel K4 on CUDA tensors (`pairwise`
    on CPU tensors). Columns are zero-padded to the tile loop's 16-column
    step, which changes neither dots nor norms."""
    metric = Metric.parse(metric)
    if q.device.type == "cpu":
        return pairwise(q, x, metric)
    if q.shape[1] != x.shape[1]:
        raise ValueError(f"dispatch_pairwise: q {tuple(q.shape)} and x {tuple(x.shape)} disagree")
    q = csrc.operand(pad_to(q.float(), 1, 16))
    x = csrc.operand(pad_to(x.float(), 1, 16))
    nq, d = q.shape
    nx = x.shape[0]
    out = torch.empty((nq, nx), dtype=torch.float32, device=q.device)
    if nq and nx:
        _K4.launch((q, x, out), q.data_ptr(), x.data_ptr(), out.data_ptr(),
                   nq, nx, d, METRIC_IDS[metric])
    return out


def distance_one(a: torch.Tensor, b: torch.Tensor, metric) -> torch.Tensor:
    """Distance between two single vectors (host/debug convenience)."""
    return pairwise(a[None, :], b[None, :], metric)[0, 0]


def gathered_distances(
    q: torch.Tensor,
    cand_vecs: torch.Tensor,
    metric,
    cand_norms_sq: Optional[torch.Tensor] = None,
    q_norms_sq: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Distances from each query to its own candidate set.

    q: [B, d]; cand_vecs: [B, C, d] -> [B, C] f32. Precomputed squared
    norms (`cand_norms_sq` [B, C], `q_norms_sq` [B]) skip the reductions.
    """
    metric = Metric.parse(metric)
    q = q.float()
    cand_vecs = cand_vecs.float()
    dots = torch.einsum("bcd,bd->bc", cand_vecs, q)
    if metric == Metric.IP:
        return _epilogue(dots, None, None, metric)
    qn = (q * q).sum(-1, keepdim=True) if q_norms_sq is None else q_norms_sq[:, None].float()
    cn = (cand_vecs * cand_vecs).sum(-1) if cand_norms_sq is None else cand_norms_sq.float()
    return _epilogue(dots, qn, cn, metric)
