"""The plain reference: exact nearest neighbours over the live rows.

Plain PyTorch on the rows the benchmark generated: it imports nothing of
the program and reads none of its tapes, scales, graphs or oracles. The
k nearest of each query come from the squared-L2 expansion
|q|^2 - 2 q.x + |x|^2 over blocks of rows, in float32 with TF32 off,
each block's k least merged with the running k least (a tie at the
k-th distance may keep either row). `distances` is the direct form sum((q - x)^2) in float64, which
judges the distances an answer reports.

Metrics: `l2sq` and `cosine` (1 - cos, rows and queries normalised
first); the search and the direct form follow the metric.

`precision="tf32"` is the control of the check: the same search with its
products' operands rounded to TF32 (10 explicit mantissa bits, to
nearest even), as the tensor cores take float32 with TF32 on. The
rounding is done here, so the control reads the same on a CPU.
"""
from __future__ import annotations

import contextlib

import torch

_BLOCK = 262_144


@contextlib.contextmanager
def tf32_off():
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, to nearest even."""
    b = x.contiguous().view(torch.int32)
    lsb = (b >> 13) & 1
    b = (b + 0x0FFF + lsb) & ~0x1FFF
    return b.view(torch.float32)


def _check_metric(metric: str):
    if metric not in ("l2sq", "cosine"):
        raise ValueError(f"the reference has no metric {metric!r}")


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-30)


def knn(q: torch.Tensor, rows: torch.Tensor, k: int, ids=None, precision: str = "f32",
        metric: str = "l2sq"):
    """The k nearest rows of each query: (dists [nq, k] float32
    ascending, ids [nq, k] int64). `ids` [n] names the rows (default
    0 .. n-1)."""
    if precision not in ("f32", "tf32"):
        raise ValueError(precision)
    _check_metric(metric)
    q = q.float()
    if metric == "cosine":
        q = _unit(q)
    if precision == "tf32":
        q = round_tf32(q)
    qn = (q * q).sum(1, keepdim=True)
    n = rows.shape[0]
    if ids is None:
        ids = torch.arange(n, device=rows.device)
    best_d = torch.full((q.shape[0], 0), float("inf"), device=q.device)
    best_i = torch.zeros((q.shape[0], 0), dtype=torch.int64, device=q.device)
    with tf32_off():
        for s in range(0, n, _BLOCK):
            x = rows[s:s + _BLOCK].float()
            if metric == "cosine":
                x = _unit(x)
            xn = (x * x).sum(1)
            if precision == "tf32":
                x = round_tf32(x)
            if metric == "cosine":
                d = 1.0 - q @ x.T
            else:
                d = (qn - 2.0 * (q @ x.T)) + xn[None, :]
            kk = min(k, d.shape[1])
            bd, bp = torch.topk(d, kk, dim=1, largest=False, sorted=True)
            cd = torch.cat([best_d, bd], 1)
            ci = torch.cat([best_i, ids[s:s + _BLOCK][bp]], 1)
            # ascending by distance, then by id: sort by id first, then a
            # stable sort by distance
            oi = torch.argsort(ci, dim=1, stable=True)
            cd, ci = cd.gather(1, oi), ci.gather(1, oi)
            od = torch.argsort(cd, dim=1, stable=True)[:, :k]
            best_d, best_i = cd.gather(1, od), ci.gather(1, od)
    return best_d, best_i


def distances(q: torch.Tensor, rows: torch.Tensor, metric: str = "l2sq") -> torch.Tensor:
    """The direct form in float64: q [nq, d] against rows [nq, k, d]."""
    _check_metric(metric)
    q, rows = q.double(), rows.double()
    if metric == "cosine":
        return 1.0 - (_unit(rows) * _unit(q)[:, None, :]).sum(-1)
    diff = rows - q[:, None, :]
    return (diff * diff).sum(-1)


def recall(found: torch.Tensor, exact: torch.Tensor) -> torch.Tensor:
    """Per query, the share of the exact k ids that `found` [nq, k] holds."""
    k = exact.shape[1]
    hit = (found[:, :, None] == exact[:, None, :]) & (exact[:, None, :] >= 0)
    return hit.any(1).sum(1).double() / k
