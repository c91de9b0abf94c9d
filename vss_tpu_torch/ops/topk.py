"""Brute-force exact k-NN and top-k merge.

Reproduces `vss_tpu/ops/topk.py`, the exact oracle of the package.

Conventions (unchanged):
  * distances ascending, f32; invalid/padded slots get +inf and id -1;
  * ties go to the lower slot id (`torch.argmin` returns the first
    minimum, and sorts are stable);
  * a NaN distance (a NULL query) becomes +inf.

Two paths, as in the JAX package:
  * k <= 64 and nx > 512: segment-min winnowing. Kernel K3
    (`segmin_scan`, `csrc/topk.cu`, replacing the TPU's
    `_scan_segmin_kernel`) streams the tape once and writes the minimum
    distance of every 128-row segment per query; the k smallest segments
    hold the top-k (if element x is in the top-k but its segment is not
    among those k, then k segments have a smaller minimum than x and
    each contributes an element < x, a contradiction). The candidate
    segments are then rescored exactly and reduced.
  * otherwise: chunked distances through K4 (`dispatch_pairwise`) with a
    running top-k.
"""
from __future__ import annotations

from typing import Optional

import torch

from vss_tpu_torch import csrc
from vss_tpu_torch.ops.distance import (
    METRIC_IDS,
    Metric,
    _epilogue,
    dispatch_pairwise,
)
from vss_tpu_torch.utils import cdiv, pad_to, resolve_device, round_up

__all__ = ["bruteforce_topk", "merge_topk"]

_INF = float("inf")

_SEG = 128  # rows per winnowing segment (K3's tile)

# beyond this k, one stable sort beats k argmin passes
_ITER_K_MAX = 32

# the winnow path serves k up to here; above it the chunked path's sorts win
_WINNOW_K_MAX = 64

# f32 elements of one chunked-path distance block or one rescore gather:
# 2^28 is 1 GiB, small against the H100's 80 GB and large enough that a
# 512-query batch over 10^6 rows takes two chunks
_BLOCK_ELEMS = 1 << 28


def _iter_min_k(d: torch.Tensor, k: int):
    """Exact smallest-k along dim 1 by k passes of (argmin, mask); ties
    resolve to the lowest index. Returns (values, int32 positions)."""
    cur = d.clone()
    vals, idxs = [], []
    for _ in range(k):
        i = torch.argmin(cur, dim=1, keepdim=True)
        vals.append(cur.gather(1, i))
        idxs.append(i)
        cur.scatter_(1, i, _INF)
    return torch.cat(vals, 1), torch.cat(idxs, 1).to(torch.int32)


def _sort_min_k(d: torch.Tensor, k: int):
    """The k smallest along dim 1 by a stable sort (ties to lower index)."""
    vals, pos = torch.sort(d, dim=1, stable=True)
    return vals[:, :k], pos[:, :k].to(torch.int32)


def _select_min_k(d: torch.Tensor, k: int):
    return _iter_min_k(d, k) if k <= _ITER_K_MAX else _sort_min_k(d, k)


_K3 = csrc.register(csrc.Kernel(
    "scan_segmin", "topk", "vss_scan_segmin",
    [csrc.PTR, csrc.PTR, csrc.PTR, csrc.PTR, csrc.I32, csrc.I64, csrc.I32,
     csrc.I32, csrc.I32],
))


def _segmin_scan_plain(q, x, valid, metric: Metric, highest: bool):
    """Plain version of K3: [ceil(nx/128), nq] segment minima."""
    q = q.float()
    x = x.float()
    qd, xd = (q, x) if highest else (
        q.to(torch.bfloat16).float(), x.to(torch.bfloat16).float()
    )
    dots = qd @ xd.T  # [nq, nx]
    qn = (q * q).sum(-1, keepdim=True)
    xn = (x * x).sum(-1)[None, :]
    d = _epilogue(dots, qn, xn, metric)
    ok = torch.ones_like(xn, dtype=torch.bool) if valid is None else valid[None, :]
    d = torch.where(ok & ~torch.isnan(d), d, _INF)
    d = pad_to(d, 1, _SEG, value=_INF)
    return d.reshape(d.shape[0], -1, _SEG).amin(2).T


def segmin_scan(q, x, valid, metric, highest: bool = True) -> torch.Tensor:
    """K3 wrapper: min distance of each 128-row segment of x to each
    query -> [ceil(nx/128), nq] f32. valid: optional bool [nx]. Invalid
    rows, rows past nx and NaN distances count as +inf. highest=False
    rounds the dot inputs to bf16 (precision='default')."""
    metric = Metric.parse(metric)
    if x.device.type == "cpu":
        return _segmin_scan_plain(q, x, valid, metric, highest)
    if q.shape[1] != x.shape[1] or (valid is not None and valid.shape != (x.shape[0],)):
        raise ValueError(f"segmin_scan: q {tuple(q.shape)}, x {tuple(x.shape)} and valid "
                         f"{None if valid is None else tuple(valid.shape)} disagree")
    q = csrc.operand(pad_to(q.float(), 1, 16))
    x = csrc.operand(pad_to(x.float(), 1, 16))
    nq, d = q.shape
    nx = x.shape[0]
    out = torch.empty((cdiv(nx, _SEG), nq), dtype=torch.float32, device=x.device)
    vptr = None
    operands = [q, x, out]
    if valid is not None:
        valid = csrc.operand(valid.to(torch.bool))
        vptr = valid.data_ptr()
        operands.append(valid)
    if nq and nx:
        _K3.launch(operands, q.data_ptr(), x.data_ptr(), vptr, out.data_ptr(),
                   nq, nx, d, METRIC_IDS[metric], 0 if highest else 1)
    return out


def _rescore_block(q, segs, x, valid, k, metric: Metric, highest: bool):
    """Exact top-k within each query's candidate segments (keep*128
    consecutive rows per query), scored in one batched product."""
    nq = q.shape[0]
    nx = x.shape[0]
    keep = segs.shape[1]
    lanes = torch.arange(_SEG, dtype=torch.int32, device=q.device)
    rows = (segs.clamp(min=0)[:, :, None] * _SEG + lanes).reshape(nq, keep * _SEG)
    rows = torch.where((segs >= 0).repeat_interleave(_SEG, 1), rows, -1)
    safe = rows.clamp(0, nx - 1).long()
    xg = x[safe]  # [nq, C, d]
    qd, xd = (q, xg) if highest else (
        q.to(torch.bfloat16).float(), xg.to(torch.bfloat16).float()
    )
    dots = torch.bmm(xd, qd[:, :, None])[:, :, 0]
    ok = (rows >= 0) & (rows < nx) & valid[safe]
    if metric == Metric.IP:
        dd = 1.0 - dots
    else:
        qn = (q * q).sum(1, keepdim=True)
        xn = (xg * xg).sum(2)
        dd = _epilogue(dots, qn, xn, metric)
    dd = torch.where(ok & ~torch.isnan(dd), dd, _INF)
    best_d, best_p = _select_min_k(dd, k)
    best_i = rows.gather(1, best_p.long())
    return best_d, torch.where(torch.isfinite(best_d), best_i, -1)


def _rescore_segments(q, segs, x, valid, k, metric: Metric, highest: bool):
    """_rescore_block over query chunks, each gathering at most about
    _BLOCK_ELEMS tape values."""
    nq = q.shape[0]
    cq = max(1, _BLOCK_ELEMS // max(segs.shape[1] * _SEG * x.shape[1], 1))
    parts = [
        _rescore_block(q[s:s + cq], segs[s:s + cq], x, valid, k, metric, highest)
        for s in range(0, nq, cq)
    ]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def _choose_chunk(nx: int, nq: int) -> int:
    return min(round_up(nx, 512), max(512, _BLOCK_ELEMS // max(nq, 1) // 512 * 512))


def _bruteforce_chunked(q, x, valid, k, metric: Metric, chunk: int):
    """Running top-k over [nq, chunk] distance blocks from K4."""
    nq = q.shape[0]
    nx = x.shape[0]
    dev = q.device
    best_d = torch.full((nq, k), _INF, device=dev)
    best_i = torch.full((nq, k), -1, dtype=torch.int32, device=dev)
    for start in range(0, nx, chunk):
        stop = min(start + chunk, nx)
        d = dispatch_pairwise(q, x[start:stop], metric)  # [nq, <=chunk]
        d = torch.where(valid[None, start:stop], d, _INF)
        d = torch.where(torch.isnan(d), _INF, d)  # NULL queries -> no matches
        if k <= _ITER_K_MAX:
            cd, local = _iter_min_k(d, min(k, stop - start))
        else:
            cd, local = d, torch.arange(stop - start, dtype=torch.int32, device=dev).expand(nq, -1)
        # stable merge: earlier (lower-id) candidates first
        cat_d = torch.cat([best_d, cd], 1)
        cat_i = torch.cat([best_i, local + start], 1)
        best_d, pos = _sort_min_k(cat_d, k)
        best_i = cat_i.gather(1, pos.long())
    return best_d, torch.where(torch.isfinite(best_d), best_i, -1)


def bruteforce_topk(
    q: torch.Tensor,
    x: torch.Tensor,
    k: int,
    metric,
    valid_mask: Optional[torch.Tensor] = None,
    chunk: Optional[int] = None,
    precision: str = "highest",
    device=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact k nearest neighbors of each query by full scan.

    q: [nq, d]; x: [nx, d]; valid_mask: optional bool [nx] (False =
    tombstone). Runs on `device` (CUDA unless "cpu" is passed), where the
    inputs are moved. Returns (dists [nq, k] ascending f32, slot ids
    [nq, k] int32, -1 past the end).

    precision='highest' keeps f32-exact distance ordering; 'default'
    winnows with bf16-rounded dot inputs and keeps 2k candidate segments
    so near-tie reorderings cannot drop a true winner.
    """
    metric = Metric.parse(metric)
    dev = resolve_device(device)
    nq = q.shape[0]
    nx = x.shape[0]
    q = q.to(dev, torch.float32)
    x = x.to(dev)
    if nx == 0:
        return (
            torch.full((nq, k), _INF, device=dev),
            torch.full((nq, k), -1, dtype=torch.int32, device=dev),
        )
    if valid_mask is None:
        valid_mask = torch.ones((nx,), dtype=torch.bool, device=dev)
    valid_mask = valid_mask.to(dev, torch.bool)
    x = x.float()
    if k <= _WINNOW_K_MAX and nx > 4 * _SEG:
        highest = precision == "highest"
        segmins = segmin_scan(q, x, valid_mask, metric, highest)  # [NS, nq]
        keep = min(k if highest else 2 * k, segmins.shape[0])
        sd, si = _select_min_k(segmins.T.contiguous(), keep)
        segs = torch.where(torch.isfinite(sd), si, -1)
        # keep >= min(k, 5) segments hold >= k rows, so k always fits
        return _rescore_segments(q, segs, x, valid_mask, k, metric, highest)
    chunk = chunk or _choose_chunk(nx, nq)
    return _bruteforce_chunked(q, x, valid_mask, k, metric, chunk)


def merge_topk(dists: torch.Tensor, ids: torch.Tensor, k: int):
    """Merge per-source top-k lists into a global top-k (stable: ties
    keep the earlier source). dists/ids: [nq, S*k] -> ([nq, k], [nq, k])."""
    vals, pos = torch.sort(dists, dim=-1, stable=True)
    return vals[..., :k], ids.gather(-1, pos[..., :k])
