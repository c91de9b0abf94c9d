"""Storage-native exact scan: stream the tape in its stored dtype.

Reproduces `vss_tpu/ops/scan.py`, the serving path of the exact scan:

  phase A (winnow): kernel K2 (`native_segmin`, `csrc/scan.cu`,
    replacing the TPU's `_native_segmin_kernel`) reads the tape once in
    its stored dtype, scores bf16 query x bf16-decoded rows in f32 with a
    proxy distance that drops the per-query constant, and writes the
    minimum of every 32-row sub-segment.
  selection (two-level): 128-row super-segment minima select the `keep`
    best supers (at most k segments can contain a true top-k row, so
    top-(k+margin) supers by minimum hold them all); the selected
    supers' 4 sub-minima each then select the `keep` best sub-segments
    by the same bound.
  phase B (rescore): gather the kept sub-segments' rows from the stored
    tape and score them: bf16 inputs in f32 when a rerank tape follows,
    exact f32 otherwise.
  phase C (exact rerank): the best m = max(2k, k+6) rows are rescored
    from the f32 side tape with direct-difference l2sq and sorted.

Phases B and C and the selections are plain PyTorch (XLA in the JAX
package). The TPU tile sizes, corpus chunking and VMEM budgets are not
carried over.
"""
from __future__ import annotations

from typing import Optional

import torch

from vss_tpu_torch import csrc
from vss_tpu_torch.ops.distance import METRIC_IDS, Metric, _epilogue
from vss_tpu_torch.ops.topk import (
    _BLOCK_ELEMS,
    _SEG,
    _select_min_k,
    bruteforce_topk,
)
from vss_tpu_torch.utils import cdiv, pad_to, resolve_device

__all__ = ["scan_topk", "native_scan_supported", "SCAN_K_MAX"]

_INF = float("inf")

# sub-segment granularity of the two-level winnow; _SEG (128) stays the
# super-segment granularity, so one K2 tile of 128 rows is 4 subs
_SUBSEG = 32
_GROUP = _SEG // _SUBSEG

# widest k the native path serves
SCAN_K_MAX = 128


def native_scan_supported(dtype) -> bool:
    return dtype in (torch.int8, torch.bfloat16, torch.float32)


_K2 = csrc.register(csrc.Kernel(
    "native_segmin", "scan", "vss_native_segmin",
    [csrc.PTR, csrc.PTR, csrc.PTR, csrc.PTR, csrc.PTR, csrc.I32, csrc.I64,
     csrc.I32, csrc.I32, csrc.I32],
))


def _native_segmin_plain(q, x, xn, valid, metric: Metric):
    """Plain version of K2: [4*ceil(nx/128), nq] sub-segment minima of
    the proxy distance."""
    xb = x.to(torch.bfloat16).float()
    dots = xb @ q.float().T  # [nx, nq]; bf16 inputs, f32 sums
    xn = xn[:, None]
    if metric == Metric.IP:
        d = -dots
    elif metric == Metric.L2SQ:
        d = xn - 2.0 * dots  # the query norm is constant per query
    else:  # cosine: order by -cos; zero rows order like cos == 0
        d = torch.where(xn > 0.0, -dots * torch.rsqrt(torch.clamp(xn, min=1e-30)), 0.0)
    d = torch.where(valid[:, None], d, _INF)
    d = pad_to(d, 0, _SEG, value=_INF)
    return d.reshape(-1, _SUBSEG, d.shape[1]).amin(1)


def native_segmin(q, tape, x_norms, valid, metric) -> torch.Tensor:
    """K2 wrapper. q [nq, d] bf16; tape [nx, d] int8 / bf16 / f32;
    x_norms [nx] f32 squared norms of the stored values; valid bool [nx].
    Returns [4*ceil(nx/128), nq] f32: row s is the minimum proxy distance
    over tape rows [32s, 32s+32) (+inf past the tape)."""
    metric = Metric.parse(metric)
    if tape.device.type == "cpu":
        return _native_segmin_plain(q, tape, x_norms, valid, metric)
    return _native_segmin_launch(q, tape, x_norms, valid, metric)


def _native_segmin_launch(q, tape, x_norms, valid, metric: Metric) -> torch.Tensor:
    """K2's launch: checks the shapes, pads the width to a multiple of 16
    and launches on the device of `tape`."""
    nx = tape.shape[0]
    if q.shape[1] != tape.shape[1] or x_norms.shape != (nx,) or valid.shape != (nx,):
        raise ValueError(f"native_segmin: q {tuple(q.shape)}, tape {tuple(tape.shape)}, "
                         f"norms {tuple(x_norms.shape)} and valid {tuple(valid.shape)} disagree")
    q = csrc.operand(pad_to(q.to(torch.bfloat16), 1, 16))
    tape = csrc.operand(pad_to(tape, 1, 16))
    xn = csrc.operand(x_norms.float())
    valid = csrc.operand(valid.to(torch.bool))
    nq, d = q.shape
    out = torch.empty((_GROUP * cdiv(nx, _SEG), nq), dtype=torch.float32,
                      device=tape.device)
    if nq and nx:
        _K2.launch((q, tape, xn, valid, out), q.data_ptr(), tape.data_ptr(), xn.data_ptr(),
                   valid.data_ptr(), out.data_ptr(), nq, nx, d,
                   csrc.dtype_code(tape.dtype), METRIC_IDS[metric])
    return out


def _select_subsegments(subs: torch.Tensor, keep: int) -> torch.Tensor:
    """Two-level selection from [NS_sub, nq] sub-minima -> [nq, keep']
    sub-segment ids (-1 pad): the `keep` best supers by minimum, then the
    `keep` best subs among their sub-minima."""
    submins = subs.T.contiguous()  # [nq, NS_sub]; sub i = rows [32i, 32i+32)
    nq, ns_sub = submins.shape
    supermins = submins.reshape(nq, ns_sub // _GROUP, _GROUP).amin(2)
    sd, si = _select_min_k(supermins, min(keep, ns_sub // _GROUP))
    group = torch.arange(_GROUP, dtype=torch.int32, device=subs.device)
    sub_idx = (si.clamp(min=0)[:, :, None] * _GROUP + group).reshape(nq, -1)
    sub_vals = submins.gather(1, sub_idx.long())
    sub_vals = torch.where(
        torch.isfinite(sd).repeat_interleave(_GROUP, 1), sub_vals, _INF
    )
    ssd, ssp = _select_min_k(sub_vals, min(keep, sub_vals.shape[1]))
    sub_global = sub_idx.gather(1, ssp.long())
    return torch.where(torch.isfinite(ssd), sub_global, -1)


def _rescore_native_block(q, segs, tape, x_norms, valid, rerank_tape, m, k,
                          metric: Metric):
    """Phases B and C for one chunk of queries."""
    nq = q.shape[0]
    nx = tape.shape[0]
    keep = segs.shape[1]
    lanes = torch.arange(_SUBSEG, dtype=torch.int32, device=q.device)
    rows = (segs.clamp(min=0)[:, :, None] * _SUBSEG + lanes).reshape(nq, keep * _SUBSEG)
    rows = torch.where((segs >= 0).repeat_interleave(_SUBSEG, 1), rows, -1)
    safe = rows.clamp(0, nx - 1).long()
    xg = tape[safe]  # [nq, C, d] in the stored dtype
    if rerank_tape is not None:
        # bf16 inputs, f32 sums: int8 values are exact in bf16 and phase C
        # reranks the m-pool at f32, so only the q rounding can perturb
        # the m boundary, which the m > k margin covers
        g = xg.to(torch.bfloat16).float()
        qq = q.to(torch.bfloat16).float()
    else:
        g = xg.float()
        qq = q
    dots = torch.bmm(g, qq[:, :, None])[:, :, 0]
    qn = (q * q).sum(1, keepdim=True)
    xn = x_norms[safe]
    dd = _epilogue(dots, qn, xn, metric)
    ok = (rows >= 0) & (rows < nx) & valid[safe]
    dd = torch.where(ok & ~torch.isnan(dd), dd, _INF)
    bd, bp = _select_min_k(dd, m)
    bi = rows.gather(1, bp.long())
    bi = torch.where(torch.isfinite(bd), bi, -1)
    if rerank_tape is None:
        return bd[:, :k], bi[:, :k]
    # phase C: exact f32 rerank of the m-wide pool from the side tape
    rv = rerank_tape[bi.clamp(min=0).long()].float()
    if metric == Metric.L2SQ:
        # direct difference form: the dot-product identity loses digits to
        # cancellation at byte magnitudes
        diff = q[:, None, :] - rv
        rd = (diff * diff).sum(-1)
    else:
        rdots = torch.einsum("bcd,bd->bc", rv, q)
        rn = (rv * rv).sum(-1)
        rd = _epilogue(rdots, qn, rn, metric)
    rd = torch.where((bi >= 0) & ~torch.isnan(rd), rd, _INF)
    rd, order = torch.sort(rd, dim=1, stable=True)
    ri = bi.gather(1, order)
    return rd[:, :k], torch.where(torch.isfinite(rd[:, :k]), ri[:, :k], -1)


def scan_topk(
    q: torch.Tensor,
    tape: torch.Tensor,
    k: int,
    metric,
    valid_mask: Optional[torch.Tensor] = None,
    x_norms: Optional[torch.Tensor] = None,
    rerank_tape: Optional[torch.Tensor] = None,
    keep: Optional[int] = None,
    device=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """ANN-grade exact scan over a storage-dtype tape.

    q [nq, d] f32 (in the tape's scaled units); tape [nx, d] int8 / bf16
    / f32; x_norms optional f32 [nx] squared norms of the stored values
    (computed here if absent); rerank_tape optional f32 / bf16 [nx, d]
    full-precision side tape for the final exact rerank. Returns (dists
    [nq, k] f32 ascending, slot ids [nq, k] int32, -1 pad). Distances
    are exact with respect to the rerank tape when given, else to the
    stored values. Runs on `device` (CUDA unless "cpu" is passed), where
    the inputs are moved. `bruteforce_topk` stays the bit-exact oracle.

    Where this differs from the JAX package: `keep` is capped at the
    tape's 32-row sub-segments, `4 * ceil(nx / 128)`, where
    `vss_tpu/ops/scan.py:401-402` caps it at the 128-row super-segments.
    The JAX cap can fall below k and so breaks the winnow's bound (at most
    k segments hold the true top-k): on small tapes at large k (3,000
    rows at k=128, 4,096 and 8,192 rows at k=100 with keep=2k) the JAX
    package misses true neighbours and this function does not. Where
    neither cap binds (20,000 rows at k=100) the two agree.
    `tests/test_torch_scan.py` pins both.
    """
    metric = Metric.parse(metric)
    dev = resolve_device(device)
    nq = q.shape[0]
    nx = tape.shape[0]
    q = q.to(dev, torch.float32)
    tape = tape.to(dev)
    if rerank_tape is not None:
        rerank_tape = rerank_tape.to(dev)
    if not (native_scan_supported(tape.dtype) and nx > 16 * _SEG and k <= SCAN_K_MAX):
        # the fallback scores the f32 side tape when one exists (exact
        # distances, the same contract as phase C)
        base = rerank_tape if rerank_tape is not None else tape
        return bruteforce_topk(q, base.float(), k, metric, valid_mask=valid_mask,
                               device=dev)
    if valid_mask is None:
        valid_mask = torch.ones((nx,), dtype=torch.bool, device=dev)
    valid_mask = valid_mask.to(dev, torch.bool)
    if x_norms is None:
        xf = tape.float()
        x_norms = (xf * xf).sum(-1)
    x_norms = x_norms.to(dev, torch.float32)
    if keep is None:
        # margin over the exact-arithmetic bound for bf16 proxy noise near
        # the selection boundary; k//8 grows it with k
        keep = k + max(2, k // 8)
    keep = min(keep, _GROUP * cdiv(nx, _SEG))
    subs = native_segmin(q.to(torch.bfloat16), tape, x_norms, valid_mask, metric)
    segs = _select_subsegments(subs, keep)
    has_rr = rerank_tape is not None
    m = min(max(2 * k, k + 6), segs.shape[1] * _SUBSEG) if has_rr else k
    # phases B and C over query chunks that gather at most ~_BLOCK_ELEMS values
    cq = max(1, _BLOCK_ELEMS // max(segs.shape[1] * _SUBSEG * q.shape[1], 1))
    parts = [
        _rescore_native_block(q[s:s + cq], segs[s:s + cq], tape, x_norms,
                              valid_mask, rerank_tape, m, k, metric)
        for s in range(0, nq, cq)
    ]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])
