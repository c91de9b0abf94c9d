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
  * otherwise the chunked path: the stable k least of the whole tape. On
    CUDA with k <= SELECT_K_MAX one call of `pairwise_topk` (the kernel
    of `csrc/pairtopk.cu`: K4's tile loop with the selection inside,
    replacing the TPU's `_pairwise_kernel` and the XLA merge after it), or
    one call a chunk where the caller passes `chunk`, merged with the
    running best; else (CPU tensors, or k above SELECT_K_MAX) blocks of
    `chunk` rows through K4 (`dispatch_pairwise`), each through
    `select_k`, merged the same way.

Every other row-wise k smallest of both paths, and of `scan_topk` and the
pivot seeding, goes through `select_k`: on CUDA one launch of the
`select_k` kernel (`csrc/selectk.cu`, replacing the XLA selection after
the TPU kernels, `_iter_min_k` and `lax.top_k`), bit for bit the order of
`_select_min_k_plain`, its plain version.
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
    pairwise,
)
from vss_tpu_torch.utils import cdiv, pad_dim, pad_to, resolve_device, round_up

__all__ = ["bruteforce_topk", "merge_topk", "pairwise_topk", "select_k", "SELECT_K_MAX"]

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


def _select_min_k_plain(d: torch.Tensor, k: int):
    """The k smallest along dim 1 as the JAX package selects them: k
    argmin passes up to k = 32, one stable sort above. The CPU path of
    `select_k` and the reference for its kernel."""
    return _iter_min_k(d, k) if k <= _ITER_K_MAX else _sort_min_k(d, k)


# the widest k the select_k kernel takes (csrc/selectk.cu): scan_topk at
# SCAN_K_MAX = 128 keeps up to 256 segments (HNSWIndex.scan_search keeps
# 2k) and reranks m = 256 rows
SELECT_K_MAX = 256

_SELECT_K = csrc.register(csrc.Kernel(
    "select_k", "selectk", "vss_select_k",
    [csrc.PTR] * 5 + [csrc.I32, csrc.I64] + [csrc.I32] * 4,
))

# values one block of select_k reads per tile (csrc/selectk.cu kSkTile)
_SK_TILE = 1024


def _select_k_splits(rows: int, cols: int) -> int:
    """Blocks per row for select_k: one, unless rows are too few to give
    the card's 132 SMs about 4 blocks each (512 in all); then enough for
    that, each reading at least 16 tiles of its row. On the H100 a row of
    512 x 524,288 (or of 512 x 65,536) in one block took less time than
    split over 2 to 16 (`chip_smoke.py --select-k-only`'s sweep)."""
    return max(1, min(cdiv(512, max(rows, 1)), cols // (16 * _SK_TILE)))


def _select_k_plain(d, k: int, valid=None, nan_as_inf: bool = False):
    """Plain version of the select_k kernel: the masked columns and (with
    `nan_as_inf`) NaN made +inf, then `_select_min_k_plain` (k = 0: empty)."""
    if k == 0:
        return (torch.empty((d.shape[0], 0), dtype=d.dtype, device=d.device),
                torch.empty((d.shape[0], 0), dtype=torch.int32, device=d.device))
    if valid is not None:
        d = torch.where(valid[None, :], d, _INF)
    if nan_as_inf:
        d = torch.where(torch.isnan(d), _INF, d)
    return _select_min_k_plain(d, k)


def select_k(d: torch.Tensor, k: int, valid: Optional[torch.Tensor] = None,
             nan_as_inf: bool = False):
    """The k smallest of each row of f32 `d` [R, C] (k <= C): (values
    [R, k] f32, positions [R, k]
    int32) in `_select_min_k_plain`'s order, bit for bit. `valid` [C]
    bool: false reads as +inf; `nan_as_inf`: NaN reads as +inf; a value so
    read comes back as +inf. CUDA tensors with k <= SELECT_K_MAX: one
    launch of the `select_k` kernel, no host sync. Above SELECT_K_MAX (as
    the JAX package above k = 32), and for CPU tensors, `_select_k_plain`:
    above k = 32 that is one stable sort."""
    if d.device.type == "cpu" or k > SELECT_K_MAX:
        return _select_k_plain(d, k, valid, nan_as_inf)
    return _select_k_launch(d, k, valid, nan_as_inf)


def _select_k_launch(d, k: int, valid, nan_as_inf: bool, splits: Optional[int] = None):
    """One launch of the `select_k` kernel with `splits` blocks a row
    (default `_select_k_splits`'s choice; tests force either layout)."""
    if d.dim() != 2 or d.dtype != torch.float32:
        raise ValueError(f"select_k: d must be a 2-D f32 tensor, got {d.dtype} "
                         f"{tuple(d.shape)}")
    R, C = d.shape
    if not 0 <= k <= min(C, SELECT_K_MAX) or C >= 2 ** 31 \
            or (valid is not None and valid.shape != (C,)):
        raise ValueError(f"select_k: k={k} for d {tuple(d.shape)} (k <= min(C, "
                         f"{SELECT_K_MAX})), valid "
                         f"{None if valid is None else tuple(valid.shape)}")
    vals = torch.empty((R, k), dtype=torch.float32, device=d.device)
    pos = torch.empty((R, k), dtype=torch.int32, device=d.device)
    if R == 0 or k == 0:
        return vals, pos
    splits = _select_k_splits(R, C) if splits is None else splits
    d = csrc.operand(d)
    operands = [d, vals, pos]
    vptr = wptr = None
    if valid is not None:
        valid = csrc.operand(valid.to(torch.bool))
        operands.append(valid)
        vptr = valid.data_ptr()
    if splits > 1:
        ws = torch.empty((R * splits * k * 8 + R * 4,), dtype=torch.uint8, device=d.device)
        operands.append(ws)
        wptr = ws.data_ptr()
    _SELECT_K.launch(operands, d.data_ptr(), vptr, vals.data_ptr(), pos.data_ptr(), wptr,
                     R, C, k, splits, int(k <= _ITER_K_MAX), int(nan_as_inf))
    return vals, pos


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
    best_d, best_p = select_k(dd, k)
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


def _chunked_topk(q, x, valid, k, chunk: int, chunk_topk):
    """Running top-k over chunks of `chunk` rows: `chunk_topk(q, rows, kk,
    valid_rows)` gives a chunk's stable kk least (tombstones and NaN read
    as +inf) as (distances, positions in the chunk; any position where
    the distance is not finite), and the stable k least of the running
    best (earlier, lower-id rows first) and the chunk's are those of all
    rows so far."""
    nq = q.shape[0]
    nx = x.shape[0]
    dev = q.device
    best_d = torch.full((nq, k), _INF, device=dev)
    best_i = torch.full((nq, k), -1, dtype=torch.int32, device=dev)
    for start in range(0, nx, chunk):
        stop = min(start + chunk, nx)
        cd, local = chunk_topk(q, x[start:stop], min(k, stop - start),
                               None if valid is None else valid[start:stop])
        cat_d = torch.cat([best_d, cd], 1)
        cat_i = torch.cat([best_i, local + start], 1)
        best_d, pos = _sort_min_k(cat_d, k)
        best_i = cat_i.gather(1, pos.long())
    return best_d, torch.where(torch.isfinite(best_d), best_i, -1)


def _bruteforce_chunked(q, x, valid, k, metric: Metric, chunk: Optional[int]):
    """The oracle's chunked path. CUDA tensors with k <= SELECT_K_MAX: one
    `pairwise_topk` launch over the whole tape, or one a `chunk` of rows
    where the caller passes `chunk`. Otherwise K4 blocks of `chunk` rows
    (default `_choose_chunk`'s), each through `select_k` with the
    tombstones and NaN (NULL queries: no matches) read as +inf."""
    if q.device.type != "cpu" and k <= SELECT_K_MAX:
        if chunk is None:
            return pairwise_topk(q, x, k, metric, valid)
        return _chunked_topk(q, x, valid, k, chunk,
                             lambda qq, xs, kk, vs: pairwise_topk(qq, xs, kk, metric, vs))
    return _chunked_topk(
        q, x, valid, k, chunk or _choose_chunk(x.shape[0], q.shape[0]),
        lambda qq, xs, kk, vs: select_k(dispatch_pairwise(qq, xs, metric), kk, vs,
                                        nan_as_inf=True))


_PAIRWISE_TOPK = csrc.register(csrc.Kernel(
    "pairwise_topk", "pairtopk", "vss_pairwise_topk",
    [csrc.PTR] * 6 + [csrc.I32, csrc.I64] + [csrc.I32] * 4,
))

# tape rows a tile and queries a block of pairwise_topk (csrc/pairtopk.cu
# kPtRows, kPtQueries)
_PT_ROWS = 128
_PT_QUERIES = 128


def _pairwise_topk_slabs(nq: int, nx: int) -> int:
    """Slabs of the tape for pairwise_topk: enough that its blocks (one per
    128 queries and slab) number about two for each of the card's 132 SMs,
    each slab at least one 128-row tile."""
    return max(1, min(cdiv(nx, _PT_ROWS), cdiv(2 * 132, cdiv(max(nq, 1), _PT_QUERIES))))


def _pairwise_topk_plain(q, x, k: int, metric, valid=None, chunk: Optional[int] = None):
    """Plain version of the pairwise_topk kernel: the chunked loop through
    `pairwise` and `_select_k_plain` (chunks of `chunk` rows, default
    `_choose_chunk`'s)."""
    metric = Metric.parse(metric)
    return _chunked_topk(
        q, x, valid, k, chunk or _choose_chunk(x.shape[0], q.shape[0]),
        lambda qq, xs, kk, vs: _select_k_plain(pairwise(qq, xs, metric), kk, vs,
                                               nan_as_inf=True))


def pairwise_topk(q: torch.Tensor, x: torch.Tensor, k: int, metric,
                  valid: Optional[torch.Tensor] = None):
    """The stable k smallest distances from each query of q [nq, d] to the
    rows of x [nx, d] that `valid` [nx] (bool) keeps: (distances [nq, k]
    f32 ascending, ids [nq, k] int32). Ties go to the lower row; tombstoned
    rows and NaN distances are left out; slots past the candidates are
    (+inf, -1), and an id is -1 wherever its distance is not finite. CUDA
    tensors (k <= SELECT_K_MAX): one call of the `pairwise_topk` kernel,
    no host sync and no [nq, nx] block, bit for bit K4 then `select_k`
    then the stable merge. CPU tensors: `_pairwise_topk_plain`."""
    metric = Metric.parse(metric)
    if q.device.type == "cpu":
        return _pairwise_topk_plain(q, x, k, metric, valid)
    return _pairwise_topk_launch(q, x, k, metric, valid)


def _pairwise_topk_launch(q, x, k: int, metric: Metric, valid=None, slabs=None):
    """One call of the pairwise_topk kernel (two launches and a memset),
    the tape cut into `slabs` slabs (default `_pairwise_topk_slabs`'s;
    tests force others)."""
    if q.dim() != 2 or x.dim() != 2 or q.shape[1] != x.shape[1] \
            or not 0 <= k <= SELECT_K_MAX or x.shape[0] >= 2 ** 31 \
            or (valid is not None and valid.shape != (x.shape[0],)):
        raise ValueError(f"pairwise_topk: q {tuple(q.shape)}, x {tuple(x.shape)}, k={k} (k <= "
                         f"{SELECT_K_MAX}) and valid "
                         f"{None if valid is None else tuple(valid.shape)} disagree")
    nq, d = q.shape
    nx = x.shape[0]
    dev = q.device
    dists = torch.empty((nq, k), dtype=torch.float32, device=dev)
    ids = torch.empty((nq, k), dtype=torch.int32, device=dev)
    if nq == 0 or k == 0:
        return dists, ids
    if nx == 0:
        return dists.fill_(_INF), ids.fill_(-1)
    # zero columns up to the kernel's 16-column step change no sum
    cols = max(16, round_up(d, 16))
    q = csrc.operand(pad_dim(q.float(), 1, cols))
    x = csrc.operand(pad_dim(x.float(), 1, cols))
    slabs = _pairwise_topk_slabs(nq, nx) if slabs is None else slabs
    nbytes = _PAIRWISE_TOPK.function("vss_pairwise_topk_workspace_bytes", csrc.I64,
                                     [csrc.I32] * 3)(nq, slabs, k)
    ws = torch.empty((max(nbytes, 0),), dtype=torch.uint8, device=dev)
    operands = [q, x, dists, ids, ws]
    vptr = None
    if valid is not None:
        valid = csrc.operand(valid.to(torch.bool))
        operands.append(valid)
        vptr = valid.data_ptr()
    _PAIRWISE_TOPK.launch(operands, q.data_ptr(), x.data_ptr(), vptr, dists.data_ptr(),
                          ids.data_ptr(), ws.data_ptr(), nq, nx, cols, METRIC_IDS[metric], k,
                          slabs)
    return dists, ids


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
        sd, si = select_k(segmins.T.contiguous(), keep)
        segs = torch.where(torch.isfinite(sd), si, -1)
        # keep >= min(k, 5) segments hold >= k rows, so k always fits
        return _rescore_segments(q, segs, x, valid_mask, k, metric, highest)
    return _bruteforce_chunked(q, x, valid_mask, k, metric, chunk)


def merge_topk(dists: torch.Tensor, ids: torch.Tensor, k: int):
    """Merge per-source top-k lists into a global top-k (stable: ties
    keep the earlier source). dists/ids: [nq, S*k] -> ([nq, k], [nq, k])."""
    vals, pos = torch.sort(dists, dim=-1, stable=True)
    return vals[..., :k], ids.gather(-1, pos[..., :k])
