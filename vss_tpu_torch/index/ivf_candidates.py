"""IVF-window candidate generation for bulk graph construction.

Reproduces `vss_tpu/index/ivf_candidates.py`. The exact candidate pass
(`index/exact_build.exact_knn`) scores every point against every other
point, and its top-C selection over n columns per row dominates at
corpus scale. This pass blocks by locality instead:

  1. assign every point to its nearest of ~n/window sampled centres,
  2. sort points by centre id and cut the sorted order into equal
     `window`-row buckets,
  3. rank buckets by centroid distance; each bucket's points score
     against the union of its `probes` nearest buckets' points,
  4. exact top-C inside that union, mapped back to the original ids.

The lists are approximate (a true neighbour outside the probed buckets is
missed); refine, back-links and repair downstream, and NN-descent or the
scan pass upstream of them, make up for it. Deterministic given `seed`:
the centres are the same numpy draw as in the JAX package.

On the card (the JAX package's TPU branch) the window tape and the
distance buffer are bf16 and products take bf16-rounded inputs summed in
f32; on the CPU f32 tapes stay f32. The JAX package's approximate top-k
is an exact top-k here, and its 16 GB chunk sizes are gone: groups of
buckets are sized for the card's memory, without changing the lists.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from vss_tpu_torch.ops.distance import Metric, _epilogue
from vss_tpu_torch.utils import cdiv, round_up

__all__ = ["ivf_candidates"]

_INF = float("inf")

# distance elements one scoring group may hold (2^27: 256 MB in bf16)
_GROUP_ELEMS = 1 << 27


def _assign_pass(x, centers, chunk: int = 65536):
    """Nearest-centre id for every row of x. l2 geometry for every metric
    (assignment only partitions space) and bf16-rounded inputs (partition
    boundaries are not quality-sensitive), summed in f32."""
    from vss_tpu_torch.index.exact_build import _bf16_dots

    cn = (centers * centers).sum(1)[None, :]
    out = []
    for s in range(0, x.shape[0], chunk):
        # + |q|^2, constant per row: argmin-invariant
        d = cn - 2.0 * _bf16_dots(x[s:s + chunk], centers)
        out.append(torch.argmin(d, dim=1).to(torch.int32))
    return torch.cat(out)


def _score_groups(win_tape, gids, nbr, C: int, metric_name: str, G: int, window: int,
                  probes: int, score_bf16: bool = False):
    """Top-C candidates for every point, bucket-blocked, G buckets at a
    time. win_tape [W, window, d] sorted and padded tape; gids [W, window]
    original ids per sorted position (-1 pad); nbr [W, probes] neighbour
    buckets. Returns (cand_d [W*window, C] ascending f32, cand_i [W*window,
    C] original ids, -1 padded) in sorted-position order. score_bf16 keeps
    the gathered keys and the distance buffer in bf16 (candidate ordering
    is all that survives this pass)."""
    from vss_tpu_torch.index.exact_build import _bf16_dots, _min_k

    metric = Metric.parse(metric_name)
    W, _, d = win_tape.shape
    K = probes * window
    dd = torch.bfloat16 if score_bf16 else torch.float32
    f32 = win_tape.dtype == torch.float32
    dev = win_tape.device
    out_d = torch.full((W * window, C), _INF, device=dev)
    out_i = torch.full((W * window, C), -1, dtype=torch.int32, device=dev)
    for w0 in range(0, W, G):
        g = min(G, W - w0)
        nb = nbr[w0:w0 + g].long()                         # [g, probes]
        keys = win_tape[nb].reshape(g, K, d)               # [g, K, d]
        kid = gids[nb].reshape(g, K)                       # original ids
        q = win_tape[w0:w0 + g]                            # [g, window, d]
        qid = gids[w0:w0 + g]
        qf = q.float()
        kf = keys.float()
        dots = torch.bmm(qf, kf.transpose(1, 2)) if f32 else _bf16_dots(q, keys)
        qn = (qf * qf).sum(2)[:, :, None]
        kn = (kf * kf).sum(2)[:, None, :]
        dist = _epilogue(dots, qn, kn, metric).to(dd)     # [g, window, K]
        bad = (kid[:, None, :] < 0) | (kid[:, None, :] == qid[:, :, None])
        dist = torch.where(bad, _INF, dist).reshape(g * window, K)
        cd, pos = _min_k(dist, C)
        ci = kid[:, None, :].expand(g, window, K).reshape(g * window, K).gather(1, pos.long())
        cd = cd.float()
        out_d[w0 * window:(w0 + g) * window] = cd
        out_i[w0 * window:(w0 + g) * window] = torch.where(torch.isfinite(cd), ci, -1)
    return out_d, out_i


def ivf_candidates(
    vecs: torch.Tensor,
    ids: torch.Tensor,
    C: int,
    metric,
    *,
    window: int = 256,
    probes: int = 16,
    seed: int = 0,
    progress: Optional[Callable[[int, int], None]] = None,
):
    """Locality-blocked top-C candidate lists (see the module docstring).

    Same contract as `exact_build.exact_knn`: vecs [n, d] (f32, bf16 or an
    int8 storage tape, which keeps its dtype), ids [n] global ids; returns
    (dists [n, C] ascending f32, ids [n, C] i32, -1 padded) in the
    original row order, self-matches excluded."""
    from vss_tpu_torch.index.exact_build import _fast, exact_knn

    metric = Metric.parse(metric)
    n, d = vecs.shape
    dev = vecs.device
    W = cdiv(n, window)
    if W <= probes + 1:
        return exact_knn(vecs.float(), ids, C, metric)
    probes = min(probes, W)
    C = min(C, probes * window - 1)
    if progress is not None:
        progress(0, n)
    # 1. centres: a random sample of the points themselves
    rng = np.random.default_rng(seed)
    pick = torch.from_numpy(rng.choice(n, W, replace=False).astype(np.int64)).to(dev)
    centers = vecs[pick].float()
    assign = _assign_pass(vecs, centers).cpu().numpy()
    if progress is not None:
        progress(max(n // 8, 1), n)

    # 2. equal-size buckets: sort by centre id, cut into window-row slices
    # (W padded to a multiple of 8 with all-pad buckets, as the JAX package
    # does; they never enter a real bucket's probe list)
    W_pad = round_up(W, min(8, W))
    order = np.argsort(assign, kind="stable").astype(np.int64)
    order_pad = np.full(W_pad * window, -1, np.int64)
    order_pad[:n] = order
    order_t = torch.from_numpy(order_pad).to(dev)
    score_bf16 = _fast(vecs)
    # int8 inputs keep int8 windows; f32 inputs turn bf16 on the card
    xs = vecs[order_t.clamp(min=0)]
    if score_bf16 and vecs.dtype == torch.float32:
        xs = xs.to(torch.bfloat16)
    xs[order_t < 0] = 0
    win_tape = xs.reshape(W_pad, window, d)
    ids = ids.to(dev, torch.int32)
    gids = torch.where(order_t >= 0, ids[order_t.clamp(min=0)], -1).reshape(W_pad, window)

    # 3. bucket neighbour lists by centroid distance (self included);
    # all-pad buckets are pushed to +inf
    occ = (gids >= 0).sum(1)
    cents = win_tape.float().sum(1) / occ.clamp(min=1)[:, None]
    cd = (cents * cents).sum(1)
    dmat = cd[:, None] + cd[None, :] - 2.0 * (cents @ cents.T)
    dmat = torch.where((occ == 0)[None, :], _INF, dmat)
    nbr = torch.sort(dmat, dim=1, stable=True).indices[:, :probes].to(torch.int32)
    if progress is not None:
        progress(max(n // 4, 1), n)

    # 4. blocked scoring
    G = max(1, min(W_pad, _GROUP_ELEMS // (window * probes * window)))
    sd, si = _score_groups(win_tape, gids, nbr, C, metric.value, G, window, probes,
                           score_bf16=score_bf16)
    if progress is not None:
        progress(max(3 * n // 4, 1), n)

    # 5. back to the original row order
    inv = np.empty(n, np.int64)
    inv[order] = np.arange(n)
    inv_t = torch.from_numpy(inv).to(dev)
    if progress is not None:
        progress(n, n)
    return sd[inv_t], si[inv_t]
