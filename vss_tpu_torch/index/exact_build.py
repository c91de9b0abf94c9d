"""Bulk construction: kNN candidate lists + batched refine + back-links.

Reproduces `vss_tpu/index/exact_build.py`. Construction is three
data-parallel passes that do not touch the graph being built (no insertion
order, no waves):

  1. candidates: for every node, its top-C nearest nodes: exact by tiled
     brute force (`exact_knn`), locality-blocked (`ivf_candidates`, with
     NN-descent rounds or a scan pass where its lists fail a sampled
     check), or through the serving scan (`scan_candidates`, kernel K2);
  2. refine: the select-neighbors heuristic (`index/select.py`, kernel K5
     for its candidate rows) on each node's list -> forward adjacency;
  3. back-links: reverse edges merged under the degree cap, with heuristic
     re-selection on overflow.

Upper levels use the same recipe on the level subsets; a connectivity
repair (`index/repair.py`) bridges what the kNN edges left unreachable.

What differs from the JAX package:
  * `lax.approx_min_k` is an exact top-k (what the JAX package runs off the
    TPU), so the `approx` flags are gone;
  * the JAX package's TPU branches (`use_pallas()`) are the CUDA branches
    here: distance products of bf16-rounded inputs summed in f32 (an
    explicit cast, TF32 stays off) and a bf16 distance buffer; CPU tensors
    take the JAX package's CPU branch, f32 throughout;
  * `jit`, donation, `fori_loop`, `lax.map`, the pow2 shape buckets, the
    eager chunks and their relay lag are gone: the passes are Python loops
    over row chunks, sized for an 80 GB card, whose results do not depend
    on the chunk sizes (no pad row is processed, so the scatter sinks stay
    untouched);
  * the `VSS_*` environment switches are keyword arguments of
    `build_graph_exact` with the JAX package's defaults, and the debug
    marks go to `logging`.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Optional

import numpy as np
import torch

from vss_tpu_torch.index.build import plan_wave_rows
from vss_tpu_torch.index.graph import (
    HNSWConfig,
    HNSWGraph,
    cast_to_tape,
    empty_graph,
    sample_levels,
)
from vss_tpu_torch.index.search import _dedupe_keep_first
from vss_tpu_torch.index.select import select_neighbors
from vss_tpu_torch.ops.distance import Metric, _epilogue, gathered_distances
from vss_tpu_torch.ops.gather import gather_rows
from vss_tpu_torch.ops.topk import _sort_min_k
from vss_tpu_torch.utils import resolve_device, round_up

__all__ = ["build_graph_exact", "exact_knn", "scan_candidates"]

_INF = float("inf")
_IMAX = 2**31 - 1
_LOG = logging.getLogger(__name__)

# gathered candidate values (f32 elements) one refine / back-link chunk may
# hold: 2^28 is 1 GiB, small against the H100's 80 GB
_CHUNK_ELEMS = 1 << 28


def _fast(t: torch.Tensor) -> bool:
    """The JAX package's TPU branch (`use_pallas()`): taken on the card."""
    return t.device.type == "cuda"


def _rows_per_chunk(C: int, d: int) -> int:
    """Rows of a refine / back-link chunk: its [rows, C, d] gathered
    candidates and [rows, C, C] distances within _CHUNK_ELEMS."""
    return max(256, _CHUNK_ELEMS // (C * max(d, C)))


def _min_k(d: torch.Tensor, k: int):
    """The k smallest along dim 1 and their positions: a stable sort on
    the CPU (ties to the lower position, as `lax.top_k`), `torch.topk` on
    the card, where the JAX package takes the approximate top-k."""
    if _fast(d):
        vals, pos = torch.topk(d, k, dim=1, largest=False, sorted=True)
        return vals, pos.to(torch.int32)
    return _sort_min_k(d, k)


def _bf16_dots(a, b):
    """a @ b^T over the last two dims ([m, d] x [n, d], or batched [g, m,
    d] x [g, n, d]) of bf16-rounded inputs, summed in f32, as f32: the JAX
    package's DEFAULT-precision product. On the card a tensor-core product
    with an f32 result (`out_dtype`; TF32 stays off); on the CPU the same
    rounded values in an f32 product."""
    a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16).transpose(-1, -2)
    if a.device.type == "cuda":
        mm = torch.mm if a.dim() == 2 else torch.bmm
        return mm(a16, b16, out_dtype=torch.float32)
    return a16.float() @ b16.float()


def _dist_tile(q, x, metric: Metric, fast: bool):
    """[bq, d] x [tx, d] -> [bq, tx] distances. `fast`: the products of
    bf16-rounded inputs, summed in f32 (the JAX package's DEFAULT precision
    on the TPU: candidate ordering is all construction needs); else f32."""
    dots = _bf16_dots(q, x) if fast else q @ x.T
    qn = (q * q).sum(-1, keepdim=True)
    xn = (x * x).sum(-1)[None, :]
    return _epilogue(dots, qn, xn, metric)


def _knn_all(q, q_ids, x, C: int, metric: Metric, tile: int, block: int, fast: bool,
             dist_bf16: bool):
    """Top-C neighbours of every row of `q` [nq, d] over the rows of `x`
    [nx, d], excluding self-matches (x row index == q_ids entry). Query blocks by database tiles: a product per tile, the
    tile's top-C, then an exact stable merge with the running best (as
    `lax.sort` with num_keys=1: the running best first on ties).
    dist_bf16 keeps the distance buffer in bf16. Returns (dists [nq, C]
    ascending f32, ids [nq, C] i32, -1 padded)."""
    nq = q.shape[0]
    dev = q.device
    dd = torch.bfloat16 if dist_bf16 else torch.float32
    out_d = torch.full((nq, C), _INF, device=dev)
    out_i = torch.full((nq, C), -1, dtype=torch.int32, device=dev)
    for b0 in range(0, nq, block):
        qb = q[b0:b0 + block]
        ib = q_ids[b0:b0 + block]
        best_d = torch.full((qb.shape[0], C), _INF, dtype=dd, device=dev)
        best_i = torch.full((qb.shape[0], C), -1, dtype=torch.int32, device=dev)
        for t0 in range(0, x.shape[0], tile):
            xt = x[t0:t0 + tile]
            w = xt.shape[0]
            d = _dist_tile(qb, xt, metric, fast).to(dd)
            cols = torch.arange(w, dtype=torch.int32, device=dev)[None, :]
            d = torch.where(cols == (ib - t0)[:, None], _INF, d)
            td, tp = _min_k(d, min(C, w))
            cat_d = torch.cat([best_d, td], 1)
            cat_i = torch.cat([best_i, tp + t0], 1)
            cat_d, order = torch.sort(cat_d, dim=1, stable=True)
            best_d = cat_d[:, :C]
            best_i = cat_i.gather(1, order[:, :C])
        bd = best_d.float()
        out_d[b0:b0 + block] = bd
        out_i[b0:b0 + block] = torch.where(torch.isfinite(bd), best_i, -1)
    return out_d, out_i


def exact_knn(
    vecs: torch.Tensor,
    ids: torch.Tensor,
    C: int,
    metric,
    *,
    block: int = 2048,
    tile: int = 65536,
    fast_matmul: bool = True,
    dist_bf16: Optional[bool] = None,
    progress: Optional[Callable[[int, int], None]] = None,
):
    """Exact top-C neighbour lists for every row of `vecs` [n, d] against
    all rows (self excluded). `ids` [n] are the global ids reported (and
    matched for self-exclusion). Returns (dists [n, C], ids [n, C]) on the
    device of `vecs`. `fast_matmul` takes bf16-rounded products on the
    card (f32 on the CPU); `dist_bf16` defaults to on the card."""
    metric = Metric.parse(metric)
    vecs = vecs.float()
    fast = fast_matmul and _fast(vecs)
    if dist_bf16 is None:
        dist_bf16 = fast
    n = vecs.shape[0]
    C = min(C, max(n - 1, 1))
    tile = min(tile, round_up(n, 512))
    block = min(block, round_up(n, 256))
    ids = ids.to(vecs.device, torch.int32)
    if progress is not None:
        progress(0, n)
    parts_d, parts_i = [], []
    # query chunks of several blocks, with progress after each
    step = 8 * block
    for s in range(0, n, step):
        pd, pi = _knn_all(vecs[s:s + step], ids[s:s + step], vecs, C, metric, tile, block, fast,
                          dist_bf16)
        parts_d.append(pd)
        parts_i.append(pi)
        if progress is not None:
            progress(min(s + step, n), n)
    return torch.cat(parts_d), torch.cat(parts_i)


def _refine_forward(adj, vectors, cand_d, cand_i, node_slots, config: HNSWConfig, cap: int):
    """The select-neighbors heuristic on every node's candidate list, in
    row chunks; writes the nodes' rows of `adj` (width >= cap, -1
    padded) in place."""
    A = cand_i.shape[0]
    chunk = _rows_per_chunk(cand_i.shape[1], vectors.shape[1])
    pad_w = adj.shape[1] - cap
    for s in range(0, A, chunk):
        sl = node_slots[s:s + chunk]
        qv = vectors[sl.long()].float()
        chosen = select_neighbors(qv, cand_i[s:s + chunk], cand_d[s:s + chunk], vectors, cap,
                                  config.metric)
        if pad_w:
            chosen = torch.cat([chosen, chosen.new_full((chosen.shape[0], pad_w), -1)], 1)
        adj[sl.long()] = chosen


def _upper_select(sd, si_local, mslots, tape_f32, config: HNSWConfig):
    """Map an upper level's subset-local kNN lists to global slots and run
    the refine heuristic, in member chunks."""
    A, C = si_local.shape
    chunk = _rows_per_chunk(C, tape_f32.shape[1])
    out = []
    for s in range(0, A, chunk):
        sl = si_local[s:s + chunk]
        si = torch.where(sl >= 0, mslots[sl.clamp(min=0).long()], -1)
        qv = tape_f32[mslots[s:s + chunk].long()]
        out.append(select_neighbors(qv, si, sd[s:s + chunk], tape_f32, config.m, config.metric))
    return torch.cat(out)


def _upper_level_pass(tape_f32, mslots, rows_idx, upper_adj, config: HNSWConfig, tile: int,
                      block: int, chunk: int):
    """One whole upper level: subset gather -> kNN -> refine-select ->
    forward scatter -> reverse-edge grouping -> back-link merge. mslots
    [A] are the level's members, ascending; rows_idx [A] their upper_adj
    rows. Updates `upper_adj` in place."""
    A = mslots.shape[0]
    sub = tape_f32[mslots.long()]
    pos = torch.arange(A, dtype=torch.int32, device=sub.device)
    fast = _fast(sub)
    # the JAX package asks for C = 2m whatever A is; missing neighbours are
    # -1 / inf
    sd, si_local = _knn_all(sub, pos, sub, 2 * config.m, Metric.parse(config.metric),
                            min(tile, round_up(A, 256)), min(block, round_up(A, 256)), fast,
                            fast)
    chosen = _upper_select(sd, si_local, mslots, tape_f32, config)
    upper_adj[rows_idx.long()] = chosen
    incoming = _group_incoming_local(mslots, chosen)
    _merge_backlinks(upper_adj, rows_idx, tape_f32, incoming, mslots, config, config.m, chunk)


_INCOMING_CAP = 16  # reverse-edge fan-in accepted per target (one pass)


def _group_incoming(node_slots, forward, cap_rows: int, cap: int = _INCOMING_CAP):
    """Group reverse edges by target: incoming [cap_rows, cap] i32 (-1
    padded), where incoming[t] lists up to `cap` sources that chose slot t
    as a forward neighbour, in edge order. One stable sort of all A*m
    edges. Also used by index/repair.py and index/nn_descent.py."""
    A, m = forward.shape
    E = A * m
    dev = forward.device
    src = node_slots.to(torch.int32).repeat_interleave(m)
    tgt = forward.reshape(-1)
    tgt_s = torch.where(tgt >= 0, tgt, _IMAX)
    iota = torch.arange(E, dtype=torch.int32, device=dev)
    sorted_t, perm = torch.sort(tgt_s, stable=True)
    src_sorted = src[perm]
    seg_start = torch.ones(E, dtype=torch.bool, device=dev)
    seg_start[1:] = sorted_t[1:] != sorted_t[:-1]
    first_idx = torch.cummax(torch.where(seg_start, iota, 0), 0).values
    rank = iota - first_idx
    ok = (sorted_t != _IMAX) & (rank < cap)
    incoming = torch.full((cap_rows + 1, cap), -1, dtype=torch.int32, device=dev)
    # edges past the cap and absent targets all land on the dropped row
    incoming[torch.where(ok, sorted_t, cap_rows).long(), torch.where(ok, rank, 0).long()] = (
        torch.where(ok, src_sorted, -1))
    return incoming[:cap_rows]


def _merge_backlinks(adj, adj_rows, vectors, incoming, node_slots, config: HNSWConfig, cap: int,
                     chunk: int):
    """Per-target merge of (existing forward links + incoming reverse
    edges) under the degree cap: distance-sorted append when the union
    fits, heuristic re-selection on overflow. adj: the layer's adjacency
    (rows `adj_rows`), updated in place; node_slots: the targets' slots;
    vectors: the f32 tape. Whole-row gathers go through kernel K5."""
    A = node_slots.shape[0]
    pad_w = adj.shape[1] - cap
    for s in range(0, A, chunk):
        rows_i = adj_rows[s:s + chunk]
        sl = node_slots[s:s + chunk]
        exist = gather_rows(adj, rows_i)[:, :cap]
        cand_i = _dedupe_keep_first(torch.cat([exist, incoming[s:s + chunk]], 1))
        tv = vectors[sl.long()].float()
        cv = gather_rows(vectors, cand_i)
        cand_d = gathered_distances(tv, cv, config.metric)
        cand_d = torch.where(cand_i >= 0, cand_d, _INF)
        overflow = (cand_i >= 0).sum(1) > cap
        chosen_h = select_neighbors(tv, cand_i, cand_d, vectors, cap, config.metric,
                                    active=overflow, cand_vecs=cv)
        top, pos = _sort_min_k(cand_d, cap)
        chosen_s = torch.where(torch.isfinite(top), cand_i.gather(1, pos.long()), -1)
        rows = torch.where(overflow[:, None], chosen_h, chosen_s)
        if pad_w:
            rows = torch.cat([rows, rows.new_full((rows.shape[0], pad_w), -1)], 1)
        adj[rows_i.long()] = rows


def _group_incoming_local(node_slots, forward, cap: int = _INCOMING_CAP):
    """`_group_incoming` in the level-local id space: node_slots [A] must
    be sorted ascending. Targets outside the level are dropped."""
    A, m = forward.shape
    tgt = forward.reshape(-1)
    loc = torch.searchsorted(node_slots, tgt.clamp(min=0).to(node_slots.dtype))
    hit = (tgt >= 0) & (loc < A) & (node_slots[loc.clamp(max=A - 1)] == tgt)
    local_fwd = torch.where(hit, loc, -1).reshape(A, m).to(torch.int32)
    return _group_incoming(node_slots, local_fwd, A, cap)


def _backlink_pass(graph: HNSWGraph, config: HNSWConfig, node_slots, adj_rows, forward,
                   tape_f32, lev: int, chunk: int) -> None:
    """Back-links of one layer (0: adj0, else upper_adj), in place.
    node_slots [A] are the targets == sources, ascending."""
    adj = graph.adj0 if lev == 0 else graph.upper_adj
    cap = config.m0 if lev == 0 else config.m
    incoming = _group_incoming_local(node_slots, forward)
    _merge_backlinks(adj, adj_rows, tape_f32, incoming, node_slots, config, cap, chunk)


# past this row count 'auto' switches the base-layer candidate pass off
# the n^2 exact sweep (its top-C selection width grows with n): to the
# IVF pass with a sampled check and the scan pass where the lists fail it
# ('hybrid', on the card, where K2 is the scan), or to the IVF pass with
# NN-descent rounds ('ivf', on the CPU, the JAX package's CPU branch)
_IVF_AUTO_MIN_N = 131_072


def scan_candidates(
    xv: torch.Tensor,
    tape: torch.Tensor,
    valid: torch.Tensor,
    x_norms: torch.Tensor,
    C: int,
    metric,
    *,
    batch: int = 8192,
    keep_margin: int = 16,
    progress: Optional[Callable[[int, int], None]] = None,
):
    """Near-exact top-C candidate lists for every row through the serving
    scan (`ops/scan.scan_topk`, phase A on kernel K2): segment-minima
    winnow, block rescore, f32 rerank against `xv`. keep = C + keep_margin
    sub-segments (not the serving 2C): a tail candidate can miss when more
    than keep_margin of the true top-C share crowded segments, which
    candidate lists tolerate (refine and back-links re-score).

    xv [n, d] f32 queries (scaled units); tape [n', d] the stored tape.
    Returns (dists [n, C] ascending f32, ids [n, C] i32, self as -1). C
    is capped at SCAN_K_MAX."""
    from vss_tpu_torch.ops.scan import SCAN_K_MAX, scan_topk

    metric = Metric.parse(metric)
    n = xv.shape[0]
    C = min(C, SCAN_K_MAX, max(n - 1, 1))
    parts_d, parts_i = [], []
    for s in range(0, n, batch):
        q = xv[s:s + batch]
        bd, bi = scan_topk(q, tape, C, metric, valid_mask=valid, x_norms=x_norms,
                           rerank_tape=xv, keep=C + keep_margin, device=xv.device)
        # drop self-matches (each row is its own nearest): refine treats
        # interior -1s as absent
        self_ids = s + torch.arange(q.shape[0], dtype=torch.int32, device=xv.device)
        parts_d.append(bd)
        parts_i.append(torch.where(bi == self_ids[:, None], -1, bi))
        if progress is not None:
            progress(min(s + batch, n), n)
    return torch.cat(parts_d), torch.cat(parts_i)


def build_graph_exact(
    vectors,
    config: HNSWConfig,
    *,
    seed: int = 0,
    rowids: Optional[np.ndarray] = None,
    capacity: Optional[int] = None,
    candidates: Optional[int] = None,
    block: int = 2048,
    tile: int = 65536,
    backlink_chunk: Optional[int] = None,
    candidate_mode: str = "auto",
    recall_bar: float = 0.60,
    nn_descent: bool = True,
    nn_descent_rounds: int = 6,
    want_rerank: bool = False,
    prescale: float = 1.0,
    progress: Optional[Callable[[int, int], None]] = None,
    device=None,
    stats: Optional[dict] = None,
):
    """Bulk-build an HNSW graph from kNN candidate lists on `device` (CUDA
    unless "cpu" is passed).

    Returns (graph, upper_rows_used), or (graph, upper_rows_used,
    rerank_tape) with `want_rerank=True`: the full-precision side tape,
    built from the f32 copy this function already holds on the device.
    `vectors` [n, d] (numpy or a tensor) arrive UNSCALED: `prescale`
    divides them on the way to the tape (the int8 scale). Deterministic
    given `seed` (level sampling, IVF centres and the recall sample are
    numpy draws from it).

    `candidates` is C, the neighbour-list length refined down to the
    degree caps (default: 2*m0, at least m0+8). `candidate_mode`: 'exact'
    (n^2 top-C), 'ivf' (locality-blocked, then NN-descent rounds when
    `nn_descent`, at most `nn_descent_rounds`), 'hybrid' (IVF, then the
    scan pass where the sampled list recall@10 falls below `recall_bar`),
    'scan', or 'auto': 'exact' below _IVF_AUTO_MIN_N rows, else 'hybrid'
    on the card and 'ivf' on the CPU. Upper levels always use the exact
    pass. `stats`, when given, receives the mode taken, the sampled
    recall and whether the scan fallback ran.
    """
    dev = resolve_device(device)
    if isinstance(vectors, torch.Tensor):
        xv = vectors.detach().to(dev, torch.float32)
    else:
        xv = torch.from_numpy(np.ascontiguousarray(vectors, np.float32)).to(dev)
    n, d = xv.shape
    if d != config.dims:
        raise ValueError(f"vectors have {d} columns, config.dims is {config.dims}")
    levels = sample_levels(n, config, seed)
    capacity = max(capacity or 0, n + 8)
    urows, next_row = plan_wave_rows(levels, 0, config.max_levels)
    upper_cap = next_row + 64 + 1
    graph = empty_graph(config, capacity, upper_cap, device=dev)
    if rowids is None:
        rowids = np.arange(n, dtype=np.int32)
    rowids = np.asarray(rowids, np.int64).astype(np.int32)
    stats = {} if stats is None else stats
    if n == 0:
        return graph, 0
    t_start = time.perf_counter()

    def mark(label):
        if _LOG.isEnabledFor(logging.DEBUG):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            _LOG.debug("%s: %.1f s", label, time.perf_counter() - t_start)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    # the divide by the int8 scale happens inside the tape cast
    graph.vectors[:n] = cast_to_tape(xv / prescale if prescale != 1.0 else xv, config)
    graph.levels[:n] = t(levels)
    graph.upper_row[:n] = t(urows[:n])
    graph.valid[:n] = True
    graph.slot_to_rowid[:n] = t(rowids)
    graph = dataclasses.replace(
        graph,
        entry=torch.tensor(int(np.argmax(levels)), dtype=torch.int32, device=dev),
        max_level=torch.tensor(int(levels.max()), dtype=torch.int32, device=dev),
        count=torch.tensor(n, dtype=torch.int32, device=dev),
    )
    slots = torch.arange(n, dtype=torch.int32, device=dev)
    quantized = config.storage_dtype != "f32"
    metric = Metric.parse(config.metric)

    def xv_scoring():
        # what search sees: the stored values, in f32
        return graph.vectors[:n].float() if quantized else xv

    C0 = candidates or max(2 * config.m0, config.m0 + 8)
    total_units = 2 * n
    done_units = [0]

    def knn_prog(done, total):
        if progress is not None:
            progress(min(done_units[0] + done // 2, total_units), total_units)

    # ---- base layer
    from vss_tpu_torch.ops.scan import SCAN_K_MAX, native_scan_supported

    scan_ok = _fast(xv) and native_scan_supported(graph.vectors.dtype)
    mode = candidate_mode
    if mode == "auto":
        if n < _IVF_AUTO_MIN_N:
            mode = "exact"
        elif scan_ok:
            mode = "hybrid"
        else:
            mode = "ivf"
    if mode not in ("exact", "ivf", "hybrid", "scan"):
        raise ValueError(f"unknown candidate_mode '{candidate_mode}'")
    stats["mode"] = mode

    def scan_pass():
        xvs = xv_scoring()
        return scan_candidates(
            xvs, graph.vectors[:n], torch.ones((n,), dtype=torch.bool, device=dev),
            (xvs * xvs).sum(1), min(C0, SCAN_K_MAX), metric, progress=knn_prog)

    if mode == "scan":
        cand_d, cand_i = scan_pass()
    elif mode in ("ivf", "hybrid"):
        from vss_tpu_torch.index.ivf_candidates import ivf_candidates

        # the storage tape feeds the IVF pass directly: only candidate
        # ordering survives it
        cand_d, cand_i = ivf_candidates(
            graph.vectors[:n] if quantized else xv, slots, C0, metric, seed=seed + 1,
            progress=knn_prog)
        if mode == "hybrid":
            from vss_tpu_torch.index.nn_descent import sampled_list_recall

            if quantized and scan_ok:
                # the oracle over the storage tape through the scan (K2)
                rec, _, _ = sampled_list_recall(graph.vectors[:n], cand_i, metric,
                                                seed=seed + 2, use_scan=True)
            else:
                rec, _, _ = sampled_list_recall(xv_scoring(), cand_i, metric, seed=seed + 2)
            stats["ivf_sampled_recall"] = rec
            mark(f"ivf sampled recall@10={rec:.3f}")
            # clustered corpora sample ~0.8 and serve well from these
            # lists; flat ones sample ~0.05-0.3 and take the scan pass
            stats["scan_fallback"] = rec < recall_bar
            if rec < recall_bar:
                cand_d, cand_i = scan_pass()
                mark("scan fallback")
        elif nn_descent:
            from vss_tpu_torch.index.nn_descent import nn_descent_refine

            cand_d, cand_i = nn_descent_refine(
                xv_scoring(), cand_d, cand_i, metric, max_rounds=nn_descent_rounds,
                seed=seed + 2)
            mark("nn-descent")
    else:
        cand_d, cand_i = exact_knn(xv_scoring(), slots, C0, metric, block=block, tile=tile,
                                   progress=knn_prog)
    mark(f"candidates ({mode})")
    done_units[0] = n
    tape_f32 = graph.vectors.float()
    _refine_forward(graph.adj0, tape_f32, cand_d, cand_i, slots, config, config.m0)
    del cand_d, cand_i
    mark("refine")
    chunk = backlink_chunk or _rows_per_chunk(config.m0 + _INCOMING_CAP, d)
    _backlink_pass(graph, config, slots, slots, graph.adj0[:n].clone(), tape_f32, 0, chunk)
    mark("backlinks")
    done_units[0] = int(1.5 * n)
    if progress is not None:
        progress(done_units[0], total_units)

    # ---- upper levels
    urows_t = t(urows)
    for lev in range(1, int(levels.max()) + 1):
        member = np.nonzero(levels >= lev)[0]
        if member.size <= 1:
            break
        mslots = t(member.astype(np.int32))
        _upper_level_pass(tape_f32, mslots, urows_t[mslots.long(), lev - 1], graph.upper_adj,
                          config, tile, block, backlink_chunk or _rows_per_chunk(2 * config.m, d))
        mark(f"level {lev} ({member.size} nodes)")

    # ---- connectivity repair: a pure-kNN edge set can leave whole
    # clusters unreachable from the entry (see index/repair.py)
    from vss_tpu_torch.index.repair import repair_connectivity

    del tape_f32
    graph, bridged = repair_connectivity(graph, config)
    stats["bridged"] = bridged
    mark("repair")
    if progress is not None:
        progress(total_units, total_units)
    if want_rerank:
        rr = config.rerank_dtype
        rtape = None
        if rr is not None:
            rtape = torch.zeros((graph.capacity, d), dtype=rr, device=dev)
            rtape[:n] = (xv / prescale if prescale != 1.0 else xv).to(rr)
        return graph, next_row, rtape
    return graph, next_row
