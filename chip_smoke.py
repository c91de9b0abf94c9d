#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`vss_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of the repository

Phases, each of which fails the run (nonzero exit) on any fault:

 1. print the PyTorch version, the device and the card's name and power
    limit;
 2. build the kernels and the native graph builder from the sources under
    `vss_tpu_torch/csrc/` (one compiler process per source, all started
    together) and print the build seconds;
 3. hold each kernel (K1 gather_distances, K2 native_segmin, K3
    scan_segmin, K4 pairwise, K5 gather_rows) against its plain PyTorch
    version on the card, at the main path's shapes and at edge cases
    (sentinel ids, invalid rows, zero vectors under cosine, NaN queries,
    all three metrics, int8 / bf16 / f32 tapes, widths that need padding
    or narrow accesses), and time kernel, plain version and, where one
    exists, a single PyTorch library call for the same work. After the
    index is built, the same for the beam_search kernel (`check_beam`):
    the serving call and a grid of variants against the eager loop that
    launches K1 and K5 once per iteration, which it must equal exactly;
 4. serve the flagship: a SIFT-like synthetic corpus of 1,000,000 x 128
    (the generator of bench.py, seed 0) in an int8 index with the f32
    rerank tape, built by the native builder on all host threads, with
    2,048 queries in batches of 512. The exact oracle (`bruteforce_topk`:
    K3 at k=10, K4 at k=100) gives the ground truth; `scan_search` (K2)
    and the graph `search` at ef=64 (one beam_search launch per batch,
    K1 for the seed rescoring, K5 for the rerank gather) are scored by
    recall. Launch counters are zeroed just before each path and read
    just after it;
 5. write to the same index, with new rows from the same generator and
    cluster centres: insert 32,768 rows in waves of 1,024 (the capacity
    doubles), tombstone 20% of all rows and search through them, insert
    4,096 rows into recycled slots, compact, and search and scan again;
    then build a second index of 32,768 rows with the wave builder. Each
    step has its launch counters zeroed before and read after, its
    seconds printed and its result checked (counts, slots, recall against
    the oracle over the live rows, no deleted row returned); one
    1,024-row insert runs under the profiler for its idle share;
 6. print the kernel table as one JSON line, then
    {"ok": true, "device": {...}} as the last line.

It needs a CUDA device and the rest of the repository beside it: without
either it exits nonzero before printing any result.

Tolerances of the kernel checks: kernel and plain version take the same
inputs and differ only in the order of their f32 sums, so the largest
absolute difference must stay under 1e-5 of the magnitude of the terms
(l2sq: max |q|^2 + max |x|^2; ip: max |q| * max |x|; cosine: 1; the K2
proxy: max |x|^2 + 2 max |q| max |x| for l2sq, max |q| for cosine), and
+inf (sentinels, invalid rows, NaN distances) must sit in the same
places. K5 copies bytes: kernel and plain version must be equal bit for
bit. The beam_search kernel scores with K1's code, so on the card it
must equal the eager loop through K1 and K5 exactly (distances bit for
bit, ids, both counters). Against the eager loop on the CPU, whose
distances differ in the last digits, near-ties may order differently:
there recall@10 must agree within 0.002 and the top-10 ids for 0.99.
"""
from __future__ import annotations

import argparse
import collections
import itertools
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "f32": 67e12}
REL_TOL = 1e-5

DEVICE = "cuda"
N, D, NQ, BATCH, K, EF = 1_000_000, 128, 2048, 512, 10, 64
K_DEEP = 100  # the oracle's chunked path (K4) and recall@100
# the write path: rows inserted in waves of WAVE, rows inserted into
# recycled slots, the share of rows tombstoned, rows of the wave build
N_INSERT, N_RECYCLE, WAVE, DELETE_SHARE, N_WAVE_BUILD = 32_768, 4_096, 1024, 0.2, 32_768


def log(*a):
    print(*a, flush=True)


def fail(msg: str):
    log(f"FAIL: {msg}")
    sys.exit(1)


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of `fn` over `reps` calls after one warm-up
    call, timed with CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def bound(bytes_moved: float, ops: float, kind: str):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate of their type."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(name: str, got: torch.Tensor, want: torch.Tensor, scale: float) -> float:
    """Max |got - want| over finite entries; fails unless the infinities
    sit in the same places and the difference is under REL_TOL * scale."""
    if got.shape != want.shape:
        fail(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    fin_g, fin_w = torch.isfinite(got), torch.isfinite(want)
    if not torch.equal(fin_g, fin_w):
        fail(f"{name}: {int((fin_g != fin_w).sum())} entries finite in one version only")
    err = float((got[fin_g] - want[fin_w]).abs().max()) if bool(fin_w.any()) else 0.0
    tol = REL_TOL * scale
    log(f"  {name}: max_abs_err {err:.6g} (tol {tol:.6g})")
    if not err <= tol:
        fail(f"{name}: max_abs_err {err} over tol {tol}")
    return err


def dist_scale(q: torch.Tensor, x: torch.Tensor, metric: str) -> float:
    qn = float((q.float() ** 2).sum(-1).max())
    xn = float((x.float() ** 2).sum(-1).max())
    if metric == "l2sq":
        return qn + xn
    if metric == "ip":
        return (qn * xn) ** 0.5
    return 1.0


def proxy_scale(q: torch.Tensor, x: torch.Tensor, metric: str) -> float:
    qm = float((q.float() ** 2).sum(-1).max()) ** 0.5
    xn = float((x.float() ** 2).sum(-1).max())
    return {"l2sq": xn + 2 * qm * xn ** 0.5, "ip": qm * xn ** 0.5, "cosine": qm}[metric]


def sift_like(rng, n: int, nq: int, d: int, centers=None):
    """bench.py's SIFT-like synthetic: clustered points in [0, 255]^d.
    Returns (vectors, queries, cluster centres); given `centers`, draws
    further rows around them."""
    if centers is None:
        centers = rng.uniform(0, 255, (max(64, n // 2000), d))
    n_centers = centers.shape[0]
    vecs = np.clip(centers[rng.integers(0, n_centers, n)] + rng.normal(0, 25, (n, d)), 0, 255)
    queries = np.clip(centers[rng.integers(0, n_centers, nq)] + rng.normal(0, 25, (nq, d)), 0, 255)
    return vecs.astype(np.float32), queries.astype(np.float32), centers


# ----------------------------------------------------------------------
# phase 3: the kernels against their plain versions


def check_k1(dev, tape, q_scaled, rng):
    from vss_tpu_torch.ops import gather as g

    log("K1 gather_distances")
    # main-path shape: one beam step, 512 queries x E*m0 = 32 candidates
    ids = torch.from_numpy(rng.integers(0, N, (BATCH, 32)).astype(np.int32)).to(dev)
    ids[:, -3:] = -1  # the beam's duplicate and finished-query sentinels
    qn = (q_scaled * q_scaled).sum(-1)
    errs = {}
    for metric in ("l2sq", "cosine", "ip"):
        got = g.gather_distances(tape, ids, q_scaled, metric, qn)
        want = g._gather_distances_plain(tape, ids, q_scaled, g.Metric.parse(metric), qn)
        errs[metric] = compare(f"main int8 d=128 {metric}", got, want,
                               dist_scale(q_scaled, tape, metric))
    # edge cases: other dtypes and widths, zero rows and queries, sentinels
    for dtype, d in ((torch.float32, 128), (torch.bfloat16, 256), (torch.int8, 512),
                     (torch.int8, 100), (torch.float32, 100)):
        n = 5000
        if dtype == torch.int8:
            t = torch.from_numpy(rng.integers(-127, 128, (n, d)).astype(np.int8)).to(dev)
        else:
            t = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(dev, dtype)
        t[7] = 0
        qq = torch.from_numpy(rng.normal(size=(64, d)).astype(np.float32) * 10).to(dev)
        qq[1] = 0
        ii = torch.from_numpy(rng.integers(-1, n, (64, 40)).astype(np.int32)).to(dev)
        ii[1, :5] = 7
        for metric in ("l2sq", "cosine", "ip"):
            got = g.gather_distances(t, ii, qq, metric)
            want = g._gather_distances_plain(t, ii, qq, g.Metric.parse(metric), (qq * qq).sum(-1))
            compare(f"{str(dtype)[6:]} d={d} {metric}", got, want, dist_scale(qq, t, metric))
    # timing: 64 id sets (128 MB of rows) cycle so the rows come from HBM,
    # as each beam step's new candidates do
    id_sets = itertools.cycle(
        [torch.randint(0, N, (BATCH, 32), dtype=torch.int32, device=dev) for _ in range(64)])

    def kernel():
        g.gather_distances(tape, next(id_sets), q_scaled, "l2sq", qn)

    def plain():
        g._gather_distances_plain(tape, next(id_sets), q_scaled, g.Metric.L2SQ, qn)

    ms, plain_ms = cuda_ms(kernel, 200), cuda_ms(plain, 200)
    n_ids = BATCH * 32
    bytes_moved = n_ids * 4 + BATCH * D * 4 + BATCH * 4 + n_ids * D * tape.element_size() + n_ids * 4
    b_ms, b_by = bound(bytes_moved, n_ids * D * 4, "f32")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                max_abs_err=errs["l2sq"])


def check_k2(dev, tape, xn, valid, q_scaled, rng):
    from vss_tpu_torch.ops import scan as s

    log("K2 native_segmin")
    qb = q_scaled.to(torch.bfloat16)
    # the main-shape checks carry one query with a NaN component: its
    # sub-minima must be NaN wherever the plain version's are
    q_nan = qb.clone()
    q_nan[7, 5] = float("nan")
    clean = torch.arange(qb.shape[0], device=dev) != 7
    errs = {}

    def check(label, qq, t, tn, v, metric, scale):
        got = s.native_segmin(qq, t, tn, v, metric)
        want = s._native_segmin_plain(qq, t, tn, v, s.Metric.parse(metric))
        if not torch.equal(got.isnan(), want.isnan()):
            fail(f"K2 {label}: NaN in {int((got.isnan() != want.isnan()).sum())} other places "
                 f"than the plain version's")
        return compare(label, got, want, scale)

    for metric in ("l2sq", "cosine", "ip"):
        errs[metric] = check(f"main int8 {tape.shape[0]} x {D} {metric}, query 7 NaN", q_nan,
                             tape, xn, valid, metric, proxy_scale(qb[clean], tape, metric))
    check(f"main int8 {tape.shape[0]} x {D} l2sq, one query", qb[:1], tape, xn, valid, "l2sq",
          proxy_scale(qb[:1], tape, "l2sq"))
    for dtype, d in ((torch.bfloat16, 128), (torch.float32, 128), (torch.int8, 100),
                     (torch.int8, 960)):
        n = 70_000 + 37  # ragged: not a multiple of 128
        if dtype == torch.int8:
            t = torch.from_numpy(rng.integers(-127, 128, (n, d)).astype(np.int8)).to(dev)
        else:
            t = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(dev, dtype)
        t[11] = 0
        tn = (t.float() ** 2).sum(-1)
        v = torch.from_numpy(rng.random(n) > 0.1).to(dev)
        v[:64] = False  # a whole invalid sub-segment
        qq = torch.from_numpy(rng.normal(size=(200, d)).astype(np.float32) * 5).to(dev, torch.bfloat16)
        for metric in ("l2sq", "cosine", "ip"):
            check(f"{str(dtype)[6:]} d={d} n={n} {metric}", qq, t, tn, v, metric,
                  proxy_scale(qq, t, metric))
    ms = cuda_ms(lambda: s.native_segmin(qb, tape, xn, valid, "l2sq"), 20)
    plain_ms = cuda_ms(lambda: s._native_segmin_plain(qb, tape, xn, valid, s.Metric.L2SQ), 5)
    nx = tape.shape[0]
    ops = 2.0 * BATCH * nx * D
    bytes_moved = BATCH * D * 2 + nx * D + nx * 4 + nx + (nx // 32) * BATCH * 4
    b_ms, b_by = bound(bytes_moved, ops, "bf16")
    tflops = ops / ms / 1e9
    log(f"  main shape: kernel {ms:.4f} ms, {tflops:.1f} TFLOP/s ({ops / 1e9:.1f} GFLOP), "
        f"bound {b_ms:.4f} ms ({b_by}), plain {plain_ms:.3f} ms")
    # a batch at the GIST width, on the loop's last tape (int8, d=960: 15
    # steps of 64 columns a block against 2 at d=128): the rate of the
    # column loop itself
    q960 = torch.from_numpy(rng.normal(size=(BATCH, 960)).astype(np.float32) * 5).to(
        dev, torch.bfloat16)
    ms960 = cuda_ms(lambda: s.native_segmin(q960, t, tn, v, "l2sq"), 20)
    tflops960 = 2.0 * BATCH * t.shape[0] * 960 / ms960 / 1e9
    log(f"  {BATCH} queries x int8 {t.shape[0]} x 960: kernel {ms960:.4f} ms, "
        f"{tflops960:.1f} TFLOP/s")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                max_abs_err=errs["l2sq"], tflops=tflops, ms_d960=ms960, tflops_d960=tflops960)


def check_k3(dev, x, q, rng):
    from vss_tpu_torch.ops import topk as t3

    log("K3 scan_segmin")
    valid = torch.ones(x.shape[0], dtype=torch.bool, device=dev)
    got = t3.segmin_scan(q, x, valid, "l2sq")
    want = t3._segmin_scan_plain(q, x, valid, t3.Metric.L2SQ, True)
    err = compare(f"main f32 {x.shape[0]} x {D} l2sq", got, want, dist_scale(q, x, "l2sq"))
    del got, want
    n, d = 9000 + 77, 100
    xx = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(dev)
    xx[5] = 0
    qq = torch.from_numpy(rng.normal(size=(150, d)).astype(np.float32)).to(dev)
    qq[2] = float("nan")
    qq[3] = 0
    vv = torch.from_numpy(rng.random(n) > 0.2).to(dev)
    vv[128:256] = False  # a whole invalid segment
    for metric in ("l2sq", "cosine", "ip"):
        for highest in (True, False):
            got = t3.segmin_scan(qq, xx, vv, metric, highest)
            want = t3._segmin_scan_plain(qq, xx, vv, t3.Metric.parse(metric), highest)
            compare(f"f32 d={d} n={n} {metric} highest={highest}", got, want,
                    dist_scale(qq[4:], xx, metric))
    ms = cuda_ms(lambda: t3.segmin_scan(q, x, valid, "l2sq"), 10)
    plain_ms = cuda_ms(lambda: t3._segmin_scan_plain(q, x, valid, t3.Metric.L2SQ, True), 5)
    nx = x.shape[0]
    bytes_moved = BATCH * D * 4 + nx * D * 4 + nx + (nx // 128) * BATCH * 4
    ops = 2.0 * BATCH * nx * D + 2.0 * (BATCH + nx) * D
    b_ms, b_by = bound(bytes_moved, ops, "f32")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                max_abs_err=err)


def check_k4(dev, x, q, rng):
    from vss_tpu_torch.ops import distance as dd
    from vss_tpu_torch.ops import topk as t3

    log("K4 pairwise")
    # main-path shape: one chunk of the oracle's chunked path at k=100
    chunk = t3._choose_chunk(x.shape[0], BATCH)
    xc = x[:chunk]
    got = dd.dispatch_pairwise(q, xc, "l2sq")
    want = dd.pairwise(q, xc, "l2sq")
    err = compare(f"main f32 {BATCH} x {chunk} x 128 l2sq", got, want, dist_scale(q, xc, "l2sq"))
    del got, want
    n, d = 3001, 100  # ragged rows (scalar stores) and padded width
    xx = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(dev)
    xx[9] = 0
    qq = torch.from_numpy(rng.normal(size=(130, d)).astype(np.float32)).to(dev)
    qq[0] = 0
    for metric in ("l2sq", "cosine", "ip"):
        compare(f"f32 d={d} n={n} {metric}", dd.dispatch_pairwise(qq, xx, metric),
                dd.pairwise(qq, xx, metric), dist_scale(qq, xx, metric))
    ms = cuda_ms(lambda: dd.dispatch_pairwise(q, xc, "l2sq"), 10)
    plain_ms = cuda_ms(lambda: dd.pairwise(q, xc, "l2sq"), 5)
    # the library's pairwise distance: one cuBLAS-backed call for the same
    # product and norms (it returns the Euclidean distance, the square root
    # of K4's l2sq)
    library_ms = cuda_ms(lambda: torch.cdist(q, xc, compute_mode="use_mm_for_euclid_dist"), 5)
    bytes_moved = BATCH * D * 4 + chunk * D * 4 + BATCH * chunk * 4
    ops = 2.0 * BATCH * chunk * D + 2.0 * (BATCH + chunk) * D
    b_ms, b_by = bound(bytes_moved, ops, "f32")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=library_ms, max_abs_err=err)


def check_k5(dev, tape, rerank, adj0, rng):
    """K5 against its plain version, bit for bit. The main shapes are the
    write path's: compaction permutes the grown tapes (twice the index's
    capacity: ascending kept slots, then a tail of zeros), one wave's
    `select_neighbors` gathers W x (ef_construction + M) candidate rows,
    and a beam step gathers W x 4 adjacency rows."""
    from vss_tpu_torch.ops import gather as g

    log("K5 gather_rows")

    def same(name, table, ids, skip_neg=False):
        got = g.gather_rows(table, ids, skip_neg)
        want = g._gather_rows_plain(table, ids, skip_neg)
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype:
            fail(f"K5 {name}: {tuple(got.shape)} {got.dtype} != {tuple(want.shape)} {want.dtype}")
        diff = int((got.view(torch.uint8) != want.view(torch.uint8)).sum())
        log(f"  {name}: {diff} bytes differ")
        if diff:
            fail(f"K5 {name}: kernel and plain version differ in {diff} bytes")

    def timed(name, table, id_sets, reps):
        """(ms, plain_ms, library_ms, bound_ms, bound_by) over cycling id sets."""
        sets = itertools.cycle(id_sets)
        longs = itertools.cycle([i.clamp(min=0).reshape(-1).long() for i in id_sets])
        ms = cuda_ms(lambda: g.gather_rows(table, next(sets)), reps)
        plain_ms = cuda_ms(lambda: g._gather_rows_plain(table, next(sets)), reps)
        library_ms = cuda_ms(lambda: torch.index_select(table, 0, next(longs)), reps)
        ids = id_sets[0]
        row_bytes = table.shape[1] * table.element_size()
        # each distinct row read once, each output row and each id once
        bytes_moved = (int(torch.unique(ids.clamp(min=0)).numel()) + ids.numel()) * row_bytes \
            + ids.numel() * 4
        b_ms, b_by = bound(bytes_moved, 0, "f32")
        log(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, index_select "
            f"{library_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        return dict(shape=name, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                    bound_ms=b_ms, bound_by=b_by)

    cap = tape.shape[0]
    grown = 2 * cap
    # the grown tapes, as _ensure_capacity leaves them
    tape2 = torch.cat([tape, torch.zeros_like(tape)])
    rerank2 = torch.cat([rerank, torch.zeros_like(rerank)])
    kept = np.sort(rng.choice(cap + N_INSERT, int((cap + N_INSERT) * (1 - DELETE_SHARE)),
                              replace=False))
    perm = torch.from_numpy(
        np.concatenate([kept, np.zeros(grown - kept.size, np.int64)]).astype(np.int32)).to(dev)
    same(f"compaction int8 {grown} x {tape.shape[1]}", tape2, perm)
    same(f"compaction f32 {grown} x {rerank.shape[1]}", rerank2, perm)
    cand = [torch.randint(0, cap, (WAVE, 144), dtype=torch.int32, device=dev) for _ in range(16)]
    cand[0][:, -5:] = -1
    same(f"select_neighbors ids {WAVE} x 144 int8", tape, cand[0])
    beam = [torch.randint(-1, cap, (WAVE, 4), dtype=torch.int32, device=dev) for _ in range(64)]
    same(f"adjacency ids {WAVE} x 4 over adj0", adj0, beam[0])
    # edges
    same("negative ids clamped", tape, torch.tensor([-1, 5, -7, 0], device=dev))
    same("skip_neg zeros", rerank, torch.tensor([[3, -1], [-2, 9]], device=dev), skip_neg=True)
    same("bf16 d=128", tape[:5000].to(torch.bfloat16), cand[0] % 5000)
    t100 = torch.from_numpy(rng.integers(-127, 128, (5000, 100)).astype(np.int8)).to(dev)
    same("int8 d=100 (4-byte accesses)", t100, cand[0] % 5000)
    same("int8 d=100 from an odd storage offset (1-byte accesses)",
         t100.reshape(-1)[1:1 + 4000 * 100].reshape(4000, 100), cand[0] % 4000)
    t99 = torch.from_numpy(rng.integers(-127, 128, (3000, 99)).astype(np.int8)).to(dev)
    same("int8 d=99 (1-byte accesses)", t99, cand[0] % 3000, skip_neg=True)
    same("a single row", rerank, torch.tensor([cap - 1], device=dev))
    same("an empty id list", tape, torch.zeros((0,), dtype=torch.int32, device=dev))
    same("descending ids", tape, torch.arange(9999, -1, -1, dtype=torch.int32, device=dev))
    same("repeated ids", tape, torch.full((4096,), 77, dtype=torch.int32, device=dev))
    shapes = [
        timed(f"compaction int8 {grown} x {tape.shape[1]}", tape2, [perm], 20),
        timed(f"compaction f32 {grown} x {rerank.shape[1]}", rerank2, [perm], 10),
        timed(f"select_neighbors ids {WAVE} x 144 int8", tape, cand, 100),
        timed(f"adjacency ids {WAVE} x 4 over adj0", adj0, beam, 200),
    ]
    main = shapes[0]
    return dict(ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                bound_by=main["bound_by"], library_ms=main["library_ms"], max_abs_err=0.0,
                shapes=shapes)


def host_us_per_call(dev, tape, adj0, q_scaled) -> dict:
    """Host microseconds per call of the K1 and K5 wrappers at the shapes
    the beam used to launch them at, beside `torch.index_select`: 200
    calls on the host clock, one synchronize at their end."""
    from vss_tpu_torch.ops import gather as g

    cap = tape.shape[0]
    ids1 = torch.randint(0, cap, (BATCH, 32), dtype=torch.int32, device=dev)
    ids5 = torch.randint(0, cap, (WAVE, 4), dtype=torch.int32, device=dev)
    long5 = ids5.reshape(-1).long()
    qn = (q_scaled * q_scaled).sum(-1)

    def per_call(fn, reps=200):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e6

    # what K5's wrapper is made of: the allocation of its output, and the
    # launch through ctypes alone with the arguments ready
    out5 = torch.empty((WAVE, 4, adj0.shape[1]), dtype=adj0.dtype, device=dev)
    fn = g._K5._entry()
    stream = torch.cuda.current_stream().cuda_stream
    bare = (ids5.data_ptr(), adj0.data_ptr(), out5.data_ptr(), ids5.numel(),
            adj0.shape[1] * adj0.element_size(), 0, stream)
    out = {}
    for _ in range(2):  # the second round is the one kept
        out = {
            "gather_distances ids 512x32": per_call(
                lambda: g.gather_distances(tape, ids1, q_scaled, "l2sq", qn)),
            "gather_rows ids 1024x4 over adj0": per_call(lambda: g.gather_rows(adj0, ids5)),
            "index_select ids 4096 over adj0": per_call(
                lambda: torch.index_select(adj0, 0, long5)),
            "torch.empty of gather_rows' output": per_call(
                lambda: torch.empty((WAVE, 4, adj0.shape[1]), dtype=adj0.dtype, device=dev)),
            "gather_rows' launch through ctypes alone": per_call(lambda: fn(*bare)),
        }
    log("host us per call (200 calls, one synchronize at the end): "
        + ", ".join(f"{k} {v:.2f}" for k, v in out.items()))
    return out


def dependent_read_ns(dev) -> float:
    """Nanoseconds of one dependent read from device memory: one thread
    follows a random cycle through 64M int32 (256 MB, five times the L2
    cache) for 20,000 steps a call, each call going on where the last one
    stopped (`vss_pointer_chase` in csrc/probe.cu)."""
    import ctypes

    from vss_tpu_torch import csrc

    lib = csrc.load("probe")
    fn = lib.vss_pointer_chase
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    n, steps = 1 << 26, 20_000
    order = torch.randperm(n, device=dev)
    nxt = torch.empty(n, dtype=torch.int32, device=dev)
    nxt[order] = order.roll(-1).to(torch.int32)  # one cycle through every slot
    at = torch.zeros(1, dtype=torch.int32, device=dev)

    def chase():
        rc = fn(nxt.data_ptr(), steps, at.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if rc:
            fail(f"pointer chase: launch failed ({rc})")

    ns = cuda_ms(chase, 3) * 1e6 / steps
    log(f"dependent read from device memory: {ns:.1f} ns per step")
    return ns


def check_beam(dev, idx, q_scaled, rng) -> dict:
    """The beam_search kernel against `_beam_search_base_plain`, the eager
    loop that launches K1 and K5 once per iteration: on the card the two
    must be equal exactly. The serving call (512 queries, ef=64, E=1,
    single pool, pivot seeds, the 1M int8 tape) is timed; a grid of
    variants runs at a smaller batch."""
    from vss_tpu_torch import HNSWConfig, HNSWIndex, csrc
    from vss_tpu_torch.index import search as sr
    from vss_tpu_torch.ops import bruteforce_topk
    from vss_tpu_torch.ops.gather import gather_distances

    log("beam_search")
    read_ns = dependent_read_ns(dev)

    def same(a, b):
        if a.dtype.is_floating_point:
            return a.shape == b.shape and bool(((a == b) | (a.isnan() & b.isnan())).all())
        return torch.equal(a, b)

    def inputs(index, q, ef, E, level, seeds=None, allow=None):
        g, cfg = index.graph, index.config
        qn = (q * q).sum(-1)
        if seeds is None:
            pv_slots, pv_vecs = index.pivots()
            seeds, _ = sr.pivot_seeds(g, cfg, q, pv_slots, pv_vecs, min(4, ef), qn)
        seed_d = gather_distances(g.vectors, seeds if seeds.dim() == 2 else seeds[:, None],
                                  q, cfg.metric, qn).reshape(seeds.shape)
        allow = g.valid if allow is None else allow
        return g, cfg, q, qn, seeds, seed_d, allow, 4 + (2 * ef) // E

    def variant(label, index, q, ef, E=1, level=0, dual=False, hist=True, seeds=None,
                allow=None, cpu=False, truth_x=None):
        """Kernel == eager loop on the card, through `_beam_launch` on
        pools seeded here and through the public `beam_search_base` with
        its defaults (no query norms, max_iters=0); with `cpu`, also close
        to the all-plain loop on the CPU."""
        g, cfg, q, qn, seeds, seed_d, allow, mi = inputs(index, q, ef, E, level, seeds, allow)
        want = sr._beam_search_base_plain(g, cfg, q, seeds, seed_d, ef, allow, E, mi, level,
                                          qn, dual, hist)
        fan = cfg.m0 if level == 0 else cfg.m
        pools = sr._seed_pools(q, seeds, seed_d, ef, allow)
        got = sr._beam_launch(g, cfg, q, qn, pools, ef, allow, E, mi, level, dual, hist)
        public = sr.beam_search_base(g, cfg, q, seeds, seed_d, ef, allow, expand=E, max_iters=0,
                                     level=level, q_norms=None, dual_pool=dual, use_history=hist)
        torch.cuda.synchronize()
        for entry, out in (("_beam_launch", got), ("beam_search_base", public)):
            for name, a, b in zip(("res_d", "res_i", "cand_i"), out, want):
                if not same(a, b):
                    rows = int((~((a == b) | ((a != a) & (b != b)))).any(1).sum())
                    fail(f"beam_search {label}, {entry}: {name} differs from the eager loop in "
                         f"{rows} of {a.shape[0]} queries")
            if (int(out[3][0]), int(out[3][1])) != (int(want[3][0]), int(want[3][1])):
                fail(f"beam_search {label}, {entry}: iterations, evals "
                     f"{[int(out[3][0]), int(out[3][1])]} != {[int(want[3][0]), int(want[3][1])]}")
        if len(public[3]) != 2 or public[3][0].dim() != 0 or public[3][1].dim() != 0:
            fail(f"beam_search {label}: beam_search_base's counters are not two 0-d tensors")
        counts = [int(c) for c in got[3]]
        py = sr.beam_smem_bytes(ef, E, fan, g.vectors.shape[1], mi, dual, hist)
        line = (f"  {label}: equal to the eager loop (res_d, res_i, cand_i, iterations "
                f"{counts[0]}, evals {counts[1]}), also through beam_search_base's defaults; "
                f"{py} B shared")
        if cpu:
            gc = g.to("cpu")
            ref = sr._beam_search_base_plain(
                gc, cfg, q.cpu(), seeds.cpu(), seed_d.cpu(), ef, allow.cpu(), E, mi, level,
                qn.cpu(), dual, hist)
            _, truth = bruteforce_topk(q, truth_x, K, cfg.metric, valid_mask=allow[:truth_x.shape[0]],
                                       device=dev)
            truth = truth.cpu().numpy()
            ids_k, ids_c = got[1][:, :K].cpu().numpy(), ref[1][:, :K].numpy()
            r_k, r_c = recall(ids_k, truth), recall(ids_c, truth)
            agree = float(np.mean([len(set(a) & set(b)) / K for a, b in zip(ids_k, ids_c)]))
            line += (f"; against the CPU loop: recall@10 {r_k:.4f} vs {r_c:.4f}, top-10 id "
                     f"agreement {agree:.4f}")
            if abs(r_k - r_c) > 0.002 or agree < 0.99:
                fail(f"beam_search {label}: recall@10 {r_k} vs {r_c} on the CPU, id agreement "
                     f"{agree}")
        log(line)
        return counts

    # ---- the serving call, timed
    ef, E = EF, 1
    g, cfg, q, qn, seeds, seed_d, allow, mi = inputs(idx, q_scaled, ef, E, 0)
    counts = variant(f"serving: {BATCH} queries ef={ef} E=1 single pool int8 d={D}", idx,
                     q_scaled, ef)
    reps = 10
    times = []
    want = sr._beam_search_base_plain(g, cfg, q, seeds, seed_d, ef, allow, E, mi, 0, qn, False,
                                      True)
    err = 0.0
    for _ in range(3):
        pool_sets = [sr._seed_pools(q, seeds, seed_d, ef, allow) for _ in range(reps + 1)]
        it = iter(pool_sets)
        times.append(cuda_ms(lambda: sr._beam_launch(g, cfg, q, qn, next(it), ef, allow, E, mi, 0,
                                                     False, True), reps))
        # the pools are updated in place: the last set holds this launch's result
        got_d, got_i = pool_sets[-1][0], pool_sets[-1][1]
        if not (same(got_d, want[0]) and same(got_i, want[1])):
            fail("beam_search serving call: a timed launch differs from the eager loop")
        finite = torch.isfinite(got_d) & torch.isfinite(want[0])
        err = max(err, float((got_d - want[0])[finite].abs().max()) if bool(finite.any()) else 0.0)
    log(f"  serving call, three rounds of {reps} launches: "
        f"{', '.join(f'{t:.4f}' for t in times)} ms")
    ms = min(times)
    sr._beam_search_base_plain(g, cfg, q, seeds, seed_d, ef, allow, E, mi, 0, qn, False, True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sr._beam_search_base_plain(g, cfg, q, seeds, seed_d, ef, allow, E, mi, 0, qn, False, True)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    iters, evals, expansions = counts
    row_bytes = g.vectors.shape[1] * g.vectors.element_size()
    # bytes this run's data needs: the rows scored, the adjacency rows of
    # the expanded nodes, the queries and norms, the pools in and out
    bytes_moved = evals * row_bytes + expansions * cfg.m0 * 4 + BATCH * (D * 4 + 4) \
        + 2 * BATCH * ef * 8
    b_ms, b_by = bound(bytes_moved, 4.0 * evals * D, "f32")
    floor_ms = iters * 2 * read_ns / 1e6
    log(f"  serving call: kernel {ms:.4f} ms, largest |res_d - eager loop's| {err}, eager loop "
        f"{plain_ms:.3f} ms wall, bound "
        f"{b_ms:.5f} ms ({b_by}: {bytes_moved} B), dependent-read floor {floor_ms:.4f} ms "
        f"({iters} iterations x 2 reads x {read_ns:.0f} ns)")

    # ---- the construction call: one wave's base-level beam
    wq = q_scaled.repeat(2, 1)[:WAVE] + 0.25
    cg, ccfg, cq, cqn, cseeds, cseed_d, callow, cmi = inputs(idx, wq, cfg.ef_construction, 4, 0)
    c_iters, c_evals, c_expansions = variant(
        f"construction: {WAVE} queries ef={cfg.ef_construction} E=4 single pool", idx, wq,
        cfg.ef_construction, E=4)
    pool_sets = iter([sr._seed_pools(cq, cseeds, cseed_d, cfg.ef_construction, callow)
                      for _ in range(6)])
    wave_ms = cuda_ms(lambda: sr._beam_launch(cg, ccfg, cq, cqn, next(pool_sets),
                                              cfg.ef_construction, callow, 4, cmi, 0, False, True), 5)
    c_bytes = c_evals * row_bytes + c_expansions * cfg.m0 * 4 + WAVE * (D * 4 + 4) \
        + 2 * WAVE * cfg.ef_construction * 8
    cb_ms, cb_by = bound(c_bytes, 4.0 * c_evals * D, "f32")
    c_floor_ms = c_iters * 2 * read_ns / 1e6
    log(f"  construction call: kernel {wave_ms:.4f} ms, bound {cb_ms:.5f} ms ({cb_by}: "
        f"{c_bytes} B; {c_iters} iterations, {c_evals} rows scored, {c_expansions} nodes "
        f"expanded), dependent-read floor {c_floor_ms:.4f} ms")

    # ---- the grid at a smaller batch, on the 1M index
    qs = q_scaled[:64].contiguous()
    blocked = idx.graph.valid & torch.from_numpy(rng.random(idx.capacity) > 0.2).to(dev)
    tape_f32 = idx.graph.vectors[:idx.count].float()
    variant("dual pool, 20% of allow false", idx, qs, EF, dual=True, allow=blocked, cpu=True,
            truth_x=tape_f32)
    del tape_f32
    variant("no history", idx, qs, EF, hist=False)
    variant("dual pool, no history, E=2", idx, qs, EF, E=2, dual=True, hist=False, allow=blocked)
    variant("E=2", idx, qs, EF, E=2)
    variant("E=4", idx, qs, EF, E=4)
    variant("ef=16", idx, qs, 16)
    variant("ef=512 dual pool", idx, qs, 512, dual=True, allow=blocked)
    upper = torch.nonzero(idx.graph.levels >= 1)[:, 0].to(torch.int32)
    lvl_seeds = upper[torch.from_numpy(rng.integers(0, upper.numel(), 64)).to(dev)]
    variant("level 1 over upper_adj, [B] seeds, E=4 ef=128", idx, qs, 128, E=4, level=1,
            seeds=lvl_seeds)
    variant("level 1, dual pool, E=1", idx, qs, 32, level=1, dual=True, seeds=lvl_seeds,
            allow=blocked)
    q_nan = qs.clone()
    q_nan[3, 7] = float("nan")
    variant("a query with a NaN component", idx, q_nan, EF, dual=True, allow=blocked)
    pv_slots, pv_vecs = idx.pivots()
    some, _ = sr.pivot_seeds(idx.graph, idx.config, qs, pv_slots, pv_vecs, 4, (qs * qs).sum(-1))
    some[5] = -1
    some[6, 1:] = -1
    variant("an empty seed row", idx, qs, EF, seeds=some)

    # ---- other tapes and metrics, a few thousand rows each
    for storage, metric, d in (("bf16", "l2sq", 128), ("f32", "cosine", 96), ("f32", "ip", 128),
                               ("f32", "l2sq", 100), ("int8", "cosine", 128)):
        n = 4096
        sv = rng.normal(size=(n, d)).astype(np.float32)
        sq = torch.from_numpy(rng.normal(size=(64, d)).astype(np.float32)).to(dev)
        small = HNSWIndex.build(sv, HNSWConfig(dims=d, metric=metric, storage_dtype=storage,
                                               rerank="none"), method="native", device=dev)
        sq = sq / small.vector_scale
        tx = small.graph.vectors[:n].float()
        variant(f"{storage} tape {n} x {d} {metric}", small, sq, 32, dual=True, cpu=True,
                truth_x=tx)
        variant(f"{storage} tape {n} x {d} {metric} E=2 single pool", small, sq, 32, E=2)

    # ---- a shape that does not fit a block's shared memory raises
    before = csrc.KERNELS["beam_search"].launches
    try:
        sr.beam_search_base(idx.graph, idx.config, qs, some, torch.zeros_like(some, dtype=torch.float32),
                            20_000, idx.graph.valid)
    except ValueError as e:
        log(f"  ef=20000 raises ValueError: {e}")
    else:
        fail("beam_search: ef=20000 did not raise")
    if csrc.KERNELS["beam_search"].launches != before:
        fail("beam_search: the refused shape was launched")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                max_abs_err=err, dependent_read_ns=read_ns, dependent_read_floor_ms=floor_ms,
                iterations=iters, evals=evals, expansions=expansions, ms_rounds=times,
                construction_ms=wave_ms, construction_bound_ms=cb_ms,
                construction_dependent_read_floor_ms=c_floor_ms,
                construction_counts=[c_iters, c_evals, c_expansions])


# ----------------------------------------------------------------------
# phase 4: the main path


def recall(got: np.ndarray, truth: np.ndarray) -> float:
    k = truth.shape[1]
    hits = sum(len(set(g[:k]) & set(t)) for g, t in zip(got, truth))
    return hits / (truth.shape[0] * k)


def timed_batches(fn, queries):
    """Run fn over the query batches; returns (stacked outputs, ms per
    batch from the host clock, each batch ending in a synchronize)."""
    outs, times = [], []
    for s in range(0, queries.shape[0], BATCH):
        t0 = time.perf_counter()
        out = fn(queries[s:s + BATCH])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        outs.append(out)
    return [torch.cat(parts).cpu().numpy() for parts in zip(*outs)], times


def profile_batch(label: str, fn, qb, wall_ms: float, out_dir: str) -> dict:
    """One batch of `fn` under torch.profiler. From the exported trace:
    the number of kernels, the device-busy time (the sum of kernel
    durations: one stream, so they do not overlap) and the kernels that
    take most of it. The idle share is taken against the unprofiled
    ms/batch `wall_ms`."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn(qb)
        torch.cuda.synchronize()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "trace_" + re.sub(r"\W+", "_", label).strip("_") + ".json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        kernels = [e for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"]
    busy_ms = sum(e["dur"] for e in kernels) / 1e3
    by_name = collections.Counter()
    for e in kernels:
        by_name[e["name"][:48]] += e["dur"] / 1e3
    top = [[n, round(ms, 4)] for n, ms in by_name.most_common(5)]
    if not kernels:
        log(f"profile {label}: the trace holds no kernels; device busy time not measured")
        return {"kernels": 0}
    log(f"profile {label}: {len(kernels)} kernels, device busy {busy_ms:.3f} ms of "
        f"{wall_ms:.3f} ms/batch, idle share {1 - busy_ms / wall_ms:.3f}; top {top}")
    return {"kernels": len(kernels), "busy_ms": busy_ms, "idle_share": 1 - busy_ms / wall_ms,
            "top_ms": top}


def write_path(seed, idx, dev, smi, vecs, x, q_all, centers, launches, out_dir) -> dict:
    """Phase 5: insert, delete, insert into recycled slots, compact and a
    wave build, each step timed on the host clock (ending in a
    synchronize) with its own launch counts, which are also added to
    `launches`. Fails the run on any check."""
    from vss_tpu_torch import HNSWIndex, csrc
    from vss_tpu_torch.ops import bruteforce_topk

    n0 = idx.count
    cap0 = idx.capacity
    wrng = np.random.default_rng(seed + 2)
    new_vecs, _, _ = sift_like(wrng, N_INSERT + N_RECYCLE, 0, D, centers)
    x_all = torch.cat([x, torch.from_numpy(new_vecs).to(dev)])
    steps = {}

    def step(label, fn):
        csrc.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = {k: v.launches for k, v in csrc.KERNELS.items()}
        for k, v in counts.items():
            launches[k] += v
        steps[label] = {"seconds": seconds, "launches": counts}
        log(f"{label}: {seconds:.3f} s, launches {counts}")
        return out, seconds

    def search_all(fn):
        """fn over the query batches -> (dists, rowids) as numpy."""
        outs = [fn(q_all[s:s + BATCH]) for s in range(0, q_all.shape[0], BATCH)]
        return [torch.cat(parts).cpu().numpy() for parts in zip(*outs)]

    def live_truth(live_mask):
        """The exact top-K over the live rows; rowid == row of x_all."""
        valid = torch.from_numpy(live_mask).to(dev)
        return search_all(lambda qb: bruteforce_topk(
            qb, x_all[:live_mask.size], K, "l2sq", valid_mask=valid, device=dev))[1]

    def check_rows(label, rows, live_mask):
        if rows.shape != (q_all.shape[0], K) or (rows < 0).any() or (rows >= live_mask.size).any():
            fail(f"{label}: rowids of shape {rows.shape} or out of range")
        if not live_mask[rows].all():
            fail(f"{label}: {int((~live_mask[rows]).sum())} returned rowids are deleted rows")

    # 1. insert N_INSERT rows in waves of WAVE: the capacity doubles
    _, ins_s = step(f"insert {N_INSERT} rows", lambda: idx.insert(
        new_vecs[:N_INSERT], np.arange(n0, n0 + N_INSERT)))
    n1 = n0 + N_INSERT
    if idx.count != n1 or idx.next_slot != n1 or idx.capacity != 2 * cap0:
        fail(f"after insert: count {idx.count}, next_slot {idx.next_slot}, capacity "
             f"{idx.capacity}; expected {n1}, {n1}, {2 * cap0}")
    probe = wrng.choice(N_INSERT, min(NQ, N_INSERT), replace=False)
    _, found = idx.search(new_vecs[probe], 1, ef=EF)
    self_hit = float((found[:, 0].cpu().numpy() == n0 + probe).mean())
    log(f"insert: {N_INSERT / ins_s:.1f} rows/s, {ins_s / (N_INSERT / WAVE):.3f} s per wave of "
        f"{WAVE}; capacity {cap0} -> {idx.capacity}; search(k=1, ef={EF}) of {probe.size} "
        f"inserted vectors returns the row itself for {self_hit:.4f}")
    if self_hit < 0.95:
        fail(f"only {self_hit} of the inserted rows find themselves")
    for kname in ("gather_rows", "gather_distances", "beam_search"):
        if steps[f"insert {N_INSERT} rows"]["launches"][kname] <= 0:
            fail(f"kernel {kname} was not launched by the insert step")

    # 2. tombstone a share of all rows; search through the tombstones
    gone = wrng.choice(n1, int(n1 * DELETE_SHARE), replace=False)
    n_gone, _ = step(f"delete {gone.size} rows", lambda: idx.delete(gone))
    live = np.ones(n1, bool)
    live[gone] = False
    if n_gone != gone.size or idx.count != n1 - gone.size or idx.deleted_count != gone.size:
        fail(f"after delete: deleted {n_gone}, count {idx.count}, tombstones {idx.deleted_count}")
    (_, del_rows), _ = step("search with tombstones", lambda: search_all(
        lambda qb: idx.search(qb, K, ef=EF)))
    check_rows("search with tombstones", del_rows, live)
    r_deleted = recall(del_rows, live_truth(live))
    log(f"recall@10 search ef={EF} with {gone.size} tombstones {r_deleted:.4f}")
    if r_deleted < 0.85:
        fail(f"recall@10 with tombstones {r_deleted} < 0.85")

    # 3. insert into recycled slots
    _, rec_s = step(f"insert {N_RECYCLE} rows into recycled slots", lambda: idx.insert(
        new_vecs[N_INSERT:], np.arange(n1, n1 + N_RECYCLE)))
    if idx.next_slot != n1 or idx.deleted_count != gone.size - N_RECYCLE:
        fail(f"after the recycling insert: next_slot {idx.next_slot} (expected {n1}), "
             f"tombstones {idx.deleted_count} (expected {gone.size - N_RECYCLE})")
    live = np.concatenate([live, np.ones(N_RECYCLE, bool)])

    # 4. compact
    _, compact_s = step("compact", idx.compact)
    if idx.deleted_count != 0 or idx.next_slot != idx.count or idx.free_slots != [] \
            or idx.count != int(live.sum()):
        fail(f"after compact: tombstones {idx.deleted_count}, next_slot {idx.next_slot}, "
             f"count {idx.count} (expected {int(live.sum())}), {len(idx.free_slots)} free slots")
    if steps["compact"]["launches"]["gather_rows"] <= 0:
        fail("kernel gather_rows was not launched by the compact step")
    truth = live_truth(live)
    (_, c_rows), _ = step("search after compact", lambda: search_all(
        lambda qb: idx.search(qb, K, ef=EF)))
    (_, s_rows), _ = step("scan_search after compact", lambda: search_all(
        lambda qb: idx.scan_search(qb, K)))
    check_rows("search after compact", c_rows, live)
    check_rows("scan_search after compact", s_rows, live)
    r_compact, r_compact_scan = recall(c_rows, truth), recall(s_rows, truth)
    log(f"after compact: recall@10 search ef={EF} {r_compact:.4f}, scan_search "
        f"{r_compact_scan:.4f}, {idx.count} rows")
    if r_compact < 0.85:
        fail(f"recall@10 after compact {r_compact} < 0.85")
    if r_compact_scan < 0.99:
        fail(f"scan recall@10 after compact {r_compact_scan} < 0.99")

    # where the time of a wave goes: one WAVE-row insert into a clone (the
    # clone shares the tensors and insert writes to its own copy)
    wave_rows = vecs[:WAVE] + 1.0
    clone = idx.clone()
    prof = profile_batch(f"insert {WAVE} rows", lambda rows: clone.insert(
        rows, np.arange(2 * n1, 2 * n1 + WAVE)), wave_rows, ins_s / (N_INSERT / WAVE) * 1e3,
        out_dir)
    del clone

    # 5. a wave build
    nb = min(N_WAVE_BUILD, vecs.shape[0])
    built, wave_s = step(f"wave build of {nb} rows", lambda: HNSWIndex.build(
        vecs[:nb], idx.config, method="wave", wave_size=WAVE, device=dev))
    if built.count != nb:
        fail(f"the wave build holds {built.count} rows, expected {nb}")
    _, w_rows = search_all(lambda qb: built.search(qb, K, ef=EF))
    w_truth = search_all(lambda qb: bruteforce_topk(qb, x[:nb], K, "l2sq", device=dev))[1]
    r_wave = recall(w_rows, w_truth)
    log(f"wave build: {nb / wave_s:.1f} rows/s, recall@10 search ef={EF} {r_wave:.4f}")
    if r_wave < 0.9:
        fail(f"recall@10 of the wave-built index {r_wave} < 0.9")
    for kname in ("gather_distances", "beam_search"):
        if steps[f"wave build of {nb} rows"]["launches"][kname] <= 0:
            fail(f"kernel {kname} was not launched by the wave build")
    return {
        "card": smi, "steps": steps,
        "insert": {"rows": N_INSERT, "wave": WAVE, "rows_per_s": N_INSERT / ins_s,
                   "self_hit_at_1": self_hit, "capacity": [cap0, 2 * cap0]},
        "delete": {"rows": int(gone.size), "recall_at_10_with_tombstones": r_deleted},
        "recycle": {"rows": N_RECYCLE, "rows_per_s": N_RECYCLE / rec_s},
        "compact": {"seconds": compact_s, "rows": int(live.sum()),
                    "recall_at_10": r_compact, "scan_recall_at_10": r_compact_scan},
        "wave_build": {"rows": nb, "seconds": wave_s, "recall_at_10": r_wave},
        "profile_insert_wave": prof,
    }


def k2_only(dev, vecs, queries, smi, krng) -> int:
    """`--k2-only`: check_k2 on the corpus quantized as the int8 index
    quantizes it, with the index's capacity of rows (the last 8 invalid),
    and without the graph build."""
    scale = float(np.abs(vecs).max()) / 127.0
    cap = N + 8
    tape = torch.zeros((cap, D), dtype=torch.int8, device=dev)
    tape[:N] = torch.from_numpy(vecs).to(dev).div_(scale).round_().to(torch.int8)
    xn = (tape.float() ** 2).sum(-1)
    valid = torch.arange(cap, device=dev) < N
    q_scaled = (torch.from_numpy(queries[:BATCH]).to(dev) / scale).contiguous()
    result = check_k2(dev, tape, xn, valid, q_scaled, krng)
    log(smi)
    log(json.dumps({"native_segmin": result}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace-dir", default=None,
                    help="where the profiler traces go (default: vss_tpu_torch/_build/traces)")
    ap.add_argument("--k2-only", action="store_true",
                    help="build K2 alone and run its checks and timing (check_k2) on a "
                         "synthetic 1,000,008 x 128 int8 tape, without the index build; "
                         "prints K2's entry and no result line")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from vss_tpu_torch import HNSWConfig, HNSWIndex, csrc
    from vss_tpu_torch.ops import bruteforce_topk

    dev = torch.device(DEVICE)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {name} "
        f"count {torch.cuda.device_count()}")
    log(f"nvidia-smi: {smi}")
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        fail("TF32 is on; the exact paths need full f32 products")

    # ---- phase 2: build
    libs = ["scan"] if args.k2_only else sorted(csrc.SOURCES)
    log(f"build: {csrc.build(libs):.2f} s for {libs}")
    for lib in libs:
        path = os.path.join(csrc.BUILD_DIR, f"{lib}.log")
        if os.path.exists(path):
            for line in open(path).read().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  ptxas {lib}: {line.strip()}")

    # ---- data (set-up): bench.py's SIFT-like generator
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    vecs, queries, centers = sift_like(rng, N, NQ, D)
    log(f"data: {N} x {D} corpus, {NQ} queries in {time.perf_counter() - t0:.1f} s")
    if args.k2_only:
        return k2_only(dev, vecs, queries, smi, np.random.default_rng(args.seed + 1))

    # ---- build the index (host threads) before the kernel checks, which
    # use its tapes
    cfg = HNSWConfig(dims=D, metric="l2sq", storage_dtype="int8")
    t0 = time.perf_counter()
    idx = HNSWIndex.build(vecs, cfg, method="native", device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    log(f"native build: {build_s:.1f} s ({N / build_s:.0f} rows/s), M={cfg.m} "
        f"ef_construction={cfg.ef_construction}, capacity {idx.capacity}")
    if idx.count != N:
        fail(f"index holds {idx.count} rows, expected {N}")

    x = torch.from_numpy(vecs).to(dev)
    q_all = torch.from_numpy(queries).to(dev)
    q = q_all[:BATCH].contiguous()
    q_scaled = (q / idx.vector_scale).contiguous()

    # ---- phase 3: kernels against their plain versions
    krng = np.random.default_rng(args.seed + 1)
    results = {
        "gather_distances": check_k1(dev, idx.graph.vectors, q_scaled, krng),
        "native_segmin": check_k2(dev, idx.graph.vectors, idx.norms(), idx.graph.valid,
                                  q_scaled, krng),
        "scan_segmin": check_k3(dev, x, q, krng),
        "pairwise": check_k4(dev, x, q, krng),
        "gather_rows": check_k5(dev, idx.graph.vectors, idx.rerank_tape, idx.graph.adj0, krng),
        "beam_search": check_beam(dev, idx, q_scaled, krng),
    }
    host_us = host_us_per_call(dev, idx.graph.vectors, idx.graph.adj0, q_scaled)
    torch.cuda.synchronize()

    # ---- phase 4: the main path, each sub-path with the counts zeroed
    # just before it and read just after
    # warm-up: one batch of each serving path (allocator, first launches)
    idx.scan_search(q, K)
    idx.search(q, K, ef=EF)
    torch.cuda.synchronize()
    launches = {k: 0 for k in csrc.KERNELS}
    per_path = {}

    def run_path(label, fn):
        csrc.reset_launch_counts()
        out, times = timed_batches(fn, q_all)
        counts = {k: v.launches for k, v in csrc.KERNELS.items()}
        per_path[label] = counts
        for k, v in counts.items():
            launches[k] += v
        ms = sum(times) / len(times)
        log(f"{label}: {ms:.3f} ms/batch of {BATCH} (batches {[round(t, 3) for t in times]}), "
            f"{NQ / (sum(times) / 1e3):.1f} qps, launches {counts}")
        return out, ms

    (gt_d, gt_i), gt_ms = run_path(
        "oracle k=10", lambda qb: bruteforce_topk(qb, x, K, "l2sq", device=dev))
    (gt100_d, gt100_i), gt100_ms = run_path(
        "oracle k=100", lambda qb: bruteforce_topk(qb, x, K_DEEP, "l2sq", device=dev))
    (sc_d, sc_i), scan_ms = run_path("scan_search k=10", lambda qb: idx.scan_search(qb, K))
    (sc100_d, sc100_i), scan100_ms = run_path(
        "scan_search k=100", lambda qb: idx.scan_search(qb, K_DEEP))
    (gr_d, gr_i), graph_ms = run_path(
        f"search k=10 ef={EF}", lambda qb: idx.search(qb, K, ef=EF))

    # ---- checks of what came out
    for label, (dd, ii, k) in {
        "oracle k=10": (gt_d, gt_i, K), "oracle k=100": (gt100_d, gt100_i, K_DEEP),
        "scan k=10": (sc_d, sc_i, K), "scan k=100": (sc100_d, sc100_i, K_DEEP),
        "graph k=10": (gr_d, gr_i, K),
    }.items():
        if dd.shape != (NQ, k) or ii.shape != (NQ, k):
            fail(f"{label}: shapes {dd.shape} {ii.shape}")
        if not np.isfinite(dd).all() or (ii < 0).any() or (ii >= N).any():
            fail(f"{label}: non-finite distances or ids out of range")
        if (np.diff(dd, axis=1) < 0).any():
            fail(f"{label}: distances not ascending")
    # two independent exact paths (K3 winnow, K4 chunks) agree
    agree = recall(gt100_i[:, :K], gt_i)
    log(f"oracle k=10 (K3) vs first 10 of k=100 (K4): id agreement {agree:.6f}")
    if agree < 0.999:
        fail("the two oracle paths disagree")
    # reference distances on a small input: 64 queries in float64 on the host
    ref = ((vecs[gt_i[:64, 0]].astype(np.float64) - queries[:64].astype(np.float64)) ** 2).sum(1)
    rel = float(np.abs(gt_d[:64, 0] - ref).max() / ref.max())
    log(f"oracle top-1 distance vs float64 host reference: max rel err {rel:.3g}")
    if rel > 1e-4:
        fail("oracle distances disagree with the float64 reference")
    same = sc_i[:, 0] == gt_i[:, 0]
    scan_rel = float(np.abs(sc_d[same, 0] - gt_d[same, 0]).max() / gt_d[same, 0].max())
    log(f"scan top-1 distance vs oracle where ids agree: max rel err {scan_rel:.3g}")
    if scan_rel > 1e-4:
        fail("scan distances disagree with the oracle")

    r_scan, r_scan100 = recall(sc_i, gt_i), recall(sc100_i, gt100_i)
    r_graph = recall(gr_i, gt_i)
    log(f"recall@10 scan_search {r_scan:.4f}; recall@100 scan_search {r_scan100:.4f}; "
        f"recall@10 search ef={EF} {r_graph:.4f}")
    # where the time goes: one batch of each serving path under the profiler
    out_dir = args.trace_dir or os.path.join(csrc.BUILD_DIR, "traces")
    profiles = {
        "scan": profile_batch("scan_search k=10", lambda qb: idx.scan_search(qb, K), q,
                              scan_ms, out_dir),
        "graph": profile_batch(f"search k=10 ef={EF}", lambda qb: idx.search(qb, K, ef=EF), q,
                               graph_ms, out_dir),
    }
    summary = {
        "card": smi, "n": N, "d": D, "queries": NQ, "batch": BATCH,
        "build_s": round(build_s, 3),
        "scan": {"ms_per_batch": scan_ms, "qps": BATCH / scan_ms * 1e3, "recall_at_10": r_scan},
        "scan_k100": {"ms_per_batch": scan100_ms, "qps": BATCH / scan100_ms * 1e3,
                      "recall_at_100": r_scan100},
        "graph": {"ef": EF, "ms_per_batch": graph_ms, "qps": BATCH / graph_ms * 1e3,
                  "recall_at_10": r_graph},
        "oracle_ms_per_batch": {"k10": gt_ms, "k100": gt100_ms},
        "launches_per_path": per_path,
        "profiles": profiles,
        "host_us_per_call": host_us,
    }
    log("main path: " + json.dumps(summary))
    if r_scan < 0.99:
        fail(f"scan recall@10 {r_scan} < 0.99")
    if r_graph < 0.85:
        fail(f"graph recall@10 {r_graph} < 0.85")
    graph_path = f"search k=10 ef={EF}"
    needed = {"scan_segmin": ["oracle k=10"], "pairwise": ["oracle k=100"],
              "native_segmin": ["scan_search k=10"], "beam_search": [graph_path],
              # the seed rescoring and the rerank gather of the graph search
              "gather_distances": [graph_path], "gather_rows": [graph_path]}
    for kname, labels in needed.items():
        for label in labels:
            if per_path[label][kname] <= 0:
                fail(f"kernel {kname} was not launched on the path '{label}'")
    log(f"{graph_path}, {NQ // BATCH} batches: beam_search launched "
        f"{per_path[graph_path]['beam_search']} times, gather_distances "
        f"{per_path[graph_path]['gather_distances']}, gather_rows "
        f"{per_path[graph_path]['gather_rows']}")

    # ---- phase 5: the write path, on the same index
    write = write_path(args.seed, idx, dev, smi, vecs, x, q_all, centers, launches, out_dir)
    log("write path: " + json.dumps(write))

    # ---- phase 6: the kernel table and the last line
    meta = {
        "gather_distances": ("vss_tpu_torch/csrc/gather.cu", "vss_tpu/ops/gather.py:142"),
        "native_segmin": ("vss_tpu_torch/csrc/scan.cu", "vss_tpu/ops/scan.py:78"),
        "scan_segmin": ("vss_tpu_torch/csrc/topk.cu", "vss_tpu/ops/topk.py:134"),
        "pairwise": ("vss_tpu_torch/csrc/distance.cu", "vss_tpu/ops/distance.py:113"),
        "gather_rows": ("vss_tpu_torch/csrc/gather.cu", "vss_tpu/ops/gather.py:39"),
        "beam_search": ("vss_tpu_torch/csrc/beam.cu",
                        "vss_tpu/ops/gather.py:142 and :39 inside the loop of "
                        "vss_tpu/index/search.py:442"),
    }
    table = [
        {"name": kname, "route": "cuda", "source": meta[kname][0], "replaces": meta[kname][1],
         "launches": launches[kname], **results[kname]}
        for kname in ("gather_distances", "native_segmin", "scan_segmin", "pairwise",
                      "gather_rows", "beam_search")
    ]
    log(smi)
    log(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
