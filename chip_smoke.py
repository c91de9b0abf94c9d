#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`vss_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of the repository
    python3 chip_smoke.py --gist     # and the 1,000,000 x 960 cosine arm
    python3 chip_smoke.py --sharded-only   # phase 8 (the sharded index) alone

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
    launches K1 and K5 once per iteration, which it must equal exactly,
    in both of its layouts (pools in shared memory; pools in a per-query
    workspace in device memory, at ef 8,161 and 16,384 and forced at the
    serving shape) and with more neighbour slots a step than a block has
    threads; then the greedy_descent kernel (`check_descent`) against the
    eager loop that launches K5 and K1 once per step, which it must equal
    exactly, at the insert wave's shape (1,024 queries, stop levels drawn
    as a wave's) and the serving shape (512 queries, stop 0) on the 1M
    graph, and at edge cases on small bf16 and f32 graphs (per-query
    stops, step caps, ties, a NaN row and a NaN query, -1 padding, a graph
    of one level, an empty graph). K1, K5 and the descent kernel are timed
    by their device time from the profiler's trace, since their wrappers
    take longer on the host than the kernels on the card;
 4. build and serve the flagship: a SIFT-like synthetic corpus of
    1,000,000 x 128 (the generator of bench.py, seed 0) in an int8 index
    with the f32 rerank tape, built by `HNSWIndex.build` with `auto` (on
    the card the exact bulk builder in its hybrid mode: IVF candidate
    lists, a sampled check through the scan, K2, refine and back-links
    through K5, the connectivity repair), with 2,048 queries in batches
    of 512. The exact oracle (`bruteforce_topk`:
    K3 at k=10, K4 at k=100) gives the ground truth; `scan_search` (K2)
    and the graph `search` at ef=64 (one beam_search launch per batch,
    K1 for the seed rescoring, K5 for the rerank gather) are scored by
    recall. Launch counters are zeroed just before each path and read
    just after it. Then the forward call of `vss_tpu_torch.entry.entry()`
    (64 queries, k=10, ef=64 over a host-built 1,024-row graph: one
    descent launch and one beam_search launch a call) with its ms, its
    launches and its idle share;
 5. write to the same index, with new rows from the same generator and
    cluster centres: insert 32,768 rows in waves of 1,024 (the capacity
    doubles), tombstone 20% of all rows and search through them, insert
    4,096 rows into recycled slots, compact, and search and scan again;
    then build a second index of 32,768 rows with the wave builder. Each
    step has its launch counters zeroed before and read after, its
    seconds printed and its result checked (counts, slots, recall against
    the oracle over the live rows, no deleted row returned; every insert
    step launches the descent kernel, and the insert step no K1); one
    1,024-row insert runs under the profiler for its idle share;
 6. the builders: native (every host core), wave and exact over the
    first 131,071 rows of the corpus, each with its seconds and recall@10
    at ef=64; the iid arm of bench.py (standard normal x 50, seed 7) at
    262,144 x 128, m=48, built with `auto`, where the IVF lists fail their
    sampled check and the scan pass (K2) makes the candidate lists, with
    recall@10 at ef 512 and 768, the descent kernel against the eager
    loop on its m=48 upper rows, and K2 timed at the build's shape; with
    `--gist`, bench.py's 1,000,000 x 960 cosine arm, made on the card;
 7. the Database (`vss_tpu_torch.Database` on the card), driven through
    SQL at the flagship's width: the 1,000,000 x 128 corpus in a table,
    `CREATE INDEX ... USING HNSW ... storage='int8'`, 64 single-query
    statements through HNSW_INDEX_SCAN and `min_by`, equal to
    `index.search`; the 2,048-query LATERAL join through HNSW_INDEX_JOIN,
    equal to the batched `index.search`, recall@10 >= 0.85, timed and
    profiled; the same joins on an un-indexed copy (BRUTE_FORCE_TOPK,
    `knn_join` at k=10 through K3 and at k=100 through K4, `vss_join`),
    equal to the oracle; the cost model's rates measured by `calibrate()`
    and its choices, its exact scan (K2) at recall@10 >= 0.99 on the
    first 65,536 rows; `DELETE ... WHERE id % 5 = 0` and `PRAGMA
    hnsw_compact_index` (K5), with no deleted row returned; `CHECKPOINT`
    to a `.vssdb` file and `Database.open`, with the join's ids and
    distances bit-equal; the WAL: 1,024 inserts and 1,000 deletes, the
    database dropped without a checkpoint and reopened, every insert
    found at k=1 and no delete returned;
 8. the sharded index (`vss_tpu_torch.parallel`) on 4 slots of the one
    card, at the flagship's width: the 1,000,000 x 128 int8 corpus built
    with `ShardedHNSWIndex.build` (`auto`: the bulk builder per shard),
    the 2,048 queries through `search` (k=10, ef=64, with the per-shard ef
    and with the full beam), `scan_search` and a filter mask that allows
    half the rows, scored against phase 4's oracle and the filtered
    oracle; the per-shard counters; insert 32,768 rows, delete `id % 5 =
    0`, compact; a forced rebalance at 65,536 rows; save and load,
    bit-equal; a `Database` with a sharded index (SQL equal to the direct
    calls, a `.vssdb` CHECKPOINT and Database.open, bit-equal, and `CREATE
    INDEX ... WITH (sharded = TRUE)` on 65,536 rows); two processes of 2
    slots each over gloo (NCCL refuses two ranks on one GPU), equal to
    one process; `dryrun_multichip` over the visible cards;
 9. print the kernel table as one JSON line, then
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
bit, ids, both counters); so must the greedy_descent kernel (the node
reached, its distance bit for bit, its three counters). Against the eager
loop on the CPU, whose
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
# the builders compared (native, wave, exact) over this many rows of the
# corpus: the exact builder's exact candidate pass runs below 131,072
N_BUILDERS = 131_071
# the iid arm: rows, its ef ladder; the scan pass's query batch; the
# 960-d arm's rows (`--gist`)
N_IID, IID_EFS, SCAN_BATCH, N_GIST = 262_144, (512, 768), 8192, 1_000_000
# recall@10 at ef=64 of the 1M index built by the native builder (PR 5's
# runs on the same corpus), beside which the auto build's is printed
NATIVE_RECALL = 0.9618
# rows of the small graphs on which check_beam runs the wide layout's
# deep-ef and many-slot variants
N_BEAM_SMALL = 6000
# the Database phase: single-query SQL statements timed, the rows of the
# corpus on which the cost model must pick the exact scan, and the rows
# inserted and deleted under the WAL
N_SQL_SCAN, N_COST_SMALL, N_WAL_INSERT, N_WAL_DELETE = 64, 65_536, 1024, 1000
# rows of the corpus `calibrate()` measures its rates on
N_CALIBRATE = 1 << 18
# the sharded phase: slots on the one card, rows of the multi-process run
# and of the SQL `CREATE INDEX ... WITH (sharded = TRUE)`, rows of the
# forced rebalance, each rank's time limit
SHARDS, N_MP, N_REBALANCE, MP_TIMEOUT_S = 4, 65_536, 65_536, 300


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


def check_k1(dev, tape, q_scaled, rng, out_dir):
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
    # as each beam step's new candidates do. The kernel's time is its device
    # time from the profiler's trace: the wrapper's host time a call is
    # longer than the kernel, so CUDA events around a run of calls measure
    # the host's launch rate (kept beside it as `event_ms`)
    def timed(C, reps=200):
        sets = itertools.cycle(
            [torch.randint(0, N, (BATCH, C), dtype=torch.int32, device=dev) for _ in range(64)])
        ms = device_ms(lambda: g.gather_distances(tape, next(sets), q_scaled, "l2sq", qn), reps,
                       "gather_dist_kernel", out_dir)
        event_ms = cuda_ms(lambda: g.gather_distances(tape, next(sets), q_scaled, "l2sq", qn),
                           reps)
        plain_ms = cuda_ms(lambda: g._gather_distances_plain(
            tape, next(sets), q_scaled, g.Metric.L2SQ, qn), reps)
        n_ids = BATCH * C
        bytes_moved = n_ids * 4 + BATCH * D * 4 + BATCH * 4 + n_ids * D * tape.element_size() \
            + n_ids * 4
        b_ms, b_by = bound(bytes_moved, n_ids * D * 4, "f32")
        log(f"  ids {BATCH}x{C}: kernel {ms:.5f} ms device time ({event_ms:.4f} ms between CUDA "
            f"events around {reps} wrapper calls), plain {plain_ms:.4f} ms, bound {b_ms:.5f} ms "
            f"({b_by})")
        return dict(shape=f"ids {BATCH}x{C}", ms=ms, event_ms=event_ms, plain_ms=plain_ms,
                    bound_ms=b_ms, bound_by=b_by)

    # one beam step's candidates, and the seed rescoring of `search` (4 seeds)
    shapes = [timed(32), timed(4)]
    main = shapes[0]
    return dict(ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                bound_by=main["bound_by"], library_ms=None, max_abs_err=errs["l2sq"],
                shapes=shapes)


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


def check_k5(dev, tape, rerank, adj0, rng, out_dir):
    """K5 against its plain version, bit for bit. The main shapes are the
    write path's: compaction permutes the grown tapes (twice the index's
    capacity: ascending kept slots, then a tail of zeros), one wave's
    `select_neighbors` gathers W x (ef_construction + M) candidate rows,
    and a beam step gathers W x 4 adjacency rows. Each shape is timed
    between CUDA events and by the kernel's device time."""
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
        """(ms, device_ms, plain_ms, library_ms, bound_ms, bound_by) over
        cycling id sets: `ms` between CUDA events around the run of calls,
        `device_ms` the kernel's own device time from the profiler."""
        sets = itertools.cycle(id_sets)
        longs = itertools.cycle([i.clamp(min=0).reshape(-1).long() for i in id_sets])
        ms = cuda_ms(lambda: g.gather_rows(table, next(sets)), reps)
        dev_ms = device_ms(lambda: g.gather_rows(table, next(sets)), reps, "gather_rows_kernel",
                           out_dir)
        plain_ms = cuda_ms(lambda: g._gather_rows_plain(table, next(sets)), reps)
        library_ms = cuda_ms(lambda: torch.index_select(table, 0, next(longs)), reps)
        ids = id_sets[0]
        row_bytes = table.shape[1] * table.element_size()
        # each distinct row read once, each output row and each id once
        bytes_moved = (int(torch.unique(ids.clamp(min=0)).numel()) + ids.numel()) * row_bytes \
            + ids.numel() * 4
        b_ms, b_by = bound(bytes_moved, 0, "f32")
        log(f"  {name}: kernel {ms:.4f} ms ({dev_ms:.5f} ms device time), plain "
            f"{plain_ms:.4f} ms, index_select {library_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
        return dict(shape=name, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                    library_ms=library_ms, bound_ms=b_ms, bound_by=b_by)

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
    from vss_tpu_torch import HNSWConfig, HNSWIndex
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
                allow=None, cpu=False, truth_x=None, wide=False):
        """Kernel == eager loop on the card, through `_beam_launch` on
        pools seeded here (`wide` forces the wide layout) and through the
        public `beam_search_base` with its defaults (no query norms,
        max_iters=0), which picks the layout from the shape; with `cpu`,
        also close to the all-plain loop on the CPU."""
        g, cfg, q, qn, seeds, seed_d, allow, mi = inputs(index, q, ef, E, level, seeds, allow)
        want = sr._beam_search_base_plain(g, cfg, q, seeds, seed_d, ef, allow, E, mi, level,
                                          qn, dual, hist)
        fan = cfg.m0 if level == 0 else cfg.m
        pools = sr._seed_pools(q, seeds, seed_d, ef, allow)
        got = sr._beam_launch(g, cfg, q, qn, pools, ef, allow, E, mi, level, dual, hist,
                              _wide=wide)
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
        sizes = (ef, E, fan, g.vectors.shape[1], mi, dual, hist)
        py = sr.beam_smem_bytes(*sizes)
        if wide or py > sr._BEAM_MAX_SMEM:
            layout = (f"wide layout: {sr.beam_smem_bytes(*sizes, wide=True)} B shared, "
                      f"{sr.beam_pool_bytes(*sizes)} B of workspace a query")
        else:
            layout = f"{py} B shared"
        line = (f"  {label}: equal to the eager loop (res_d, res_i, cand_i, iterations "
                f"{counts[0]}, evals {counts[1]}), also through beam_search_base's defaults; "
                f"{layout}")
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

    # ---- the wide layout: pools in a per-query workspace in device memory,
    # where a block's shared memory cannot hold them (ef 8,161 with two
    # pools, 16,384 with one), or forced; and more neighbour slots a step
    # than a block has threads (E * m0 = 1,152: over 1,024, and over the
    # 256 threads a block runs at most)
    def launch_ms(g, cfg, q, qn, seeds, seed_d, ef, allow, E, mi, dual, wide, reps):
        sets = iter([sr._seed_pools(q, seeds, seed_d, ef, allow) for _ in range(reps + 1)])
        return cuda_ms(lambda: sr._beam_launch(g, cfg, q, qn, next(sets), ef, allow, E, mi, 0,
                                               dual, True, _wide=wide), reps)

    variant("serving shape, wide layout forced", idx, q_scaled, EF, wide=True)
    wide_serving_ms = launch_ms(g, cfg, q, qn, seeds, seed_d, ef, allow, E, mi, False, True, reps)
    shared_again_ms = launch_ms(g, cfg, q, qn, seeds, seed_d, ef, allow, E, mi, False, False, reps)
    log(f"  serving call, {reps} launches each: wide layout {wide_serving_ms:.4f} ms, shared "
        f"layout {shared_again_ms:.4f} ms")
    n_small = N_BEAM_SMALL
    sv = rng.normal(size=(n_small, D)).astype(np.float32)
    small = HNSWIndex.build(sv, HNSWConfig(dims=D, storage_dtype="int8"), method="native",
                            device=dev)
    sq = torch.from_numpy(rng.normal(size=(16, D)).astype(np.float32)).to(dev) / small.vector_scale
    s_allow = small.graph.valid & torch.from_numpy(rng.random(small.capacity) > 0.2).to(dev)
    wide_ms = {}
    for ef_w, dual in ((8161, True), (16384, False)):
        variant(f"{n_small} rows, ef={ef_w} {'dual' if dual else 'single'} pool", small, sq, ef_w,
                dual=dual, allow=s_allow if dual else None)
        wg, wcfg, wq, wqn, wseeds, wseed_d, wallow, wmi = inputs(
            small, sq, ef_w, 1, 0, allow=s_allow if dual else None)
        wide_ms[ef_w] = launch_ms(wg, wcfg, wq, wqn, wseeds, wseed_d, ef_w, wallow, 1, wmi, dual,
                                  False, 3)
        log(f"  {n_small} rows, 16 queries, ef={ef_w}: kernel {wide_ms[ef_w]:.3f} ms (wide layout)")
    sv64 = rng.normal(size=(N_BEAM_SMALL, 64)).astype(np.float32)
    m64 = HNSWIndex.build(sv64, HNSWConfig(dims=64, m=64, rerank="none"), method="native",
                          device=dev)
    q64 = torch.from_numpy(rng.normal(size=(16, 64)).astype(np.float32)).to(dev)
    seeds64 = torch.from_numpy(rng.integers(0, N_BEAM_SMALL, (16, 4)).astype(np.int32)).to(dev)
    for wide in (False, True):
        variant(f"m0=128, E=9: 1,152 neighbour slots a step{', wide layout' if wide else ''}",
                m64, q64, 64, E=9, dual=True, seeds=seeds64, wide=wide)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                max_abs_err=err, dependent_read_ns=read_ns, dependent_read_floor_ms=floor_ms,
                iterations=iters, evals=evals, expansions=expansions, ms_rounds=times,
                construction_ms=wave_ms, construction_bound_ms=cb_ms,
                construction_dependent_read_floor_ms=c_floor_ms,
                construction_counts=[c_iters, c_evals, c_expansions],
                wide_serving_ms=wide_serving_ms, shared_serving_ms_same_timing=shared_again_ms,
                wide_ms_small_graph={str(k): v for k, v in wide_ms.items()})


def bit_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal floats to the last bit (-0 differs from +0), any NaN equal to
    any NaN."""
    return a.shape == b.shape and bool(
        ((a.view(torch.int32) == b.view(torch.int32)) | (a.isnan() & b.isnan())).all())


# Two ways torch.profiler's trace lost kernels on the H100, both at the
# start of a traced run. (1) It puts each kernel on the host's clock through
# an offset it estimates for the card; once that came out 3.5 ms early, and
# the kernels of the run's first milliseconds fell before the profiler's
# window. (2) Later in a long process every trace lacked the kernels of
# its first 1-17 launches (the first 0.6-1.6 ms of launches), though the
# runtime's launch records were there. So a traced run waits
# TRACE_MARGIN_S on the host, makes TRACE_WARM_LAUNCHES throwaway launches
# over a few milliseconds, and only then runs what it measures, inside a
# marked span; the trace is read within that span alone.
TRACE_MARGIN_S = 0.1
TRACE_WARM_LAUNCHES = 32


def traced(fn, out_dir: str, name: str) -> tuple:
    """Run `fn` under torch.profiler (see TRACE_MARGIN_S), the trace
    exported to `out_dir/trace_<name>.json`. Returns (kernel events, lost)
    of the launches `fn` made: `lost` counts those whose kernel the trace
    lacks (launch calls of the runtime or the driver whose correlation id
    no kernel carries); where it lost some, logs where they sit."""
    from torch.profiler import ProfilerActivity, profile, record_function

    warm = torch.zeros(1, device=torch.device("cuda", torch.cuda.current_device()))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(TRACE_MARGIN_S)
        for _ in range(TRACE_WARM_LAUNCHES):
            warm.add_(1)
            time.sleep(1e-4)
        torch.cuda.synchronize()
        with record_function("traced_run"):
            fn()
            torch.cuda.synchronize()
        time.sleep(TRACE_MARGIN_S)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "trace_" + re.sub(r"\W+", "_", name).strip("_") + ".json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    span = next(e for e in events
                if e.get("cat") == "user_annotation" and e.get("name") == "traced_run")
    launches = sorted((e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")
                       and "LaunchKernel" in e.get("name", "")
                       and span["ts"] <= e["ts"] <= span["ts"] + span["dur"]),
                      key=lambda e: e["ts"])
    corr = {e.get("args", {}).get("correlation") for e in launches}
    by_corr = {e.get("args", {}).get("correlation"): e for e in events
               if e.get("cat") == "kernel" and e.get("args", {}).get("correlation") in corr}
    lost = [n for n, e in enumerate(launches) if e.get("args", {}).get("correlation")
            not in by_corr]
    if lost:
        t0 = launches[0]["ts"]
        log(f"  (trace {name}: {len(lost)} of {len(launches)} launches have no kernel, at "
            f"positions {lost[:12]}, launched {launches[lost[0]]['ts'] - t0:.0f} to "
            f"{launches[lost[-1]]['ts'] - t0:.0f} us after the first)")
    return list(by_corr.values()), len(lost)


def device_ms(fn, reps: int, kernel: str, out_dir: str) -> float:
    """Mean device milliseconds of the kernel whose name holds `kernel`
    over `reps` calls of `fn` after one warm-up call: each launch's own
    start and end on the card, from torch.profiler's trace, so the host's
    launch rate does not enter. Fails unless the trace holds every launch
    (two retries)."""
    fn()
    for _ in range(3):
        kernels, lost = traced(lambda: [fn() for _ in range(reps)], out_dir,
                               f"device_ms_{kernel}")
        durs = [e["dur"] for e in kernels if kernel in e.get("name", "")]
        if len(durs) == reps and not lost:
            return sum(durs) / reps / 1e3
    fail(f"device time of {kernel}: the profiler's trace lost launches three times")


def descent_variant(label: str, g, cfg, q, stop, max_iters: int = 0, q_norms=None):
    """The greedy_descent kernel against `_greedy_descent_plain`, the eager
    loop that launches K5 and K1 once per step: on the card the node
    reached, its distance bit for bit and the counters (steps, tape rows
    scored, adjacency rows read) must be equal, through `_descent_launch`
    and through the public `greedy_descent`. Returns the counters and the
    eager loop's visits (the rows each step scored and read)."""
    from vss_tpu_torch.index import search as sr

    mi = sr._descent_iters(cfg, max_iters)
    visits = []
    want = sr._greedy_descent_plain(g, cfg, q, stop, mi, q_norms, visits)
    want = (*want, sr._descent_counters(visits))
    got = sr._descent_launch(g, cfg, q, stop, mi, q_norms)
    public = sr.greedy_descent(g, cfg, q, stop_level=stop, max_iters=max_iters, q_norms=q_norms)
    torch.cuda.synchronize()
    for entry, out in (("_descent_launch", got), ("greedy_descent", public)):
        if not torch.equal(out[0], want[0]):
            fail(f"greedy_descent {label}, {entry}: the node reached differs from the eager "
                 f"loop's for {int((out[0] != want[0]).sum())} of {q.shape[0]} queries")
        if not bit_equal(out[1], want[1]):
            fail(f"greedy_descent {label}, {entry}: distances differ from the eager loop's")
    counts = [int(c) for c in got[2]]
    if counts != list(want[2]):
        fail(f"greedy_descent {label}: counters {counts} != the eager loop's {list(want[2])}")
    log(f"  {label}: equal to the eager loop (ids, distances bit for bit, {counts[0]} steps, "
        f"{counts[1]} rows scored, {counts[2]} adjacency rows)")
    return counts, visits


def descent_edge_cases(name: str, g, cfg, q) -> None:
    """`descent_variant` over the edge cases of the emulated test on the
    graph `g` with queries `q` (at least 8, the 6th holding a NaN): per-query
    stops (0, 1, the top, above it), step caps of 1 and 2, every neighbour
    of the entry's level-1 row tied at the first query (and, on an f32
    tape, one of them NaN past the first), -1 padding in the adjacency
    rows and missing upper rows, a graph of one level, an empty graph and
    an empty batch. Edits go to clones of `g`."""
    from vss_tpu_torch.index.graph import cast_to_tape, empty_graph

    dev = q.device
    M = g.upper_adj.shape[1]
    top = int(g.max_level)
    stops = torch.tensor([0, 1, top, top + 1], dtype=torch.int32,
                         device=dev).repeat((q.shape[0] + 3) // 4)[:q.shape[0]]
    descent_variant(f"{name}, stop 0, a NaN query", g, cfg, q, 0)
    descent_variant(f"{name}, per-query stops (0, 1, top, above)", g, cfg, q, stops)
    descent_variant(f"{name}, max_iters=1", g, cfg, q, 0, max_iters=1)
    descent_variant(f"{name}, max_iters=2, per-query stops", g, cfg, q, stops, max_iters=2)
    # from level 1, every neighbour of the entry's level-1 row tied at the
    # first query's own vector, one of them NaN past the first
    tg = g.clone()
    tg.max_level = torch.tensor(1, dtype=torch.int32, device=dev)
    ids = tg.upper_adj[int(tg.upper_row[int(tg.entry), 0])]
    ids = ids[ids >= 0].long()
    tg.vectors[ids] = cast_to_tape(q[:1], cfg)
    descent_variant(f"{name}, {ids.numel()} tied neighbours", tg, cfg, q, 0)
    if tg.vectors.dtype == torch.float32:
        tg.vectors[ids[1], 2] = float("nan")
        descent_variant(f"{name}, a NaN row among the neighbours", tg, cfg, q, 0)
    del tg
    pg = g.clone()
    pg.upper_adj[::2, M // 2:] = -1
    upper = torch.nonzero(pg.levels >= 1)[:, 0]
    pg.upper_row[upper[::3], 0] = -1
    descent_variant(f"{name}, -1 padding and missing upper rows", pg, cfg, q, 0)
    del pg
    one = g.clone()
    one.max_level = torch.tensor(0, dtype=torch.int32, device=dev)
    descent_variant(f"{name}, a graph of one level", one, cfg, q, stops)
    del one
    descent_variant(f"{name}, an empty graph", empty_graph(cfg, 64, device=dev), cfg, q, 0)
    descent_variant(f"{name}, an empty batch", g, cfg, q[:0], 0)


def check_descent(dev, idx, q_scaled, wave_vecs, rng, read_ns: float, out_dir: str) -> dict:
    """The greedy_descent kernel against the eager loop through K1 and K5,
    exactly (`descent_variant`), on the 1M flagship graph at the insert
    wave's shape (the first wave of the write path's rows, `wave_vecs`,
    with stop levels drawn as a wave draws its nodes' levels) and the
    serving shape (512 queries, stop 0), each timed by the kernel's device
    time beside the eager loop's wall time, its byte bound and its
    dependent-read floor; then the edge cases of the emulated test on
    small bf16 and f32 graphs."""
    from vss_tpu_torch import HNSWConfig, HNSWIndex
    from vss_tpu_torch.index import search as sr
    from vss_tpu_torch.index.graph import sample_levels

    log("greedy_descent")
    g, cfg = idx.graph, idx.config
    M = g.upper_adj.shape[1]
    row_bytes = g.vectors.shape[1] * g.vectors.element_size()
    mi = sr._descent_iters(cfg, 0)
    # an insert wave's queries: its new rows in the tape's units
    wq = (torch.from_numpy(wave_vecs[:WAVE]).to(dev) / idx.vector_scale).contiguous()
    wave_stop = torch.from_numpy(sample_levels(WAVE, cfg, seed=1)).to(dev)
    shapes = {}
    for key, label, q, stop in (
            ("wave", f"wave: {WAVE} queries, stop levels drawn as a wave's", wq, wave_stop),
            ("serving", f"serving: {BATCH} queries, stop 0", q_scaled, 0)):
        qn = (q * q).sum(-1)
        (steps, scored, adj_rows), visits = descent_variant(label, g, cfg, q, stop, q_norms=qn)
        ms = device_ms(lambda: sr._descent_launch(g, cfg, q, stop, mi, qn), 50,
                       "descent_kernel", out_dir)
        event_ms = cuda_ms(lambda: sr._descent_launch(g, cfg, q, stop, mi, qn), 50)
        plain_times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sr._greedy_descent_plain(g, cfg, q, stop, mi, qn)
            torch.cuda.synchronize()
            plain_times.append((time.perf_counter() - t0) * 1e3)
        plain_ms = min(plain_times)
        B = q.shape[0]
        # each query, its norm, stop level and outputs once; each distinct
        # adjacency row (with its upper_row entry) and each distinct tape
        # row (the entry's too) once, however many queries read it
        rows = torch.unique(torch.cat([g.entry.clamp(min=0).reshape(1).long()]
                                      + [s.long() for s, _ in visits]))
        adj_unique = torch.unique(torch.cat([r.long().reshape(-1) for _, r in visits]
                                            + [rows[:0]]))
        bytes_moved = B * (D * 4 + 4 + 4 + 8) + adj_unique.numel() * (4 + M * 4) \
            + rows.numel() * row_bytes
        b_ms, b_by = bound(bytes_moved, 4.0 * (scored + B) * D, "f32")
        floor_ms = steps * 3 * read_ns / 1e6
        log(f"  {key}: kernel {ms:.4f} ms device time ({event_ms:.4f} ms between CUDA events "
            f"around 50 wrapper calls), eager loop {plain_ms:.3f} ms wall, bound {b_ms:.5f} ms "
            f"({b_by}: {bytes_moved} B, {rows.numel()} distinct tape rows of {scored + B} "
            f"scored, {adj_unique.numel()} distinct adjacency rows of {adj_rows} read), "
            f"dependent-read floor {floor_ms:.4f} ms ({steps} steps x 3 reads x {read_ns:.0f} ns)")
        shapes[key] = dict(queries=B, ms=ms, event_ms=event_ms, plain_ms=plain_ms,
                           bound_ms=b_ms, bound_by=b_by, dependent_read_floor_ms=floor_ms,
                           steps=steps, rows_scored=scored, adjacency_rows=adj_rows,
                           distinct_rows=rows.numel(), distinct_adjacency_rows=adj_unique.numel())

    # ---- the public call on CUDA tensors is one launch and no host sync:
    # under sync debug mode "error" PyTorch raises on a synchronizing call
    from vss_tpu_torch import csrc

    for stop in (0, wave_stop):
        before = {k: v.launches for k, v in csrc.KERNELS.items()}
        torch.cuda.set_sync_debug_mode("error")
        try:
            sr.greedy_descent(g, cfg, wq, stop_level=stop)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        ran = {k: v.launches - before[k] for k, v in csrc.KERNELS.items()
               if v.launches != before[k]}
        if ran != {"greedy_descent": 1}:
            fail(f"greedy_descent on CUDA tensors launched {ran}, not one greedy_descent")
    log("  greedy_descent on CUDA tensors: one launch, no host sync (sync debug mode "
        "\"error\"), with a scalar and with a per-query stop level")

    # ---- edge cases, on small graphs with bf16 and f32 tapes
    for storage, metric, d in (("bf16", "l2sq", 128), ("f32", "cosine", 96), ("f32", "ip", 100)):
        n = 4096
        sv = rng.normal(size=(n, d)).astype(np.float32)
        scfg = HNSWConfig(dims=d, metric=metric, storage_dtype=storage, rerank="none")
        small = HNSWIndex.build(sv, scfg, method="native", device=dev)
        sg = small.graph
        sq = torch.from_numpy(rng.normal(size=(64, d)).astype(np.float32)).to(dev)
        sq = sq / small.vector_scale
        sq[5, 3] = float("nan")
        sq[6] = 0
        descent_edge_cases(f"{storage} {n} x {d} {metric}", sg, scfg, sq)
    wave = shapes["wave"]
    return dict(ms=wave["ms"], plain_ms=wave["plain_ms"], bound_ms=wave["bound_ms"],
                bound_by=wave["bound_by"], library_ms=None, max_abs_err=0.0,
                dependent_read_ns=read_ns, shapes=shapes)


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
    """One batch of `fn` under torch.profiler (`traced`). From the trace:
    the number of kernels, the device-busy time (the sum of kernel
    durations: one stream, so they do not overlap) and the kernels that
    take most of it. The idle share is taken against the unprofiled
    ms/batch `wall_ms`. A trace that lost kernels measures nothing: its
    busy time and idle share are left out and the loss is logged."""
    kernels, lost = traced(lambda: fn(qb), out_dir, label)
    if lost or not kernels:
        log(f"profile {label}: the trace lost {lost} of {len(kernels) + lost} kernels; device "
            f"busy time not measured")
        return {"kernels": len(kernels), "lost": lost}
    busy_ms = sum(e["dur"] for e in kernels) / 1e3
    by_name = collections.Counter()
    for e in kernels:
        by_name[e["name"][:48]] += e["dur"] / 1e3
    top = [[n, round(ms, 4)] for n, ms in by_name.most_common(5)]
    log(f"profile {label}: {len(kernels)} kernels (none lost), device busy {busy_ms:.3f} ms of "
        f"{wall_ms:.3f} ms/batch, idle share {1 - busy_ms / wall_ms:.3f}; top {top}")
    return {"kernels": len(kernels), "lost": 0, "busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / wall_ms, "top_ms": top}


def entry_call(dev, launches, out_dir) -> dict:
    """The forward call that `vss_tpu_torch.entry.entry()` returns (64
    queries, d=128, k=10, ef=64 over a host-built 1,024-row graph, seeded
    by greedy descent): its ms on the host clock over 20 calls, each ending
    in a synchronize, with the launch counts zeroed just before them and
    read just after (and added to `launches`); one launch of the descent
    kernel and one of beam_search a call, K1 none; recall@10 against the
    exact oracle; one call under the profiler for its idle share."""
    from vss_tpu_torch import csrc
    from vss_tpu_torch.entry import entry
    from vss_tpu_torch.ops import bruteforce_topk

    fwd, (graph, q) = entry()
    fwd(graph, q)
    torch.cuda.synchronize()
    reps = 20
    csrc.reset_launch_counts()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        dd, ii = fwd(graph, q)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    counts = {k: v.launches for k, v in csrc.KERNELS.items()}
    for k, v in counts.items():
        launches[k] += v
    n = int(graph.count)
    if dd.shape != (64, K) or ii.shape != (64, K) or not bool(torch.isfinite(dd).all()) \
            or bool(((ii < 0) | (ii >= n)).any()) or bool((dd.diff(dim=1) < 0).any()):
        fail(f"entry() forward: shapes {tuple(dd.shape)} {tuple(ii.shape)}, non-finite "
             f"distances, ids out of range or not ascending")
    truth = bruteforce_topk(q, graph.vectors[:n].float(), K, "l2sq", device=dev)[1]
    r = recall(ii.cpu().numpy(), truth.cpu().numpy())
    if counts["greedy_descent"] != reps or counts["beam_search"] != reps \
            or counts["gather_distances"] != 0:
        fail(f"entry() forward, {reps} calls: launches {counts}; expected one greedy_descent "
             f"and one beam_search a call and no gather_distances")
    if r < 0.9:
        fail(f"entry() forward: recall@10 {r} < 0.9")
    ms = sorted(times)[reps // 2]
    prof = profile_batch("entry() forward", lambda _: fwd(graph, q), None, ms, out_dir)
    log(f"entry() forward (64 queries, k=10, ef=64, {n} rows): median {ms:.4f} ms of {reps} "
        f"calls (min {min(times):.4f}), launches a call "
        f"{ {k: v / reps for k, v in counts.items() if v} }, recall@10 {r:.4f}")
    return {"ms_median": ms, "ms_min": min(times), "calls": reps, "launches": counts,
            "recall_at_10": r, "profile": prof}


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
    # the floor was 0.95 over the native builder's graph. The bulk builder's
    # graph (the JAX package's CREATE INDEX path) links clusters only
    # through the repair's base-layer bridges: an insert descends from the
    # entry through upper levels that kNN edges leave split by cluster, and
    # some new rows are linked far from their own cluster
    if self_hit < 0.9:
        fail(f"only {self_hit} of the inserted rows find themselves")
    ins = steps[f"insert {N_INSERT} rows"]["launches"]
    for kname in ("gather_rows", "greedy_descent", "beam_search"):
        if ins[kname] <= 0:
            fail(f"kernel {kname} was not launched by the insert step")
    # the descent is one kernel launch a wave: K1 no longer runs there
    if ins["gather_distances"] != 0:
        fail(f"the insert step launched gather_distances {ins['gather_distances']} times")

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
    if steps[f"insert {N_RECYCLE} rows into recycled slots"]["launches"]["greedy_descent"] <= 0:
        fail("kernel greedy_descent was not launched by the recycling insert")
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
    for kname in ("greedy_descent", "beam_search"):
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


# ----------------------------------------------------------------------
# phase 7: the Database


def vec_sql(v) -> str:
    """A vector literal that parses back to the same float32 values."""
    return "[" + ", ".join(repr(float(x)) for x in v) + f"]::FLOAT[{len(v)}]"


def join_ids(res, id_col: str, qid_col: str, nq: int, k: int, dist_col=None):
    """A join's rows as [nq, k] ids (and distances), -1 / +inf past the
    rows a query got; rows come out grouped by query in rank order."""
    qid = np.asarray(res[qid_col], np.int64)
    ids = np.full((nq, k), -1, np.int64)
    dist = np.full((nq, k), np.inf, np.float32)
    rank = np.zeros(nq, np.int64)
    got_ids = np.asarray(res[id_col], np.int64)
    got_d = None if dist_col is None else np.asarray(res[dist_col], np.float32)
    for j, qi in enumerate(qid):
        r = rank[qi]
        if r >= k:
            fail(f"query {qi} got more than {k} rows")
        ids[qi, r] = got_ids[j]
        if got_d is not None:
            dist[qi, r] = got_d[j]
        rank[qi] = r + 1
    return ids, dist


def database_phase(seed, dev, smi, vecs, queries, centers, launches, out_dir) -> dict:
    """Phase 7: a `Database` on the card at the flagship's width, driven
    through SQL: CREATE INDEX, the index scan, min_by, the index join, the
    un-indexed joins (K3, K4), the cost model, DELETE and PRAGMA
    hnsw_compact_index, CHECKPOINT and Database.open, the WAL. Each step
    has its launch counts zeroed before it and read after it (and added
    to `launches`); each check fails the run."""
    import gc
    import tempfile

    from vss_tpu_torch import Database, csrc
    from vss_tpu_torch.ops import bruteforce_topk
    from vss_tpu_torch.query import cost

    t_phase = time.perf_counter()
    steps = {}
    nq = queries.shape[0]
    x = torch.from_numpy(vecs).to(dev)
    q_all = torch.from_numpy(queries).to(dev)

    def step(label, fn):
        csrc.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = {k: v.launches for k, v in csrc.KERNELS.items() if v.launches}
        for k, v in counts.items():
            launches[k] += v
        steps[label] = {"seconds": seconds, "launches": counts}
        log(f"database {label}: {seconds:.3f} s, launches {counts}")
        return out

    def need(label, *kernels):
        for kname in kernels:
            if steps[label]["launches"].get(kname, 0) <= 0:
                fail(f"database {label}: kernel {kname} was not launched")

    def explain(db, sql, op):
        plan = db.sql("EXPLAIN " + sql)["explain"][0]
        if op is not None and op not in plan:
            fail(f"EXPLAIN shows no {op}: {plan}")
        return plan

    def oracle(k, x_live=None, valid=None):
        xs = x if x_live is None else x_live
        return batched_ids(lambda qb: bruteforce_topk(qb, xs, k, "l2sq", valid_mask=valid,
                                                      device=dev), q_all)

    truth = oracle(K)
    truth100 = oracle(K_DEEP)

    # table and index
    db = Database(device=dev)
    ids = np.arange(N, dtype=np.int64)
    step("create_table", lambda: db.create_table("items", {"id": ids, "vec": vecs}))
    step("create_index", lambda: db.sql(
        "CREATE INDEX idx ON items USING HNSW (vec) WITH (metric='l2sq', storage='int8')"))
    need("create_index", "native_segmin", "gather_rows")
    index = db.indexes["idx"].index
    if index.count != N:
        fail(f"the SQL-built index holds {index.count} rows")
    log(f"database CREATE INDEX: {steps['create_index']['seconds']:.2f} s for {N} rows, "
        f"stats {index.build_stats}")
    db.create_table("queries", {"qid": np.arange(nq, dtype=np.int64), "qvec": queries})

    # HNSW_INDEX_SCAN: N_SQL_SCAN single-query statements
    def topk_sql(v, table="items", k=K):
        return f"SELECT id FROM {table} ORDER BY array_distance(vec, {vec_sql(v)}) LIMIT {k}"

    explain(db, topk_sql(queries[0]), "HNSW_INDEX_SCAN")
    sqls = [topk_sql(v) for v in queries[:N_SQL_SCAN]]
    scan_rows = step("hnsw_index_scan", lambda: [db.sql(s)["id"] for s in sqls])
    need("hnsw_index_scan", "beam_search", "gather_distances")
    scan_ms = steps["hnsw_index_scan"]["seconds"] / N_SQL_SCAN * 1e3
    for i, got in enumerate(scan_rows):
        _, want = index.search(queries[i:i + 1], K, ef=EF)
        if not np.array_equal(np.asarray(got, np.int64), want[0].cpu().numpy().astype(np.int64)):
            fail(f"HNSW_INDEX_SCAN query {i}: {got} != index.search {want[0].tolist()}")
    _, batched = index.search(queries[:N_SQL_SCAN], K, ef=EF)
    same_batched = float(np.mean([np.array_equal(np.asarray(g, np.int64), b) for g, b in zip(
        scan_rows, batched.cpu().numpy().astype(np.int64))]))
    log(f"HNSW_INDEX_SCAN: {N_SQL_SCAN} statements, {scan_ms:.3f} ms each, ids equal "
        f"index.search per query; equal to one batched call for {same_batched:.4f}")

    # min_by
    mb_sql = f"SELECT min_by(id, array_distance(vec, {vec_sql(queries[0])}), {K}) FROM items"
    explain(db, mb_sql, "HNSW_INDEX_SCAN")
    mb = step("min_by", lambda: db.sql(mb_sql))
    mb_ids = [int(v) for v in list(mb.values())[0][0]]
    if mb_ids != [int(v) for v in scan_rows[0]]:
        fail(f"min_by {mb_ids} != the index scan's {list(scan_rows[0])}")

    # HNSW_INDEX_JOIN: every query of the queries table at once
    join_sql = ("SELECT qid, id, array_distance(qvec, vec) AS dist FROM queries, LATERAL "
                "(SELECT id, vec FROM items ORDER BY array_distance(queries.qvec, items.vec) "
                f"LIMIT {K})")
    explain(db, join_sql, "HNSW_INDEX_JOIN")
    db.sql(join_sql)  # warm-up
    res = step("hnsw_index_join", lambda: db.sql(join_sql))
    need("hnsw_index_join", "beam_search", "gather_distances", "gather_rows")
    join_ms = steps["hnsw_index_join"]["seconds"] * 1e3
    j_ids, j_d = join_ids(res, "id", "qid", nq, K, "dist")
    _, want = index.search(queries, K, ef=EF)
    if not np.array_equal(j_ids, want.cpu().numpy().astype(np.int64)):
        fail("HNSW_INDEX_JOIN ids differ from the batched index.search")
    r_join = recall(j_ids, truth)
    prof = profile_batch("HNSW_INDEX_JOIN statement", lambda s: db.sql(s), join_sql, join_ms,
                         out_dir)
    log(f"HNSW_INDEX_JOIN: {nq} queries in one statement, {join_ms:.3f} ms, recall@10 "
        f"{r_join:.4f}, ids equal the batched index.search")
    if r_join < 0.85:
        fail(f"HNSW_INDEX_JOIN recall@10 {r_join} < 0.85")

    # the un-indexed joins: an un-indexed copy of the table
    db.create_table("items_bare", {"id": ids, "vec": vecs})
    explain(db, topk_sql(queries[0], "items_bare"), "BRUTE_FORCE_TOPK")
    bf = step("brute_force_topk", lambda: db.sql(topk_sql(queries[0], "items_bare")))
    need("brute_force_topk", "scan_segmin")
    if not np.array_equal(np.asarray(bf["id"], np.int64), truth[0]):
        fail("BRUTE_FORCE_TOPK differs from the oracle")
    unindexed = {}
    for k, kname in ((K, "scan_segmin"), (K_DEEP, "pairwise")):
        kj_sql = f"SELECT l_qid, r_id FROM knn_join(queries, items_bare, qvec, vec, {k})"
        explain(db, kj_sql, "KNN_JOIN")
        label = f"knn_join k={k}"
        res = step(label, lambda: db.sql(kj_sql))
        need(label, kname)
        got, _ = join_ids(res, "r_id", "l_qid", nq, k)
        want = truth if k == K else truth100
        agree = float((got == want).mean())
        if agree != 1.0:
            fail(f"{label}: ids equal the oracle's for only {agree}")
        unindexed[label] = {"ms": steps[label]["seconds"] * 1e3}
    vj_sql = f"SELECT left_qid, right_id FROM vss_join(queries, items_bare, qvec, vec, {K})"
    res = step("vss_join", lambda: db.sql(vj_sql))
    need("vss_join", "scan_segmin")
    got, _ = join_ids(res, "right_id", "left_qid", nq, K)
    if not np.array_equal(got, truth):
        fail("vss_join differs from the oracle")
    db.drop_table("items_bare")

    # the cost model: rates measured here, then the planner's choices
    rates = step("calibrate", lambda: cost.calibrate(
        persist=False, n_rows=N_CALIBRATE, device=dev))
    log(f"cost model rates on {smi}: " + json.dumps(
        {k: rates[k] for k in ("stream_bw", "random_bw", "gather_bw", "tape_bw")}))
    db.sql("SET hnsw_cost_model = true")
    kj_idx = f"SELECT l_qid, r_id FROM knn_join(queries, items, qvec, vec, {K})"
    choices = {
        "join of 2048": explain(db, kj_idx, None).splitlines()[1].strip(),
        "lateral join of 2048": explain(db, join_sql, None).splitlines()[1].strip(),
        "single top-k": explain(db, topk_sql(queries[0]), None).splitlines()[1].strip(),
    }
    log(f"cost model choices at {N} rows: {choices}")
    exact_checks = {}
    if "EXACT_SCAN" in choices["join of 2048"]:
        res = step("exact_scan_join", lambda: db.sql(kj_idx))
        need("exact_scan_join", "native_segmin")
        got, _ = join_ids(res, "r_id", "l_qid", nq, K)
        exact_checks["flagship"] = recall(got, truth)
    # a corpus where the exact scan wins: the first N_COST_SMALL rows
    db.create_table("items_small", {"id": ids[:N_COST_SMALL], "vec": vecs[:N_COST_SMALL]})
    db.sql("CREATE INDEX idx_small ON items_small USING HNSW (vec) "
           "WITH (metric='l2sq', storage='int8')")
    ks_sql = f"SELECT l_qid, r_id FROM knn_join(queries, items_small, qvec, vec, {K})"
    choices["join of 2048, small corpus"] = explain(db, ks_sql, "EXACT_SCAN_JOIN").splitlines()[1]
    res = step("exact_scan_join small", lambda: db.sql(ks_sql))
    need("exact_scan_join small", "native_segmin")
    got, _ = join_ids(res, "r_id", "l_qid", nq, K)
    exact_checks[f"{N_COST_SMALL} rows"] = recall(got, oracle(K, x[:N_COST_SMALL]))
    log(f"cost model: EXACT_SCAN recall@10 {exact_checks}")
    for where, r in exact_checks.items():
        if r < 0.99:
            fail(f"EXACT_SCAN recall@10 {r} < 0.99 ({where})")
    db.sql("SET hnsw_cost_model = false")
    db.drop_table("items_small")

    # DELETE and PRAGMA hnsw_compact_index
    step("delete", lambda: db.sql("DELETE FROM items WHERE id % 5 = 0"))
    live = ids % 5 != 0
    if index.count != int(live.sum()) or db.table("items").num_rows != int(live.sum()):
        fail(f"after DELETE: index {index.count}, table {db.table('items').num_rows} rows")
    live_truth = oracle(K, valid=torch.from_numpy(live).to(dev))
    res = step("join with tombstones", lambda: db.sql(join_sql))
    d_ids, _ = join_ids(res, "id", "qid", nq, K)
    if (d_ids[d_ids >= 0] % 5 == 0).any():
        fail("a deleted row came back after DELETE")
    r_del = recall(d_ids, live_truth)
    step("compact", lambda: db.sql("PRAGMA hnsw_compact_index('idx')"))
    need("compact", "gather_rows")
    res = step("join after compact", lambda: db.sql(join_sql))
    c_ids, c_d = join_ids(res, "id", "qid", nq, K, "dist")
    if (c_ids[c_ids >= 0] % 5 == 0).any():
        fail("a deleted row came back after the compaction")
    r_comp = recall(c_ids, live_truth)
    log(f"DELETE of {N - int(live.sum())} rows: join recall@10 {r_del:.4f}; after PRAGMA "
        f"hnsw_compact_index {r_comp:.4f}")
    if min(r_del, r_comp) < 0.85:
        fail(f"recall@10 after DELETE {r_del} / compaction {r_comp} < 0.85")

    # CHECKPOINT and Database.open
    tmp = tempfile.mkdtemp(prefix="vss_db_")
    path = os.path.join(tmp, "flagship.vssdb")
    step("checkpoint", lambda: db.sql(f"CHECKPOINT '{path}'"))
    size = db.sql("SELECT * FROM pragma_database_size()")
    size = {k: int(np.asarray(v)[0]) for k, v in size.items()}
    file_bytes = os.path.getsize(path)
    del db, index
    gc.collect()
    db = step("open", lambda: Database.open(path, device=dev))
    res = step("join after open", lambda: db.sql(join_sql))
    o_ids, o_d = join_ids(res, "id", "qid", nq, K, "dist")
    if not (np.array_equal(o_ids, c_ids) and np.array_equal(o_d.view(np.int32),
                                                            c_d.view(np.int32))):
        fail("the join's ids or distances differ across CHECKPOINT and Database.open")
    log(f"CHECKPOINT: {steps['checkpoint']['seconds']:.2f} s, {file_bytes} bytes, "
        f"pragma_database_size {size}; Database.open {steps['open']['seconds']:.2f} s, the "
        f"first join (loads the index) {steps['join after open']['seconds']:.2f} s; ids and "
        f"distances bit-equal")

    # the WAL: insert and delete, drop the database without a checkpoint,
    # reopen and replay
    wal_path = db.enable_wal()
    wrng = np.random.default_rng(seed + 3)
    new_vecs, _, _ = sift_like(wrng, N_WAL_INSERT, 0, D, centers)
    new_ids = np.arange(N, N + N_WAL_INSERT, dtype=np.int64)
    step("wal insert", lambda: db.insert("items", {"id": new_ids, "vec": new_vecs}))
    gone = np.flatnonzero(live)[:N_WAL_DELETE]
    step("wal delete", lambda: db.delete("items", gone.tolist()))
    wal_bytes = os.path.getsize(wal_path)
    del db
    gc.collect()
    db = step("open with replay", lambda: Database.open(path, device=dev))
    need("open with replay", "greedy_descent")
    t = db.table("items")
    if (t.positions_of_rowids(gone) >= 0).any():
        fail("a deleted row came back after the replay")
    if (t.positions_of_rowids(new_ids) < 0).any():
        fail("an inserted row is missing after the replay")
    db.create_table("new_rows", {"nid": new_ids, "vec": new_vecs})
    res = step("wal self-match", lambda: db.sql(
        "SELECT left_nid, right_id FROM vss_join(new_rows, items, vec, vec, 1)"))
    if not np.array_equal(np.asarray(res["right_id"], np.int64), new_ids):
        fail("an acknowledged insert does not find itself at k=1 after the replay")
    res = step("join after replay", lambda: db.sql(join_sql))
    w_ids, _ = join_ids(res, "id", "qid", nq, K)
    if np.isin(w_ids, gone).any():
        fail("a deleted row came back in the join after the replay")
    idx2 = db.indexes["idx"].index
    if idx2.count != t.num_rows:
        fail(f"after the replay the index holds {idx2.count} rows, the table {t.num_rows}")
    log(f"WAL: {N_WAL_INSERT} inserts and {N_WAL_DELETE} deletes, {wal_bytes} bytes of log; "
        f"open with replay {steps['open with replay']['seconds']:.2f} s (open without a log "
        f"{steps['open']['seconds']:.2f} s); every insert finds itself at k=1, no delete "
        f"returns")
    del db, idx2
    gc.collect()
    for name in os.listdir(tmp):
        os.remove(os.path.join(tmp, name))
    os.rmdir(tmp)
    phase_s = time.perf_counter() - t_phase
    log(f"database phase: {phase_s:.1f} s")
    return {
        "card": smi, "rows": N, "queries": nq, "seconds": phase_s, "steps": steps,
        "create_index_s": steps["create_index"]["seconds"],
        "hnsw_index_scan": {"statements": N_SQL_SCAN, "ms_per_statement": scan_ms,
                            "equal_to_one_batched_call": same_batched},
        "hnsw_index_join": {"ms_per_statement": join_ms, "recall_at_10": r_join,
                            "profile": prof},
        "unindexed": unindexed, "cost_model": {"rates": {
            k: rates[k] for k in ("stream_bw", "random_bw", "gather_bw", "tape_bw")},
            "choices": choices, "exact_recall_at_10": exact_checks},
        "delete": {"rows": N - int(live.sum()), "recall_at_10": r_del,
                   "recall_at_10_after_compact": r_comp},
        "checkpoint": {"seconds": steps["checkpoint"]["seconds"], "bytes": file_bytes,
                       "database_size": size, "open_s": steps["open"]["seconds"]},
        "wal": {"inserts": N_WAL_INSERT, "deletes": N_WAL_DELETE, "bytes": wal_bytes,
                "open_with_replay_s": steps["open with replay"]["seconds"]},
    }


# ----------------------------------------------------------------------
# phase 8: the sharded index


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def mp_worker(rank: int, port: int, data_path: str, out_path: str) -> int:
    """One rank of the multi-process run (`--mp-worker`): 2 slots on
    cuda:0, joined with the other rank over gloo, the sharded build of the
    rows in `data_path` and its search and scan over the queries there;
    the ids and distances go to `out_path`."""
    import torch.distributed as dist

    from vss_tpu_torch import HNSWConfig
    from vss_tpu_torch.parallel import Mesh, ShardedHNSWIndex, multihost

    dev = torch.device(DEVICE)
    # NCCL refuses two ranks on one GPU ("duplicate GPU"): the merged lists
    # travel over gloo, through host memory
    mesh = multihost.initialize(f"127.0.0.1:{port}", 2, rank, backend="gloo",
                                local_slots=Mesh([dev] * (SHARDS // 2)), timeout_s=MP_TIMEOUT_S)
    data = np.load(data_path)
    idx = ShardedHNSWIndex.build(data["vecs"], HNSWConfig(dims=D, metric="l2sq",
                                                          storage_dtype="int8"), mesh)
    q_all = torch.from_numpy(data["queries"]).to(dev)
    s_d, s_i = search_batches(lambda qb: idx.search(qb, K, ef=EF), q_all)
    c_d, c_i = search_batches(lambda qb: idx.scan_search(qb, K), q_all)
    np.savez(out_path, search_ids=s_i, search_d=s_d, scan_ids=c_i, scan_d=c_d,
             owners=np.asarray(mesh.owners), local=np.asarray(multihost.local_shard_indices(mesh)))
    log(f"rank {rank}: backend {dist.get_backend()}, slots {[str(d) for d in mesh.devices]}, "
        f"owners {list(mesh.owners)}, local shards {multihost.local_shard_indices(mesh)}")
    dist.destroy_process_group()
    return 0


def search_batches(fn, queries, batch=BATCH):
    """fn over the query batches -> (dists, ids) as numpy."""
    outs = [fn(queries[s:s + batch]) for s in range(0, queries.shape[0], batch)]
    return [torch.cat([o[i] for o in outs]).cpu().numpy() for i in (0, 1)]


def sharded_phase(seed, dev, smi, vecs, queries, truth, centers, launches, out_dir) -> dict:
    """Phase 8: `ShardedHNSWIndex` on SHARDS slots of one device at the
    flagship's width: the sharded bulk build (`auto`), `search` with and
    without the per-shard ef, `scan_search`, a filter mask, the per-shard
    counters; insert, delete, compact, a forced rebalance (at
    N_REBALANCE rows), save and load; the Database with a sharded index
    (SQL, `.vssdb` CHECKPOINT and Database.open, `CREATE INDEX ... WITH
    (sharded = TRUE)` on N_MP rows); two processes of SHARDS // 2 slots
    each over gloo, equal to one process; `dryrun_multichip`. Each step
    has its launch counts zeroed before it and read after it (and added to
    `launches`); each check fails the run."""
    import gc
    import shutil
    import tempfile

    from vss_tpu_torch import Database, HNSWConfig, csrc
    from vss_tpu_torch.entry import dryrun_multichip
    from vss_tpu_torch.ops import bruteforce_topk
    from vss_tpu_torch.parallel import Mesh, ShardedHNSWIndex, make_mesh

    t_phase = time.perf_counter()
    steps, paths = {}, {}
    nq = queries.shape[0]
    x = torch.from_numpy(vecs).to(dev)
    q_all = torch.from_numpy(queries).to(dev)
    mesh = Mesh([dev] * SHARDS)
    cfg = HNSWConfig(dims=D, metric="l2sq", storage_dtype="int8")
    tmp = tempfile.mkdtemp(prefix="vss_sharded_")

    def step(label, fn):
        csrc.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = {k: v.launches for k, v in csrc.KERNELS.items() if v.launches}
        for k, v in counts.items():
            launches[k] += v
        steps[label] = {"seconds": seconds, "launches": counts}
        log(f"sharded {label}: {seconds:.3f} s, launches {counts}")
        return out

    def need(label, *kernels):
        for kname in kernels:
            if steps[label]["launches"].get(kname, 0) <= 0:
                fail(f"sharded {label}: kernel {kname} was not launched")

    def run_path(label, fn, kernels, n_rows):
        """One serving path over the query batches: ms per batch, qps,
        launches; its outputs checked for shape, range and order."""
        csrc.reset_launch_counts()
        (dd, ii), times = timed_batches(fn, q_all)
        counts = {k: v.launches for k, v in csrc.KERNELS.items() if v.launches}
        for k, v in counts.items():
            launches[k] += v
        ms = sum(times) / len(times)
        paths[label] = {"ms_per_batch": ms, "qps": BATCH / ms * 1e3, "launches": counts}
        log(f"sharded {label}: {ms:.3f} ms/batch of {BATCH} (batches "
            f"{[round(t, 3) for t in times]}), {NQ / (sum(times) / 1e3):.1f} qps, "
            f"launches {counts}")
        for kname in kernels:
            if counts.get(kname, 0) <= 0:
                fail(f"sharded {label}: kernel {kname} was not launched")
        if dd.shape != (nq, K) or ii.shape != (nq, K):
            fail(f"sharded {label}: shapes {dd.shape} {ii.shape}")
        if not np.isfinite(dd).all() or (ii < 0).any() or (ii >= n_rows).any():
            fail(f"sharded {label}: non-finite distances or ids out of range")
        if (np.diff(dd, axis=1) < 0).any():
            fail(f"sharded {label}: distances not ascending")
        return dd, ii

    def oracle(xs, valid=None):
        return batched_ids(lambda qb: bruteforce_topk(qb, xs, K, "l2sq", valid_mask=valid,
                                                      device=dev), q_all)

    graph_kernels = ("beam_search", "gather_distances", "gather_rows")

    # ---- the sharded bulk build
    idx = step("build", lambda: ShardedHNSWIndex.build(vecs, cfg, mesh))
    need("build", "gather_rows", "scan_segmin")  # K5 in refine / back-links, K3 in repair
    if idx.count != N or idx.n_shards != SHARDS or sum(idx.next_slot) != N:
        fail(f"sharded build: {idx.count} rows on {idx.n_shards} shards {idx.next_slot}")
    build_s = steps["build"]["seconds"]
    log(f"sharded build: {N} rows on {SHARDS} slots of {dev}, {build_s:.2f} s "
        f"({N / build_s:.0f} rows/s), shards {idx.next_slot}")

    # ---- serving: the per-shard ef, the full beam, the scan, a filter
    idx.search(q_all[:BATCH], K, ef=EF)  # warm-up
    idx.scan_search(q_all[:BATCH], K)
    ef_shard = idx.shard_ef(EF, K)
    _, g_ids = run_path(f"search k={K} ef={EF} (ef_shard {ef_shard})",
                        lambda qb: idx.search(qb, K, ef=EF), graph_kernels, N)
    _, f_ids = run_path(f"search k={K} ef={EF} scale_ef=False",
                        lambda qb: idx.search(qb, K, ef=EF, scale_ef=False), graph_kernels, N)
    s_d, s_ids = run_path(f"scan_search k={K}", lambda qb: idx.scan_search(qb, K),
                          ("native_segmin",), N)
    srow = idx.slot_rowid_array()
    if srow.shape != (SHARDS, idx.graphs[0].capacity):
        fail(f"slot_rowid_array is {srow.shape}")
    mask = torch.from_numpy((srow % 2 == 0) & (srow >= 0)).to(dev)
    _, gm_ids = run_path("search, filter id % 2 = 0", lambda qb: idx.search(
        qb, K, ef=EF, filter_mask=mask), graph_kernels, N)
    _, sm_ids = run_path("scan_search, filter id % 2 = 0", lambda qb: idx.scan_search(
        qb, K, filter_mask=mask), ("native_segmin",), N)
    even = torch.from_numpy(np.arange(N) % 2 == 0).to(dev)
    truth_even = oracle(x, even)
    if (gm_ids % 2).any() or (sm_ids % 2).any():
        fail("a filtered search returned a row the filter excludes")
    rec = {"search": recall(g_ids, truth), "search_full_beam": recall(f_ids, truth),
           "scan": recall(s_ids, truth), "search_filtered": recall(gm_ids, truth_even),
           "scan_filtered": recall(sm_ids, truth_even)}
    same = s_ids[:, 0] == truth[:, 0]
    ref = ((vecs[truth[:64, 0]].astype(np.float64) - queries[:64].astype(np.float64)) ** 2).sum(1)
    scan_rel = float(np.abs(s_d[:64, 0] - ref).max() / ref.max()) if same[:64].all() else None
    log(f"sharded recall@10: {json.dumps(rec)}; scan top-1 distance vs float64 host reference "
        f"(64 queries): max rel err {scan_rel}")
    for key, bar in (("search", 0.85), ("search_full_beam", 0.85), ("scan", 0.99),
                     ("search_filtered", 0.85), ("scan_filtered", 0.99)):
        if rec[key] < bar:
            fail(f"sharded recall@10 {key} {rec[key]} < {bar}")
    if scan_rel is None or scan_rel > 1e-4:
        fail(f"sharded scan distances disagree with the float64 reference ({scan_rel})")
    evals = {}
    for label, kw in (("ef_shard", {}), ("full beam", {"scale_ef": False})):
        _, _, st = idx.search(q_all[:BATCH], K, ef=EF, with_stats=True, **kw)
        evals[label] = {"ef_shard": st["ef_shard"],
                        "per_shard_evals": [int(v) for v in st["per_shard_evals"]]}
    log(f"sharded per-shard distance evaluations, one batch of {BATCH}: {json.dumps(evals)}")
    profiles = {
        "search": profile_batch("sharded search k=10 ef=64", lambda qb: idx.search(
            qb, K, ef=EF), q_all[:BATCH], paths[f"search k={K} ef={EF} (ef_shard {ef_shard})"][
                "ms_per_batch"], out_dir),
        "scan": profile_batch("sharded scan_search k=10", lambda qb: idx.scan_search(qb, K),
                              q_all[:BATCH], paths[f"scan_search k={K}"]["ms_per_batch"],
                              out_dir),
    }

    # ---- writes: insert, delete, compact
    wrng = np.random.default_rng(seed + 4)
    new_vecs, _, _ = sift_like(wrng, N_INSERT, 0, D, centers)
    step(f"insert {N_INSERT} rows", lambda: idx.insert(new_vecs, np.arange(N, N + N_INSERT)))
    need(f"insert {N_INSERT} rows", *graph_kernels, "greedy_descent")
    n1 = N + N_INSERT
    if idx.count != n1 or sum(idx.next_slot) != n1:
        fail(f"after the insert: {idx.count} rows, next slots {idx.next_slot}")
    ins_s = steps[f"insert {N_INSERT} rows"]["seconds"]
    probe = wrng.choice(N_INSERT, min(NQ, N_INSERT), replace=False)
    _, found = search_batches(lambda qb: idx.search(qb, 1, ef=EF),
                              torch.from_numpy(new_vecs[probe]).to(dev))
    self_hit = float((found[:, 0] == N + probe).mean())
    log(f"sharded insert: {N_INSERT / ins_s:.1f} rows/s, capacity per shard "
        f"{idx.graphs[0].capacity}; {self_hit:.4f} of {probe.size} inserted rows find "
        f"themselves at k=1")
    if self_hit < 0.9:
        fail(f"only {self_hit} of the inserted rows find themselves")
    x_all = torch.cat([x, torch.from_numpy(new_vecs).to(dev)])
    gone = np.flatnonzero(np.arange(n1) % 5 == 0)
    n_gone = step("delete id % 5 = 0", lambda: idx.delete(gone))
    live = np.arange(n1) % 5 != 0
    if n_gone != gone.size or idx.count != int(live.sum()):
        fail(f"after the delete: {n_gone} deleted, {idx.count} rows")
    live_truth = oracle(x_all, torch.from_numpy(live).to(dev))
    _, t_ids = run_path("search with tombstones", lambda qb: idx.search(qb, K, ef=EF),
                        graph_kernels, n1)
    counts_before = idx._live_counts()
    step("compact", idx.compact)
    need("compact", "gather_rows")
    if idx.deleted_count != 0 or idx.count != int(live.sum()) or \
            idx.next_slot != [int(c) for c in counts_before]:
        fail(f"after compact: {idx.deleted_count} tombstones, {idx.count} rows, next slots "
             f"{idx.next_slot} (live per shard {counts_before.tolist()})")
    _, c_ids = run_path("search after compact", lambda qb: idx.search(qb, K, ef=EF),
                        graph_kernels, n1)
    _, cs_ids = run_path("scan_search after compact", lambda qb: idx.scan_search(qb, K),
                         ("native_segmin",), n1)
    for label, ids_ in (("tombstones", t_ids), ("compact", c_ids), ("compact scan", cs_ids)):
        if not live[ids_].all():
            fail(f"sharded {label}: a deleted row came back")
    rec.update(with_tombstones=recall(t_ids, live_truth), after_compact=recall(c_ids, live_truth),
               scan_after_compact=recall(cs_ids, live_truth))
    log(f"sharded writes: recall@10 with {gone.size} tombstones {rec['with_tombstones']:.4f}, "
        f"after compact {rec['after_compact']:.4f}, scan {rec['scan_after_compact']:.4f}")
    if min(rec["with_tombstones"], rec["after_compact"]) < 0.85:
        fail("sharded recall@10 after the writes < 0.85")
    if rec["scan_after_compact"] < 0.99:
        fail("sharded scan recall@10 after the writes < 0.99")

    # ---- save and load (the directory form): bit-equal answers
    ckpt = os.path.join(tmp, "index")
    step("save", lambda: idx.save(ckpt))
    loaded = step("load", lambda: ShardedHNSWIndex.load(ckpt, Mesh([dev] * SHARDS)))
    for label, fn in (("search", lambda i: lambda qb: i.search(qb, K, ef=EF)),
                      ("scan", lambda i: lambda qb: i.scan_search(qb, K))):
        a_d, a_i = search_batches(fn(idx), q_all)
        b_d, b_i = search_batches(fn(loaded), q_all)
        if not (np.array_equal(a_i, b_i) and np.array_equal(a_d.view(np.int32),
                                                            b_d.view(np.int32))):
            fail(f"sharded {label}: ids or distances differ across save and load")
    ckpt_bytes = sum(os.path.getsize(os.path.join(ckpt, f)) for f in os.listdir(ckpt))
    log(f"sharded save {steps['save']['seconds']:.2f} s ({ckpt_bytes} bytes), load "
        f"{steps['load']['seconds']:.2f} s: search and scan bit-equal")
    del idx, loaded, x_all
    gc.collect()

    # ---- a forced rebalance, at N_REBALANCE rows: most of shard 0 deleted
    small = ShardedHNSWIndex.build(vecs[:N_REBALANCE], cfg, mesh)
    dead = np.arange(0, N_REBALANCE, SHARDS)[: 3 * N_REBALANCE // (4 * SHARDS)]
    small.delete(dead)
    skew = small._live_counts().tolist()
    done = step("rebalance", small.rebalance)
    need("rebalance", "gather_rows")
    after = small._live_counts()
    if not done or after.max() - after.min() > 1 or small.deleted_count != 0:
        fail(f"rebalance: ran {done}, live per shard {skew} -> {after.tolist()}")
    small_live = np.ones(N_REBALANCE, bool)
    small_live[dead] = False
    r_ids = batched_ids(lambda qb: small.search(qb, K, ef=EF), q_all)
    if not small_live[r_ids].all():
        fail("rebalance: a deleted row came back")
    rec["after_rebalance"] = recall(r_ids, oracle(x[:N_REBALANCE],
                                                  torch.from_numpy(small_live).to(dev)))
    log(f"sharded rebalance of {N_REBALANCE} rows: live per shard {skew} -> "
        f"{after.tolist()} in {steps['rebalance']['seconds']:.2f} s, recall@10 "
        f"{rec['after_rebalance']:.4f}")
    if rec["after_rebalance"] < 0.85:
        fail(f"recall@10 after the rebalance {rec['after_rebalance']} < 0.85")
    del small
    gc.collect()

    # ---- the Database: a sharded index on the flagship table
    db = Database(device=dev)
    ids = np.arange(N, dtype=np.int64)
    step("db create_table", lambda: db.create_table("items", {"id": ids, "vec": vecs}))
    step("db create_index", lambda: db.create_hnsw_index(
        "sidx", "items", "vec", metric="l2sq", storage="int8", sharded=True,
        mesh=make_mesh(SHARDS, device=dev)))
    need("db create_index", "gather_rows", "scan_segmin")
    sindex = db.indexes["sidx"].index
    if sindex.n_shards != SHARDS or sindex.count != N:
        fail(f"the SQL database's sharded index: {sindex.n_shards} shards, {sindex.count} rows")
    db.create_table("queries", {"qid": np.arange(nq, dtype=np.int64), "qvec": queries})
    one_sql = f"SELECT id FROM items ORDER BY array_distance(vec, {vec_sql(queries[0])}) LIMIT {K}"
    if "HNSW_INDEX_SCAN" not in db.sql("EXPLAIN " + one_sql)["explain"][0]:
        fail("EXPLAIN of a top-k over the sharded index shows no HNSW_INDEX_SCAN")
    db.sql(one_sql)  # warm-up
    one = step("db hnsw_index_scan", lambda: db.sql(one_sql))
    need("db hnsw_index_scan", "beam_search")
    _, want = sindex.search(queries[:1], K, ef=EF)
    if not np.array_equal(np.asarray(one["id"], np.int64), want[0].cpu().numpy()):
        fail(f"HNSW_INDEX_SCAN over the sharded index: {list(one['id'])} != index.search")
    join_sql = ("SELECT qid, id, array_distance(qvec, vec) AS dist FROM queries, LATERAL "
                "(SELECT id, vec FROM items ORDER BY array_distance(queries.qvec, items.vec) "
                f"LIMIT {K})")
    if "HNSW_INDEX_JOIN" not in db.sql("EXPLAIN " + join_sql)["explain"][0]:
        fail("EXPLAIN of the join over the sharded index shows no HNSW_INDEX_JOIN")
    db.sql(join_sql)  # warm-up
    res = step("db hnsw_index_join", lambda: db.sql(join_sql))
    need("db hnsw_index_join", *graph_kernels)
    j_ids, j_d = join_ids(res, "id", "qid", nq, K, "dist")
    _, want = sindex.search(queries, K, ef=EF)
    if not np.array_equal(j_ids, want.cpu().numpy().astype(np.int64)):
        fail("HNSW_INDEX_JOIN over the sharded index differs from one index.search call")
    rec["db_join"] = recall(j_ids, truth)
    if rec["db_join"] < 0.85:
        fail(f"HNSW_INDEX_JOIN recall@10 {rec['db_join']} < 0.85")
    path = os.path.join(tmp, "sharded.vssdb")
    step("db checkpoint", lambda: db.sql(f"CHECKPOINT '{path}'"))
    file_bytes = os.path.getsize(path)
    del db, sindex
    gc.collect()
    db = step("db open", lambda: Database.open(path, device=dev))
    if db.indexes["sidx"].index.n_shards != SHARDS:
        fail("Database.open did not restore the sharded index's shards")
    res = step("db join after open", lambda: db.sql(join_sql))
    o_ids, o_d = join_ids(res, "id", "qid", nq, K, "dist")
    if not (np.array_equal(o_ids, j_ids) and np.array_equal(o_d.view(np.int32),
                                                            j_d.view(np.int32))):
        fail("the sharded join's ids or distances differ across CHECKPOINT and Database.open")
    log(f"sharded Database: CREATE INDEX {steps['db create_index']['seconds']:.2f} s, one query "
        f"{steps['db hnsw_index_scan']['seconds'] * 1e3:.3f} ms, the {nq}-query join "
        f"{steps['db hnsw_index_join']['seconds'] * 1e3:.3f} ms (recall@10 "
        f"{rec['db_join']:.4f}), CHECKPOINT {steps['db checkpoint']['seconds']:.2f} s "
        f"({file_bytes} bytes), open {steps['db open']['seconds']:.2f} s: bit-equal")
    del db
    gc.collect()
    # SQL CREATE INDEX ... WITH (sharded = TRUE): one slot per visible card
    db = Database(device=dev)
    db.create_table("small", {"id": ids[:N_MP], "vec": vecs[:N_MP]})
    db.create_table("queries", {"qid": np.arange(nq, dtype=np.int64), "qvec": queries})
    step("db sql create_index sharded", lambda: db.sql(
        "CREATE INDEX s2 ON small USING HNSW (vec) WITH (metric='l2sq', storage='int8', "
        "sharded=TRUE)"))
    n_slots = db.hnsw_index_info()[0]["n_shards"]
    if n_slots != make_mesh(device=dev).size:
        fail(f"CREATE INDEX ... WITH (sharded = TRUE) took {n_slots} slots")
    res = db.sql(join_sql.replace("FROM items", "FROM small").replace("items.vec", "small.vec"))
    s_ids, _ = join_ids(res, "id", "qid", nq, K)
    rec["sql_sharded_small"] = recall(s_ids, oracle(x[:N_MP]))
    log(f"CREATE INDEX ... WITH (sharded = TRUE) on {N_MP} rows: {n_slots} slot(s), "
        f"{steps['db sql create_index sharded']['seconds']:.2f} s, join recall@10 "
        f"{rec['sql_sharded_small']:.4f}")
    if rec["sql_sharded_small"] < 0.85:
        fail(f"recall@10 of the SQL-created sharded index {rec['sql_sharded_small']} < 0.85")
    del db
    gc.collect()

    # ---- two processes, SHARDS // 2 slots each, against one process
    data_path = os.path.join(tmp, "mp.npz")
    np.savez(data_path, vecs=vecs[:N_MP], queries=queries)
    torch.cuda.empty_cache()  # the ranks share the card with this process
    port = free_port()
    outs = [os.path.join(tmp, f"rank{r}.npz") for r in range(2)]
    log(f"multi-process: 2 ranks of {SHARDS // 2} slots on {dev}, backend gloo (NCCL refuses two "
        f"ranks on one GPU), {N_MP} rows")
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--mp-worker",
                               str(r), str(port), data_path, outs[r]],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        for r, p in enumerate(procs):
            out, _ = p.communicate(timeout=MP_TIMEOUT_S)
            for line in out.strip().splitlines()[-3:]:
                log(f"  rank {r}: {line}")
            if p.returncode != 0:
                fail(f"multi-process rank {r} exited with {p.returncode}:\n{out[-3000:]}")
    except subprocess.TimeoutExpired:
        fail(f"a multi-process rank ran past {MP_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    mp_s = time.perf_counter() - t0
    one = step("single-process 4-slot build", lambda: ShardedHNSWIndex.build(
        vecs[:N_MP], cfg, mesh))
    want = {"search": search_batches(lambda qb: one.search(qb, K, ef=EF), q_all),
            "scan": search_batches(lambda qb: one.scan_search(qb, K), q_all)}
    ranks = [np.load(o) for o in outs]
    for r, got in enumerate(ranks):
        if got["owners"].tolist() != [0] * (SHARDS // 2) + [1] * (SHARDS // 2):
            fail(f"rank {r}: mesh owners {got['owners'].tolist()}")
        for label in ("search", "scan"):
            if not np.array_equal(got[f"{label}_ids"], want[label][1]):
                fail(f"multi-process rank {r}: {label} ids differ from the single process")
            if not np.allclose(got[f"{label}_d"], want[label][0], rtol=1e-5, atol=1e-3):
                fail(f"multi-process rank {r}: {label} distances differ from the single process")
    mp_equal_d = all(np.array_equal(ranks[0][f"{lb}_d"], ranks[1][f"{lb}_d"])
                     for lb in ("search", "scan"))
    rec["multiprocess_search"] = recall(ranks[0]["search_ids"], oracle(x[:N_MP]))
    log(f"multi-process: both ranks' ids equal each other and the single process "
        f"(distances bit-equal across ranks: {mp_equal_d}); {mp_s:.1f} s for both ranks "
        f"(start, build, {nq} queries), recall@10 {rec['multiprocess_search']:.4f}")
    del one
    gc.collect()

    # ---- the multi-device dry run of entry.py, on the visible cards
    step("dryrun_multichip", lambda: dryrun_multichip(torch.cuda.device_count()))
    shutil.rmtree(tmp)
    phase_s = time.perf_counter() - t_phase
    log(f"sharded phase: {phase_s:.1f} s")
    return {
        "card": smi, "rows": N, "slots": [str(d) for d in mesh.devices], "queries": nq,
        "seconds": phase_s, "build_s": build_s, "paths": paths, "recall_at_10": rec,
        "per_shard_evals": evals, "profiles": profiles, "steps": steps,
        "insert": {"rows": N_INSERT, "rows_per_s": N_INSERT / ins_s, "self_hit_at_1": self_hit},
        "checkpoint_bytes": {"directory": ckpt_bytes, "vssdb": file_bytes},
        "multiprocess": {"ranks": 2, "backend": "gloo", "rows": N_MP, "seconds": mp_s},
    }


# ----------------------------------------------------------------------
# the builders


def timed_build(label, build, launches) -> tuple:
    """`build()` on the host clock, ending in a synchronize, with the launch
    counts zeroed just before it and read just after (and added to
    `launches`). Returns (index, seconds, counts)."""
    from vss_tpu_torch import csrc

    csrc.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = build()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = {k: v.launches for k, v in csrc.KERNELS.items()}
    for k, v in counts.items():
        launches[k] += v
    log(f"{label}: {seconds:.2f} s ({index.count / seconds:.0f} rows/s), {index.count} rows, "
        f"stats {index.build_stats}, launches {counts}")
    return index, seconds, counts


def batched_ids(fn, queries, batch=BATCH) -> np.ndarray:
    """The ids fn returns over the query batches, as numpy."""
    return torch.cat([fn(queries[s:s + batch])[1] for s in range(0, queries.shape[0], batch)]
                     ).cpu().numpy()


def graph_recall(index, queries, truth, ef) -> float:
    """recall@K of `index.search` at `ef` (row ids are rowids)."""
    return recall(batched_ids(lambda qb: index.search(qb, K, ef=ef), queries), truth)


def compare_builders(dev, vecs, q_all, launches) -> dict:
    """The three builders over the first N_BUILDERS rows of the flagship's
    corpus: native (the C++ host builder on every core), wave and exact
    (which takes its exact candidate pass below 131,072 rows). Seconds and
    recall@10 at ef=EF for each."""
    from vss_tpu_torch import HNSWConfig, HNSWIndex
    from vss_tpu_torch.ops import bruteforce_topk

    n = N_BUILDERS
    cfg = HNSWConfig(dims=D, metric="l2sq", storage_dtype="int8")
    xs = torch.from_numpy(vecs[:n]).to(dev)
    truth = batched_ids(lambda qb: bruteforce_topk(qb, xs, K, "l2sq", device=dev), q_all)
    out = {}
    for method in ("native", "wave", "exact"):
        index, seconds, counts = timed_build(
            f"{method} build of {n} rows", lambda: HNSWIndex.build(
                vecs[:n], cfg, method=method, wave_size=WAVE, device=dev), launches)
        if index.count != n:
            fail(f"the {method} build holds {index.count} rows, expected {n}")
        r = graph_recall(index, q_all, truth, EF)
        log(f"{method} build of {n} rows: recall@10 search ef={EF} {r:.4f}")
        out[method] = {"seconds": seconds, "recall_at_10": r, "launches": counts,
                       "stats": dict(index.build_stats)}
        del index
    if out["exact"]["stats"].get("mode") != "exact":
        fail(f"the exact build of {n} rows took mode {out['exact']['stats'].get('mode')}")
    for method, r in out.items():
        if r["recall_at_10"] < 0.9:
            fail(f"recall@10 of the {method}-built {n}-row index {r['recall_at_10']} < 0.9")
    return out


def iid_arm(dev, launches) -> dict:
    """bench.py's iid corpus (standard normal x 50, seed 7) cut to N_IID
    rows, m=48, built with `auto`: the IVF lists sample below the recall
    bar there, so the scan pass (K2) makes the candidate lists. Then
    recall@10 at the deep ef ladder of bench.py, and K2 timed at the
    build's shape (SCAN_BATCH queries over the tape)."""
    from vss_tpu_torch import HNSWConfig, HNSWIndex
    from vss_tpu_torch.ops import bruteforce_topk
    from vss_tpu_torch.ops import scan as s

    rng = np.random.default_rng(7)
    iv = rng.standard_normal((N_IID, D)).astype(np.float32) * 50.0
    iq = torch.from_numpy(rng.standard_normal((NQ, D)).astype(np.float32) * 50.0).to(dev)
    cfg = HNSWConfig(dims=D, metric="l2sq", storage_dtype="int8", m=48)
    index, seconds, counts = timed_build(f"iid auto build of {N_IID} rows, m=48",
                                         lambda: HNSWIndex.build(iv, cfg, device=dev), launches)
    stats = index.build_stats
    if stats.get("mode") != "hybrid" or not stats.get("scan_fallback"):
        fail(f"the iid build took {stats}; expected the hybrid mode with its scan fallback")
    if counts["native_segmin"] <= 1:
        fail(f"K2 was launched {counts['native_segmin']} times during the iid build: the scan "
             f"pass did not run on it")
    xs = torch.from_numpy(iv).to(dev)
    truth = batched_ids(lambda qb: bruteforce_topk(qb, xs, K, "l2sq", device=dev), iq)
    del xs
    recalls = {}
    for ef in IID_EFS:
        recalls[ef] = graph_recall(index, iq, truth, ef)
        log(f"iid: recall@10 search ef={ef} {recalls[ef]:.4f}")
    if min(recalls.values()) < 0.85:
        fail(f"iid recall@10 {recalls} < 0.85")
    # the descent kernel on this graph, whose upper rows hold m=48 ids:
    # three rounds of lane groups a step
    from vss_tpu_torch.index.graph import sample_levels

    iq_s = (iq / index.vector_scale).contiguous()
    descent_variant(f"iid graph (m=48), {BATCH} queries, stop 0", index.graph, index.config,
                    iq_s[:BATCH], 0)
    descent_variant(f"iid graph (m=48), {WAVE} queries, stop levels drawn as a wave's",
                    index.graph, index.config, iq_s[:WAVE], torch.from_numpy(
                        sample_levels(WAVE, cfg, seed=2)).to(dev))
    eq = iq_s[:64].clone()
    eq[5, 3] = float("nan")
    descent_edge_cases("iid graph (m=48)", index.graph, index.config, eq)
    # K2 at the build's shape: the scan pass's batch of tape rows as
    # queries, over the whole tape
    tape = index.graph.vectors[:N_IID]
    tn = (tape.float() ** 2).sum(-1)
    valid = torch.ones(N_IID, dtype=torch.bool, device=dev)
    qb = tape[:SCAN_BATCH].float().to(torch.bfloat16)
    got = s.native_segmin(qb[:1024], tape, tn, valid, "l2sq")
    want = s._native_segmin_plain(qb[:1024], tape, tn, valid, s.Metric.L2SQ)
    err = compare(f"K2 at the build's shape, first 1024 queries x int8 {N_IID} x {D}", got, want,
                  proxy_scale(qb[:1024], tape, "l2sq"))
    ms = cuda_ms(lambda: s.native_segmin(qb, tape, tn, valid, "l2sq"), 10)
    ops = 2.0 * SCAN_BATCH * N_IID * D
    bytes_moved = SCAN_BATCH * D * 2 + N_IID * (D + 4 + 1) + (N_IID // 32) * SCAN_BATCH * 4
    b_ms, b_by = bound(bytes_moved, ops, "bf16")
    log(f"K2 at the build's shape ({SCAN_BATCH} queries x int8 {N_IID} x {D}): kernel {ms:.4f} ms, "
        f"{ops / ms / 1e9:.1f} TFLOP/s, bound {b_ms:.4f} ms ({b_by}), max_abs_err {err:.6g}")
    return {"rows": N_IID, "m": 48, "build_seconds": seconds, "stats": dict(stats),
            "launches": counts, "recall_at_10": {str(k): v for k, v in recalls.items()},
            "k2_build_shape": {"queries": SCAN_BATCH, "ms": ms, "tflops": ops / ms / 1e9,
                               "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err}}


def gist_arm(dev, launches) -> dict:
    """`--gist`: bench.py's 960-d cosine arm, 1,000,000 x 960 clustered in
    [0, 1]^960 (500 centres, noise 0.12, absolute values), made on the card
    from a seed, built with `auto` into an int8 index; recall@10 at the
    arm's ef ladder against the exact oracle."""
    from vss_tpu_torch import HNSWConfig, HNSWIndex
    from vss_tpu_torch.ops import bruteforce_topk

    gd = 960
    gen = torch.Generator(device=dev).manual_seed(3)
    n_cent = max(64, N_GIST // 2000)
    cent = torch.rand((n_cent, gd), generator=gen, device=dev)
    gv = torch.empty((N_GIST, gd), device=dev)
    for s0 in range(0, N_GIST, 1 << 17):  # in slices: no second corpus-size temporary
        s1 = min(s0 + (1 << 17), N_GIST)
        ci = torch.randint(0, n_cent, (s1 - s0,), generator=gen, device=dev)
        gv[s0:s1] = (cent[ci] + 0.12 * torch.randn((s1 - s0, gd), generator=gen, device=dev)).abs()
    qi = torch.randint(0, n_cent, (2 * BATCH,), generator=gen, device=dev)
    gq = (cent[qi] + 0.12 * torch.randn((2 * BATCH, gd), generator=gen, device=dev)).abs()
    cfg = HNSWConfig(dims=gd, metric="cosine", storage_dtype="int8")
    index, seconds, counts = timed_build(f"gist auto build of {N_GIST} x {gd} cosine",
                                         lambda: HNSWIndex.build(gv, cfg, device=dev), launches)
    truth = batched_ids(lambda qb: bruteforce_topk(qb, gv, K, "cosine", device=dev), gq)
    recalls = {}
    for ef in (EF, 128, 192):
        recalls[ef] = graph_recall(index, gq, truth, ef)
        log(f"gist: recall@10 search ef={ef} {recalls[ef]:.4f}")
    return {"rows": N_GIST, "d": gd, "build_seconds": seconds, "stats": dict(index.build_stats),
            "launches": counts, "recall_at_10": {str(k): v for k, v in recalls.items()}}


def beam_serving(dev, vecs, queries, smi, path) -> int:
    """`--beam-serving FILE`: the beam_search kernel alone at the serving
    call, for comparing two checkouts' kernels in one session. The first
    run builds the 1M index with `auto` and saves its graph, the scaled
    queries and their pivot seeds to FILE; every run (this package's or
    another checkout's, with this script copied beside it) loads FILE and
    times three rounds of 10 launches of its own `_beam_launch`, and
    prints a digest of the result so that the runs can be held equal."""
    import hashlib

    from vss_tpu_torch import HNSWConfig, HNSWIndex, convert
    from vss_tpu_torch.index import search as sr
    from vss_tpu_torch.ops.gather import gather_distances

    cfg = HNSWConfig(dims=D, metric="l2sq", storage_dtype="int8")
    if not os.path.exists(path):
        idx = HNSWIndex.build(vecs, cfg, device=dev)
        q_scaled = (torch.from_numpy(queries[:BATCH]).to(dev) / idx.vector_scale).contiguous()
        pv_slots, pv_vecs = idx.pivots()
        seeds, _ = sr.pivot_seeds(idx.graph, cfg, q_scaled, pv_slots, pv_vecs, 4,
                                  (q_scaled * q_scaled).sum(-1))
        arrays = {f: getattr(idx.graph, f).cpu().numpy() for f in convert.GRAPH_FIELDS}
        np.savez(path, q=q_scaled.cpu().numpy(), seeds=seeds.cpu().numpy(), **arrays)
        del idx
    saved = np.load(path)
    g = convert.graph_from_arrays({f: saved[f] for f in convert.GRAPH_FIELDS}, device=dev)
    q = torch.from_numpy(saved["q"]).to(dev)
    seeds = torch.from_numpy(saved["seeds"]).to(dev)
    qn = (q * q).sum(-1)
    seed_d = gather_distances(g.vectors, seeds, q, cfg.metric, qn)
    mi = 4 + 2 * EF
    times = []
    for _ in range(3):
        sets = [sr._seed_pools(q, seeds, seed_d, EF, g.valid) for _ in range(11)]
        it = iter(sets)
        times.append(cuda_ms(lambda: sr._beam_launch(g, cfg, q, qn, next(it), EF, g.valid, 1, mi,
                                                     0, False, True), 10))
    digest = hashlib.sha256(sets[-1][0].cpu().numpy().tobytes()
                            + sets[-1][1].cpu().numpy().tobytes()).hexdigest()[:16]
    log(smi)
    log(json.dumps({"beam_serving_ms": times, "result_sha256_16": digest,
                    "package": os.path.dirname(os.path.abspath(sr.__file__))}))
    return 0


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
    ap.add_argument("--beam-serving", metavar="FILE", default=None,
                    help="time the beam_search kernel alone at the serving call over the 1M "
                         "index saved in FILE (built with auto and saved there first if FILE "
                         "is missing); prints its ms and a digest of its result and no result "
                         "line")
    ap.add_argument("--database-only", action="store_true",
                    help="run phase 7 (the Database) alone after the build, and print its "
                         "summary and no result line")
    ap.add_argument("--sharded-only", action="store_true",
                    help="run phase 8 (the sharded index) alone, with its own exact oracle, and "
                         "print its summary and no result line")
    ap.add_argument("--mp-worker", nargs=4, metavar=("RANK", "PORT", "DATA", "OUT"),
                    default=None, help=argparse.SUPPRESS)
    ap.add_argument("--gist", action="store_true",
                    help="also build and search the 1,000,000 x 960 cosine arm (made on the "
                         "card; adds minutes)")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from vss_tpu_torch import HNSWConfig, HNSWIndex, csrc
    from vss_tpu_torch.ops import bruteforce_topk

    if args.mp_worker:
        rank, port, data_path, out_path = args.mp_worker
        return mp_worker(int(rank), int(port), data_path, out_path)
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
    if args.beam_serving:
        libs = ["beam", "gather"]
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
    if args.beam_serving:
        return beam_serving(dev, vecs, queries, smi, args.beam_serving)
    out_dir = args.trace_dir or os.path.join(csrc.BUILD_DIR, "traces")
    if args.database_only:
        launches = {k: 0 for k in csrc.KERNELS}
        summary = database_phase(args.seed, dev, smi, vecs, queries, centers, launches,
                                 out_dir)
        log("database: " + json.dumps(summary))
        log(f"database launches: {launches}")
        return 0
    if args.sharded_only:
        launches = {k: 0 for k in csrc.KERNELS}
        q_all = torch.from_numpy(queries).to(dev)
        x = torch.from_numpy(vecs).to(dev)
        truth = batched_ids(lambda qb: bruteforce_topk(qb, x, K, "l2sq", device=dev), q_all)
        del x
        summary = sharded_phase(args.seed, dev, smi, vecs, queries, truth, centers, launches,
                                out_dir)
        log("sharded: " + json.dumps(summary))
        log(f"sharded launches: {launches}")
        return 0

    # ---- the main path begins with CREATE INDEX: the bulk build with
    # `auto` (on the card the exact builder in its hybrid mode), before the
    # kernel checks, which use its tapes. Launch counts are zeroed just
    # before each path of the main path and read just after it.
    launches = {k: 0 for k in csrc.KERNELS}
    cfg = HNSWConfig(dims=D, metric="l2sq", storage_dtype="int8")
    idx, build_s, build_counts = timed_build(
        f"auto build of {N} rows, M={cfg.m} m0={cfg.m0}", lambda: HNSWIndex.build(
            vecs, cfg, device=dev), launches)
    build_stats = dict(idx.build_stats)
    if idx.count != N:
        fail(f"index holds {idx.count} rows, expected {N}")
    if build_stats.get("mode") != "hybrid":
        fail(f"the auto build took {build_stats}; on the card it is the hybrid mode")
    from vss_tpu_torch.index.repair import reachable_mask

    unreached = N - int(reachable_mask(idx.graph).sum())
    build_stats["unreached_after_repair"] = unreached
    log(f"auto build: sampled IVF list recall@10 {build_stats['ivf_sampled_recall']:.4f}, scan "
        f"fallback {'ran' if build_stats['scan_fallback'] else 'did not run'}, "
        f"{build_stats['bridged']} nodes bridged by the repair, {unreached} of {N} still out of "
        f"reach of the entry over base-layer edges (64 sweeps)")
    # the sampled oracle runs the scan (K2); refine and the back-links
    # gather candidate rows (K5)
    for kname in ("native_segmin", "gather_rows"):
        if build_counts[kname] <= 0:
            fail(f"kernel {kname} was not launched by the auto build")

    x = torch.from_numpy(vecs).to(dev)
    q_all = torch.from_numpy(queries).to(dev)
    q = q_all[:BATCH].contiguous()
    q_scaled = (q / idx.vector_scale).contiguous()

    # ---- phase 3: kernels against their plain versions
    krng = np.random.default_rng(args.seed + 1)
    results = {
        "gather_distances": check_k1(dev, idx.graph.vectors, q_scaled, krng, out_dir),
        "native_segmin": check_k2(dev, idx.graph.vectors, idx.norms(), idx.graph.valid,
                                  q_scaled, krng),
        "scan_segmin": check_k3(dev, x, q, krng),
        "pairwise": check_k4(dev, x, q, krng),
        "gather_rows": check_k5(dev, idx.graph.vectors, idx.rerank_tape, idx.graph.adj0, krng,
                                out_dir),
        "beam_search": check_beam(dev, idx, q_scaled, krng),
    }
    # the first insert wave of phase 5: its generator, its seed
    wave_vecs = sift_like(np.random.default_rng(args.seed + 2), N_INSERT + N_RECYCLE, 0, D,
                          centers)[0][:WAVE]
    results["greedy_descent"] = check_descent(
        dev, idx, q_scaled, wave_vecs, krng, results["beam_search"]["dependent_read_ns"],
        out_dir)
    host_us = host_us_per_call(dev, idx.graph.vectors, idx.graph.adj0, q_scaled)
    torch.cuda.synchronize()

    # ---- phase 4: the main path, each sub-path with the counts zeroed
    # just before it and read just after
    # warm-up: one batch of each serving path (allocator, first launches)
    idx.scan_search(q, K)
    idx.search(q, K, ef=EF)
    torch.cuda.synchronize()
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
        f"recall@10 search ef={EF} {r_graph:.4f} (the same corpus built by the native builder: "
        f"{NATIVE_RECALL})")
    # where the time goes: one batch of each serving path under the profiler
    profiles = {
        "scan": profile_batch("scan_search k=10", lambda qb: idx.scan_search(qb, K), q,
                              scan_ms, out_dir),
        "graph": profile_batch(f"search k=10 ef={EF}", lambda qb: idx.search(qb, K, ef=EF), q,
                               graph_ms, out_dir),
    }
    summary = {
        "card": smi, "n": N, "d": D, "queries": NQ, "batch": BATCH,
        "build": {"method": "auto", "seconds": build_s, "stats": build_stats,
                  "launches": build_counts},
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
    summary["entry"] = entry_call(dev, launches, out_dir)

    # ---- phase 5: the write path, on the same index
    write = write_path(args.seed, idx, dev, smi, vecs, x, q_all, centers, launches, out_dir)
    log("write path: " + json.dumps(write))
    del idx

    # ---- phase 6: the builders side by side, the iid arm, and on request
    # the 960-d arm
    builds = {"builders": compare_builders(dev, vecs, q_all, launches),
              "iid": iid_arm(dev, launches)}
    if args.gist:
        builds["gist"] = gist_arm(dev, launches)
    log("builds: " + json.dumps(builds))
    results["native_segmin"]["build_shape"] = builds["iid"]["k2_build_shape"]

    # ---- phase 7: the Database, through SQL
    database = database_phase(args.seed, dev, smi, vecs, queries, centers, launches, out_dir)
    log("database: " + json.dumps(database))

    # ---- phase 8: the sharded index
    sharded = sharded_phase(args.seed, dev, smi, vecs, queries, gt_i, centers, launches, out_dir)
    log("sharded: " + json.dumps(sharded))

    # ---- phase 9: the kernel table and the last line
    meta = {
        "gather_distances": ("vss_tpu_torch/csrc/gather.cu", "vss_tpu/ops/gather.py:142"),
        "native_segmin": ("vss_tpu_torch/csrc/scan.cu", "vss_tpu/ops/scan.py:78"),
        "scan_segmin": ("vss_tpu_torch/csrc/topk.cu", "vss_tpu/ops/topk.py:134"),
        "pairwise": ("vss_tpu_torch/csrc/distance.cu", "vss_tpu/ops/distance.py:113"),
        "gather_rows": ("vss_tpu_torch/csrc/gather.cu", "vss_tpu/ops/gather.py:39"),
        "beam_search": ("vss_tpu_torch/csrc/beam.cu",
                        "vss_tpu/ops/gather.py:142 and :39 inside the loop of "
                        "vss_tpu/index/search.py:442"),
        "greedy_descent": ("vss_tpu_torch/csrc/descent.cu",
                           "vss_tpu/index/search.py:102-150, with vss_tpu/ops/gather.py:142 "
                           "(K1) and :39 (K5) inside its step"),
    }
    table = [
        {"name": kname, "route": "cuda", "source": meta[kname][0], "replaces": meta[kname][1],
         "launches": launches[kname], **results[kname]}
        for kname in ("gather_distances", "native_segmin", "scan_segmin", "pairwise",
                      "gather_rows", "beam_search", "greedy_descent")
    ]
    log(smi)
    log(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
