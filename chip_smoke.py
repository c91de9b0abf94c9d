#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`vss_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of the repository
    python3 chip_smoke.py --gist     # and the 1,000,000 x 960 cosine arm
    python3 chip_smoke.py --sharded-only   # phase 8 (the sharded index) alone
    python3 chip_smoke.py --select-k-only  # the select_k kernel alone
    python3 chip_smoke.py --pairwise-topk-only  # the pairwise_topk kernel alone
    python3 chip_smoke.py --pivot-seeds-only  # the pivot_seeds kernel alone
    python3 chip_smoke.py --pivot-product-only  # the pivot_product kernel alone
    python3 chip_smoke.py --witnesses-only  # the repeated-row witnesses alone
    python3 chip_smoke.py --rescore-only   # the rescore_topk kernel alone
    python3 chip_smoke.py --rerank-only    # the rerank_pool kernel alone
    python3 chip_smoke.py --k2-only        # K2 (native_segmin) alone
    python3 chip_smoke.py --k2-only --k2-parent DIR  # and DIR's K2 in turns

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
    of one level, an empty graph); then the select_neighbors kernel
    (`check_select`) against `_select_neighbors_plain`, the eager loop
    through K5, on the real candidate lists of the first insert wave
    (its selection and its base back-links), of the auto build's first
    chunk of each call, in each of the kernel's three layouts, and at the
    gist width (960-d cosine: int8, real-valued f32 and bf16 rows), with
    one launch and no host sync under sync debug mode "error"; then the
    select_k kernel (`check_select_k`) against `_select_k_plain`, values
    bit for bit and positions equal, at every call that one batch of each
    serving path of phase 4 makes (the scan's three selections, the pivot
    seeding, the winnow and its rescore, the chunked oracle's blocks with
    the mask and NaN options), in the layout the wrapper picks and the
    other, and at edge cases (ties, +-0, +-inf, NaN, k = C, C = 1, R = 0,
    k = 32 / 33 / 256), with one launch and no host sync; then the
    pairwise_topk kernel (`check_pairwise_topk`: K4's tile loop with the
    oracle's selection inside) against the K4 route it replaces (K4 blocks,
    select_k with the mask and NaN options, the stable merge, composed in
    this script), ids and distances bit for bit, at the k=100 oracle's
    batch over the whole tape and at the emulated tests' shapes, and
    against its plain version within the tolerance below; one launch and
    no host sync; its peak memory beside the route's; then the pivot_seeds
    kernel (`check_pivot_seeds`: the graph search's seeding after its
    product) against the route it replaces (`pivot_seeds` through
    select_k, then K1), seeds equal and distances bit for bit, at the
    serving shape (512 queries over the 1M index's pivots, each metric,
    both layouts), at one query, at a shard's pivots, at the sharded
    insert's wave and at the emulated tests' edge shapes, and against its
    plain version within the tolerance below; one launch and no host
    sync; then the rescore_topk kernel (`check_rescore`: the exact scan's
    phases B and C) against its plain version (`_rescore_chunks`) on the
    sub-segments that K2 and `_select_subsegments` keep for the flagship's
    queries at k = 1, 10, 32, 100 and 128, at one query (its segments over
    several blocks), in the other layout, under every metric, on an f32
    tape without a rerank tape, a bf16 tape and a ragged 70,037-row tape,
    within the tolerance below with ids equal up to near-ties; bit for bit
    on integer-valued queries and rerank rows; a control (phase C on
    bf16-rounded rerank rows) that must break the tolerance; one launch
    and no host sync; then the rerank_pool kernel (`check_rerank_pool`: the
    graph search's f32 rerank) against its plain version at the gist,
    openai, one-query and phase 4's two graph-path shapes and at pools of
    10,000, bit for bit on integer values, one launch and no host sync,
    and in a gist-shaped `HNSWIndex.search`. K1, K5, the
    descent kernel, the select kernels, pivot_seeds, rescore_topk and
    rerank_pool are timed by their device time from the
    profiler's trace, since their wrappers take longer on the host than
    the kernels on the card;
 4. build and serve the flagship: a SIFT-like synthetic corpus of
    1,000,000 x 128 (the generator of bench.py, seed 0) in an int8 index
    with the f32 rerank tape, built by `HNSWIndex.build` with `auto` (on
    the card the exact bulk builder in its hybrid mode: IVF candidate
    lists, a sampled check through the scan, K2, refine and back-links
    through K5, the connectivity repair), with 2,048 queries in batches
    of 512. The exact oracle (`bruteforce_topk`:
    K3 at k=10, pairwise_topk at k=100) gives the ground truth; at k=300
    over the first 65,536 rows it runs K4 and the plain selection, whose
    first 256 must equal pairwise_topk's at k=256; `scan_search` (K2,
    then one rescore_topk launch per batch) and the graph `search` at
    ef=64 (one pivot_seeds, one beam_search and one rerank_pool launch per
    batch) are scored by recall, and so is a search at
    ef=320 seeded from 300 pivots, past select_k's widest k, where the
    seeding is the route (`pivot_seeds` with the stable sort, then K1).
    Launch counters are zeroed just before each path and read just after
    it. The oracle at k=10 and the scans then
    run again with every selection by its plain version (`plain_selection`:
    k argmin passes, a stable sort) and with select_k, in turns, with ids
    and distances that must agree bit for bit, and one batch of each under
    the profiler; the scans again with the plain phases B and C
    (`plain_rescore`) before and rescore_topk after, ids equal up to
    near-ties and recall equal; the graph search the same way with the
    parent's seeding (`seeds_route`) before and pivot_seeds after; both
    graph paths (ef=64 and ef=320) with the plain rerank (`plain_rerank`)
    before and rerank_pool after, ids equal up to near-ties and recall
    equal; the k=100 oracle with
    the K4 route before and pairwise_topk after, with the peak memory of
    a batch of each. Then the forward call of `vss_tpu_torch.entry.entry()`
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
    step launches the descent and the select kernel, and the insert step
    no K1); one 1,024-row insert runs under the profiler for its idle
    share; the wave build runs again with `_select_neighbors_plain` in
    place of the kernel and must give the same adjacency (one sha256 for
    each);
 6. the builders: native (every host core), wave and exact over the
    first 131,071 rows of the corpus, each with its seconds and recall@10
    at ef=64; the iid arm of bench.py (standard normal x 50, seed 7) at
    262,144 x 128, m=48, built with `auto`, where the IVF lists fail their
    sampled check and the scan pass (K2) makes the candidate lists, with
    recall@10 at ef 512 and 768, the descent kernel against the eager
    loop on its m=48 upper rows, the select kernel against its plain
    version on the build's calls (m0=96), and K2 timed at the build's
    shape; with
    `--gist`, bench.py's 1,000,000 x 960 cosine arm, made on the card;
 7. the Database (`vss_tpu_torch.Database` on the card), driven through
    SQL at the flagship's width: the 1,000,000 x 128 corpus in a table,
    `CREATE INDEX ... USING HNSW ... storage='int8'`, 64 single-query
    statements through HNSW_INDEX_SCAN and `min_by`, equal to
    `index.search`; the 2,048-query LATERAL join through HNSW_INDEX_JOIN,
    equal to the batched `index.search`, recall@10 >= 0.85, timed and
    profiled; the same joins on an un-indexed copy (BRUTE_FORCE_TOPK,
    `knn_join` at k=10 through K3 and at k=100 through pairwise_topk,
    `vss_join`),
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
    oracle; `scan_search` with the plain selections and with select_k,
    and with the plain phases B and C and with rescore_topk,
    `search` with the parent's seeding and with pivot_seeds, in turns; the
    per-shard counters; insert 32,768 rows, delete `id % 5 =
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
reached, its distance bit for bit, its three counters). The select kernel
must give the plain version's ids wherever the sums are exact
(integer-valued rows, such as int8 rows, whose d max^2 stays under 2^24); on
real-valued rows a keep decision at a near-tie may go either way, so each
row that differs must have one within 1e-5 of the distances' magnitude of
its threshold, and no more rows may differ than differ between the plain
version on the card and on the host, plus 0.1%. Against the eager
loop on the CPU, whose
distances differ in the last digits, near-ties may order differently:
there recall@10 must agree within 0.002 and the top-10 ids for 0.99.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import ctypes
import hashlib
import inspect
import itertools
import json
import os
import re
import subprocess
import sys
import time
import types

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "f32": 67e12, "int8": 1979e12}
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
# check_select's gist-width shape: d, corpus rows, rows selected, candidates
SELECT_GIST = (960, 16384, 2048, 48)
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
    # f32 d=800: 64 queries do not fit beside the ring, so the queries are
    # streamed a slab at a time; int8 d=960: resident, 64 a tile, in slabs
    for dtype, d in ((torch.bfloat16, 128), (torch.float32, 128), (torch.int8, 100),
                     (torch.float32, 800), (torch.int8, 960)):
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
    # a batch at the GIST width, on the loop's last tape (int8, d=960: eight
    # slabs of 128 columns a tile, 64 queries a tile, eight query tiles)
    q960 = torch.from_numpy(rng.normal(size=(BATCH, 960)).astype(np.float32) * 5).to(
        dev, torch.bfloat16)
    ms960 = cuda_ms(lambda: s.native_segmin(q960, t, tn, v, "l2sq"), 20)
    tflops960 = 2.0 * BATCH * t.shape[0] * 960 / ms960 / 1e9
    log(f"  {BATCH} queries x int8 {t.shape[0]} x 960: kernel {ms960:.4f} ms, "
        f"{tflops960:.1f} TFLOP/s")
    # one query (a SQL statement's): bound by the tape's bytes
    ms1 = cuda_ms(lambda: s.native_segmin(qb[:1], tape, xn, valid, "l2sq"), 20)
    b1_ms, b1_by = bound(D * 2 + nx * (D + 5) + (nx // 32) * 4, 2.0 * nx * D, "bf16")
    log(f"  one query x int8 {nx} x {D}: kernel {ms1:.4f} ms, bound {b1_ms:.4f} ms ({b1_by})")
    # the bulk build's scan pass: SCAN_BATCH of its rows as queries over
    # the first N_IID rows
    tb = tape[:N_IID]
    qs = tb[:SCAN_BATCH].float().to(torch.bfloat16)
    vb = torch.ones(N_IID, dtype=torch.bool, device=dev)
    err_b = check(f"build shape, first 1024 of {SCAN_BATCH} queries x int8 {N_IID} x {D}",
                  qs[:1024], tb, xn[:N_IID], vb, "l2sq", proxy_scale(qs[:1024], tb, "l2sq"))
    ms_b = cuda_ms(lambda: s.native_segmin(qs, tb, xn[:N_IID], vb, "l2sq"), 10)
    ops_b = 2.0 * SCAN_BATCH * N_IID * D
    bb_ms, bb_by = bound(SCAN_BATCH * D * 2 + N_IID * (D + 5) + (N_IID // 32) * SCAN_BATCH * 4,
                         ops_b, "bf16")
    log(f"  build shape {SCAN_BATCH} queries x int8 {N_IID} x {D}: kernel {ms_b:.4f} ms, "
        f"{ops_b / ms_b / 1e9:.1f} TFLOP/s, bound {bb_ms:.4f} ms ({bb_by})")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                max_abs_err=errs["l2sq"], tflops=tflops, ms_d960=ms960, tflops_d960=tflops960,
                ms_one_query=ms1, bound_ms_one_query=b1_ms,
                build_shape={"queries": SCAN_BATCH, "rows": N_IID, "ms": ms_b,
                             "tflops": ops_b / ms_b / 1e9, "bound_ms": bb_ms,
                             "max_abs_err": err_b},
                ptxas=ptxas_entries("scan", "native_segmin_kernel"))


def ptxas_entries(lib: str, needle: str) -> list:
    """Registers, spill bytes and performance warnings of each kernel whose
    mangled name holds `needle`, from lib's build log (`nvcc -Xptxas -v`),
    logged and returned."""
    from vss_tpu_torch import csrc

    path = os.path.join(csrc.BUILD_DIR, f"{lib}.log")
    if not os.path.exists(path):  # built before this process, log kept
        return []
    entries, cur = [], None
    for line in open(path).read().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = {"entry": m.group(1), "warnings": []} if needle in m.group(1) else None
            if cur is not None:
                entries.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
        if "Performance" in line or "serialized" in line:
            cur["warnings"].append(line.strip())
    for e in entries:
        log(f"  ptxas {e['entry'][:60]}: {e.get('registers')} registers, spill "
            f"{e.get('spill_stores')} / {e.get('spill_loads')} bytes, warnings {e['warnings']}")
    return entries


def load_parent_k2(parent: str):
    """K2 of another checkout (`parent`/vss_tpu_torch/csrc/scan.cu, whose C
    entry takes K2's arguments), built by nvcc into _build/parent_k2/, as
    a ctypes function with K2's argument types."""
    import ctypes

    from vss_tpu_torch import csrc
    from vss_tpu_torch.ops import scan as s

    src_dir = os.path.join(os.path.abspath(parent), "vss_tpu_torch", "csrc")
    out_dir = os.path.join(csrc.BUILD_DIR, "parent_k2")
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, "libscan.so")
    t0 = time.perf_counter()
    subprocess.run([csrc._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                    "-O3", "-shared", "-Xcompiler", "-fPIC", "-I", src_dir, "-o", out,
                    os.path.join(src_dir, "scan.cu")], check=True, capture_output=True,
                   text=True, timeout=600)
    log(f"parent K2 from {src_dir} built in {time.perf_counter() - t0:.2f} s")
    fn = getattr(ctypes.CDLL(out), s._K2.symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = s._K2.argtypes + [csrc.PTR]
    return fn


@contextlib.contextmanager
def parent_k2(fn):
    """K2's launches go to `fn` (load_parent_k2's) while in place."""
    from vss_tpu_torch.ops import scan as s

    s._K2._entry()
    real = s._K2._fn
    s._K2._fn = fn
    try:
        yield
    finally:
        s._K2._fn = real


def k2_turns(label: str, call, old_fn, reps: int) -> dict:
    """`call` with the parent's K2 (before) and this one (after) in turns,
    before, after, after, before: device ms by CUDA events, each the mean of
    `reps` calls."""
    ms = {"before": [], "after": []}
    for which in ("before", "after", "after", "before"):
        with parent_k2(old_fn) if which == "before" else contextlib.nullcontext():
            ms[which].append(cuda_ms(call, reps))
    mean = {w: sum(v) / len(v) for w, v in ms.items()}
    log(f"{label}: parent's K2 {mean['before']:.4f} ms {[round(t, 4) for t in ms['before']]}, "
        f"this K2 {mean['after']:.4f} ms {[round(t, 4) for t in ms['after']]}")
    return {"before_ms": mean["before"], "after_ms": mean["after"], "runs": ms}


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


# ----------------------------------------------------------------------
# pairwise_topk: K4 with the exact oracle's selection inside

# rows of the slice over which the k=300 oracle (above SELECT_K_MAX: K4 and
# the plain selection) runs on the main path, so that K4 still launches there
N_K4_PATH = 65_536
# the shapes of tests/test_torch_pairtopk_emulated.py: nq, nx, d, k, slabs
PAIRTOPK_EDGE_SHAPES = [
    (37, 1001, 100, 100, 1), (37, 1001, 100, 100, 3), (130, 777, 32, 33, 2),
    (20, 2500, 16, 256, 4), (9, 515, 48, 1, 2), (9, 515, 48, 32, 5), (6, 70, 24, 100, 1),
    (6, 300, 24, 256, 3), (12, 2600, 16, 8, 10), (40, 3000, 32, 20, 8),
]


def k4_route(q, x, valid, k: int, metric: str):
    """The exact oracle's chunked path as the parent tree ran it on the
    card, composed here: K4 (`dispatch_pairwise`) on each `_choose_chunk`
    block of rows, `select_k` with the tombstones and NaN as +inf, and the
    stable merge (`_chunked_topk`)."""
    from vss_tpu_torch.ops import distance as dd
    from vss_tpu_torch.ops import topk as t3

    return t3._chunked_topk(
        q, x, valid, k, t3._choose_chunk(x.shape[0], q.shape[0]),
        lambda qq, xs, kk, vs: t3.select_k(dd.dispatch_pairwise(qq, xs, metric), kk, vs,
                                           nan_as_inf=True))


def k4_route_bruteforce(qb, x, k: int):
    """`bruteforce_topk(qb, x, k, "l2sq")` on its chunked path as the parent
    tree ran it: an all-true mask, then `k4_route`."""
    valid = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
    return k4_route(qb.float(), x.float(), valid, k, "l2sq")


def pairtopk_case(seed: int, nq: int, nx: int, d: int, dev):
    """Rows and queries as the emulated tests make them: real-valued, row 5
    repeated in the first and the last slab, a zero row, a zero query, a
    NULL query, half the queries near rows, a tenth of the rows
    tombstoned."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(nq, d)).astype(np.float32)
    x = rng.normal(size=(nx, d)).astype(np.float32)
    x[min(6, nx - 1)] = x[5 % nx]
    x[nx - 2] = x[5 % nx]
    x[min(7, nx - 1)] = 0.0
    q[min(2, nq - 1)] = 0.0
    q[min(1, nq - 1)] = np.nan
    q[nq // 2:] = x[rng.integers(0, nx, nq - nq // 2)] + rng.normal(
        scale=0.1, size=(nq - nq // 2, d)).astype(np.float32)
    valid = rng.random(nx) > 0.1
    valid[5 % nx] = True
    valid[nx - 2] = True
    return (torch.from_numpy(q).to(dev), torch.from_numpy(x).to(dev),
            torch.from_numpy(valid).to(dev))


def pairtopk_variant(label: str, q, x, k: int, metric: str, valid=None, slabs=None):
    """The pairwise_topk kernel against the K4 route on the same CUDA
    tensors: ids equal and distances bit for bit."""
    from vss_tpu_torch.ops import distance as dd
    from vss_tpu_torch.ops import topk as t3

    got = t3._pairwise_topk_launch(q, x, k, dd.Metric.parse(metric), valid, slabs)
    want = k4_route(q, x, valid, k, metric)
    torch.cuda.synchronize()
    if not torch.equal(got[1], want[1]):
        bad = int((got[1] != want[1]).any(1).sum())
        fail(f"pairwise_topk {label}: ids differ from the K4 route's in {bad} of "
             f"{q.shape[0]} rows")
    if not same_bits(got[0], want[0]):
        fail(f"pairwise_topk {label}: distances differ from the K4 route's")
    log(f"  {label}: {q.shape[0]} x {x.shape[0]} x {x.shape[1]}, k={k}, {metric}, slabs "
        f"{slabs or t3._pairwise_topk_slabs(q.shape[0], x.shape[0])}: equal (ids, distances "
        f"bit for bit)")
    return got


def device_ms_of(fn, reps: int, names, per_call: int, out_dir: str) -> float:
    """Mean device milliseconds a call of `fn` spends in the kernels whose
    names hold any of `names` (`per_call` of them a call), from the trace;
    fails unless the trace holds every launch (two retries)."""
    fn()
    for _ in range(3):
        kernels, lost = traced(lambda: [fn() for _ in range(reps)], out_dir,
                               "device_ms_" + "_".join(names))
        durs = [e["dur"] for e in kernels if any(n in e.get("name", "") for n in names)]
        if len(durs) == reps * per_call and not lost:
            return sum(durs) / reps / 1e3
    fail(f"device time of {names}: the profiler's trace lost launches three times")


def peak_mb(fn) -> float:
    """MB allocated at the peak of one call of `fn`, above what was
    allocated before it (`torch.cuda.max_memory_allocated`)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    del out
    return (torch.cuda.max_memory_allocated() - base) / 1e6


def check_pairwise_topk(dev, x, q, rng, out_dir) -> dict:
    """The pairwise_topk kernel against the K4 route it replaces, bit for
    bit: at the main shape (the k=100 oracle's batch over the whole tape,
    unmasked as `bruteforce_topk` calls it, with tombstones, and at k=256)
    and at the emulated tests' shapes for each metric, an all-masked tape,
    a tape of few distinct rows, rows that each come closer; against its
    plain version (`_pairwise_topk_plain`, cuBLAS products) within
    check_k4's tolerance; one launch and no host sync (the oracle's public
    call too); its device time from the trace (both launches) beside the
    K4 route's (K4 and select_k device time, and the route's CUDA-event
    time), the plain version's, `torch.cdist` + `torch.topk` (context: no
    one call computes the function), and the peak memory of a call of
    each."""
    from vss_tpu_torch.ops import bruteforce_topk
    from vss_tpu_torch.ops import distance as dd
    from vss_tpu_torch.ops import topk as t3

    log("pairwise_topk")
    k = K_DEEP
    nq, d = q.shape
    nx = x.shape[0]
    valid = torch.ones(nx, dtype=torch.bool, device=dev)
    got = pairtopk_variant("main", q, x, k, "l2sq", valid)
    tomb = torch.from_numpy(rng.random(nx) > 0.05).to(dev)
    pairtopk_variant("main, 5% tombstoned", q, x, k, "l2sq", tomb)
    pairtopk_variant("main", q, x, 256, "l2sq", valid)
    for nq_, nx_, d_, k_, slabs in PAIRTOPK_EDGE_SHAPES:
        qq, xx, vv = pairtopk_case(nq_ * 7 + nx_ + k_, nq_, nx_, d_, dev)
        for metric in ("l2sq", "cosine", "ip"):
            pairtopk_variant("edge", qq, xx, k_, metric, vv, slabs)
    qq, xx, _ = pairtopk_case(3, 5, 400, 16, dev)
    pairtopk_variant("all masked", qq, xx, 40, "l2sq", torch.zeros(400, dtype=torch.bool,
                                                                   device=dev), 3)
    few = torch.from_numpy(np.random.default_rng(5).normal(size=(5, 32)).astype(np.float32))
    xx = few[torch.from_numpy(np.random.default_rng(6).integers(0, 5, 900))].to(dev)
    qq = torch.from_numpy(np.random.default_rng(7).normal(size=(11, 32)).astype(np.float32)).to(
        dev)
    for k_, slabs in ((33, 1), (100, 4), (256, 4)):
        pairtopk_variant("five distinct rows", qq, xx, k_, "cosine", None, slabs)
    u = np.random.default_rng(8).normal(size=(1, 16)).astype(np.float32)
    xx = torch.from_numpy(u * np.linspace(50.0, 0.5, 1200, dtype=np.float32)[:, None]).to(dev)
    qq = torch.from_numpy(np.repeat(u * 0.25, 3, axis=0)).to(dev)
    for k_, slabs in ((33, 1), (256, 2)):
        pairtopk_variant("rows ever closer", qq, xx, k_, "l2sq", None, slabs)
    want = t3._pairwise_topk_plain(q, x, k, "l2sq", valid)
    err = compare("main against the plain version", got[0], want[0], dist_scale(q, x, "l2sq"))
    # where the ids differ, the distances in those slots agree within the
    # tolerance (compare above): rows at near-equal distances that the
    # other order of the sums swapped
    agree = float((got[1] == want[1]).float().mean())
    log(f"  main: ids equal to the plain version's in {agree:.6f} of the slots (cuBLAS sums "
        f"in another order; near-ties may swap)")
    if agree < 0.99:
        fail(f"pairwise_topk: ids agree with the plain version's in only {agree}")
    one_launch_no_sync(lambda: t3.pairwise_topk(q, x, k, "l2sq", valid), "pairwise_topk")
    one_launch_no_sync(lambda: bruteforce_topk(q, x, k, "l2sq", device=dev), "pairwise_topk")
    log("  pairwise_topk and bruteforce_topk(k=100) on CUDA tensors: one launch, no host sync")
    ms = device_ms_of(lambda: t3.pairwise_topk(q, x, k, "l2sq", valid), 10,
                      ["pairwise_topk_kernel", "pairwise_topk_merge"], 2, out_dir)
    merge_ms = device_ms_of(lambda: t3.pairwise_topk(q, x, k, "l2sq", valid), 10,
                            ["pairwise_topk_merge"], 1, out_dir)
    chunk = t3._choose_chunk(nx, nq)
    n_chunks = -(-nx // chunk)
    route_dev_ms = device_ms_of(lambda: k4_route(q, x, valid, k, "l2sq"), 5,
                                ["pairwise_kernel", "select_k_kernel"], 2 * n_chunks, out_dir)
    route_ms = cuda_ms(lambda: k4_route(q, x, valid, k, "l2sq"), 5)
    kernel_ms = cuda_ms(lambda: t3.pairwise_topk(q, x, k, "l2sq", valid), 10)
    plain_ms = cuda_ms(lambda: t3._pairwise_topk_plain(q, x, k, "l2sq", valid), 3)
    cdist_topk_ms = cuda_ms(lambda: torch.topk(
        torch.cdist(q, x, compute_mode="use_mm_for_euclid_dist"), k, dim=1, largest=False), 3)
    peak = peak_mb(lambda: t3.pairwise_topk(q, x, k, "l2sq", valid))
    route_peak = peak_mb(lambda: k4_route(q, x, valid, k, "l2sq"))
    if peak * 1e6 >= nq * chunk * 4:
        fail(f"pairwise_topk: {peak:.1f} MB at its peak, a [{nq}, {chunk}] block's worth")
    by_k = {kk: device_ms_of(lambda: t3.pairwise_topk(q, x, kk, "l2sq", valid), 5,
                             ["pairwise_topk_kernel", "pairwise_topk_merge"], 2, out_dir)
            for kk in (1, 32, 256)}
    route_by_k = {kk: cuda_ms(lambda: k4_route(q, x, valid, kk, "l2sq"), 3) for kk in (1, 32, 256)}
    bytes_moved = (nq + nx) * d * 4 + nx + nq * k * 8
    ops = 2.0 * nq * nx * d
    b_ms, b_by = bound(bytes_moved, ops, "f32")
    log(f"  {nq} x {nx} x {d}, k={k}: kernel {ms:.4f} ms device time (merge {merge_ms:.4f}; "
        f"{kernel_ms:.4f} ms by CUDA events), bound {b_ms:.4f} ms ({b_by}); K4 route: K4 + "
        f"select_k {route_dev_ms:.4f} ms device time, {route_ms:.4f} ms by CUDA events; plain "
        f"{plain_ms:.4f} ms; torch.cdist + torch.topk {cdist_topk_ms:.4f} ms; peak {peak:.1f} MB "
        f"(K4 route {route_peak:.1f} MB); k=1/32/256: {by_k} (K4 route {route_by_k})")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                max_abs_err=err, merge_ms=merge_ms, cuda_event_ms=kernel_ms,
                k4_route_device_ms=route_dev_ms, k4_route_ms=route_ms,
                cdist_topk_ms=cdist_topk_ms, peak_mb=peak, k4_route_peak_mb=route_peak,
                ids_equal_to_plain=agree, k=k, slabs=t3._pairwise_topk_slabs(nq, nx),
                ms_by_k=by_k, k4_route_ms_by_k=route_by_k)


def check_k5(dev, tape, rerank, adj0, rng, out_dir):
    """K5 against its plain version, bit for bit. The main shapes are the
    write path's: compaction permutes the grown tapes (twice the index's
    capacity: ascending kept slots, then a tail of zeros), the candidate
    gather of one wave's `_select_neighbors_plain`, W x (ef_construction +
    16) rows (on the card the select_neighbors kernel reads them itself),
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


def shared_read_ns(dev) -> float:
    """Nanoseconds of one dependent read from shared memory: one thread
    follows a random cycle through 12,288 int32 in shared memory
    (`vss_shared_chase` in csrc/probe.cu), the time of 40,000 steps less
    that of 20,000 (the copy into shared memory cancels), over 20,000."""
    import ctypes

    from vss_tpu_torch import csrc

    lib = csrc.load("probe")
    fn = lib.vss_shared_chase
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    n = 12288
    order = torch.randperm(n, device=dev)
    nxt = torch.empty(n, dtype=torch.int32, device=dev)
    nxt[order] = order.roll(-1).to(torch.int32)
    at = torch.zeros(1, dtype=torch.int32, device=dev)

    def chase(steps):
        rc = fn(nxt.data_ptr(), n, steps, at.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if rc:
            fail(f"shared-memory chase: launch failed ({rc})")

    ns = (cuda_ms(lambda: chase(40_000), 5) - cuda_ms(lambda: chase(20_000), 5)) * 1e6 / 20_000
    log(f"dependent read from shared memory: {ns:.2f} ns per step")
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
            pv_slots, pv_vecs, _ = index.pivots()
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
    pv_slots, pv_vecs, _ = idx.pivots()
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
    launch rate does not enter (`device_ms_of`)."""
    return device_ms_of(fn, reps, [kernel], 1, out_dir)


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


def one_launch_no_sync(fn, kname: str, n: int = 1) -> None:
    """`fn`, a public call on CUDA tensors, is one launch of kernel `kname`
    (n launches of it, where its entry launches once a part) and no host
    sync: under sync debug mode "error" PyTorch raises on a synchronizing
    call."""
    from vss_tpu_torch import csrc

    before = {k: v.launches for k, v in csrc.KERNELS.items()}
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    ran = {k: v.launches - before[k] for k, v in csrc.KERNELS.items() if v.launches != before[k]}
    if ran != {kname: n}:
        fail(f"{kname} on CUDA tensors launched {ran}, not {n} {kname}")


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

    for stop in (0, wave_stop):
        one_launch_no_sync(lambda: sr.greedy_descent(g, cfg, wq, stop_level=stop),
                           "greedy_descent")
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


@contextlib.contextmanager
def capture_select(calls: list, first_per_shape: bool = False):
    """Record the arguments of the builders' `select_neighbors` calls
    (index/build.py, index/exact_build.py and through it the sharded
    build) in `calls`, one dict each; with `first_per_shape` only the
    first call of each (candidates, slots, candidate vectors given). The
    calls themselves go on unchanged."""
    from vss_tpu_torch.index import build as wb
    from vss_tpu_torch.index import exact_build as eb
    from vss_tpu_torch.index import select as sl

    seen = set()
    raw = []

    def spy(*args, **kw):
        # cheap, since builds are timed with the spy in place: the key from
        # the callers' positions (cand_i, m; cand_vecs by keyword), the
        # arguments bound to their names after the build
        key = (args[1].shape[1], args[4], kw.get("cand_vecs") is not None)
        if not first_per_shape or key not in seen:
            seen.add(key)
            raw.append((args, kw))
        return sl.select_neighbors(*args, **kw)

    wb.select_neighbors = eb.select_neighbors = spy
    try:
        yield calls
    finally:
        wb.select_neighbors = eb.select_neighbors = sl.select_neighbors
        sig = inspect.signature(sl.select_neighbors)
        calls += [dict(sig.bind(*a, **k).arguments) for a, k in raw]


def _select_rows(call) -> torch.Tensor:
    return call["cand_vecs"] if call.get("cand_vecs") is not None else call["vectors"]


def exact_sums(call) -> bool:
    """Every dot product and norm of the call's rows is an exact integer in
    f32: integer-valued rows (int8 rows always) with d * max^2 under 2^24."""
    rows = _select_rows(call)
    x = rows.float()
    top = float(x.abs().max()) if x.numel() else 0.0
    return bool((x == x.round()).all()) and rows.shape[-1] * top * top < 2 ** 24


def _select_args(call):
    return (call["cand_i"], call["cand_d"], call["vectors"], call["m"], call["metric"])


def _select_kw(call):
    return {"active": call.get("active"), "cand_vecs": call.get("cand_vecs")}


def keep_margin(call, r: int, cd_sorted, kept) -> tuple:
    """The least gap |d - min over kept| of the keep decisions on the plain
    version's path through row r, relative to the threshold and absolute,
    the candidates' distances to each other recomputed in f64."""
    from vss_tpu_torch.index.select import _INF
    from vss_tpu_torch.ops.distance import Metric, _epilogue

    m = call["m"]
    ci, cdr = call["cand_i"][r], call["cand_d"][r]
    C = ci.numel()
    Cp = max(C, m)
    ci = torch.cat([ci, ci.new_full((Cp - C,), -1)])
    cdr = torch.where(ci >= 0, torch.cat([cdr, cdr.new_full((Cp - C,), _INF)]), _INF)
    order = torch.sort(cdr, stable=True).indices
    if call.get("cand_vecs") is not None:
        v = call["cand_vecs"][r].double()
        v = torch.cat([v, v.new_zeros((Cp - C, v.shape[1]))])[order]
    else:
        v = call["vectors"][ci[order].clamp(min=0).long()].double()
    n = (v * v).sum(-1)
    d64 = _epilogue(v @ v.T, n[:, None], n[None, :], Metric.parse(call["metric"])).cpu()
    dc = cd_sorted[r].double().cpu().tolist()
    kept_r = kept[r].cpu().tolist()
    held, rel, gap = [], float("inf"), float("inf")
    for s in range(Cp):
        if len(held) >= m or not np.isfinite(dc[s]):
            continue
        if held:
            dk = float(d64[s, held].min())
            rel = min(rel, abs(dc[s] - dk) / max(abs(dk), 1e-30))
            gap = min(gap, abs(dc[s] - dk))
        if kept_r[s]:
            held.append(s)
    return rel, gap


def select_scale(call) -> float:
    """The magnitude of the call's distances, as `dist_scale` takes it for
    the other kernels' checks: l2sq 2 max |x|^2, ip max |x|^2, cosine 1
    (over the candidate rows)."""
    metric = call["metric"]
    if metric == "cosine":
        return 1.0
    rows = _select_rows(call)
    ids = call["cand_i"].clamp(min=0).long()
    x = rows.float() if call.get("cand_vecs") is not None else rows[torch.unique(ids)].float()
    xn = float((x * x).sum(-1).max())
    return 2 * xn if metric == "l2sq" else xn


def plain_on_host(call) -> torch.Tensor:
    """`_select_neighbors_plain` on the call's inputs copied to the host
    (its sums in a third order)."""
    from vss_tpu_torch.index import select as sl

    return sl._select_neighbors_plain(
        *(t.cpu() if isinstance(t, torch.Tensor) else t
          for t in (call["q_vecs"], *_select_args(call))),
        **{k: None if t is None else t.cpu() for k, t in _select_kw(call).items()})


def select_verdict(call, out, want, stats, n_host: int) -> dict:
    """The limits for real-valued rows, where two versions sum in other
    orders and a keep decision at a near-tie may go either way: each row of
    `out` that differs from `want` must have a keep decision on `want`'s
    path within REL_TOL x the distances' magnitude (`select_scale`) of its
    threshold (`keep_margin`, in f64), and no more rows may differ than
    `n_host` (those that differ between the plain version on the card and
    on the host) plus 0.1% of the rows. Returns the readings and the limits
    broken (`faults`, empty when both hold)."""
    A = call["cand_i"].shape[0]
    diff = (out != want).any(1)
    n_diff = int(diff.sum())
    res = dict(rows=A, differ=n_diff, host_differ=n_host, tol=REL_TOL * select_scale(call),
               worst_gap=0.0, rel_max=0.0, rel_median=0.0, faults=[])
    if n_diff:
        gaps = [keep_margin(call, r, *stats) for r in torch.nonzero(diff)[:, 0].tolist()]
        res.update(worst_gap=max(g[1] for g in gaps), rel_max=max(g[0] for g in gaps),
                   rel_median=sorted(g[0] for g in gaps)[len(gaps) // 2])
    if res["worst_gap"] > res["tol"]:
        res["faults"].append(f"a row differs with no keep decision within {res['tol']:.3g} of "
                             f"its threshold (least gap {res['worst_gap']:.3g})")
    if n_diff > n_host + 0.001 * A:
        res["faults"].append(f"{n_diff} of {A} rows differ, more than the host's {n_host} + 0.1%")
    return res


def verdict_line(v: dict) -> str:
    return (f"{v['differ']} of {v['rows']} rows differ (the plain version on the host: "
            f"{v['host_differ']}); the least keep-decision gap of each row, absolute: largest "
            f"{v['worst_gap']:.3g} (tol {v['tol']:.3g}); relative: largest {v['rel_max']:.3g}, "
            f"median {v['rel_median']:.3g}")


def select_variant(label: str, call, layout=None) -> tuple:
    """The select_neighbors kernel against `_select_neighbors_plain` on the
    call's inputs, through `_select_launch` (a forced `layout`, or the one
    the kernel picks) and, without a forced layout, the public
    `select_neighbors`. With exact sums (`exact_sums`) the ids must equal,
    row for row; otherwise `select_verdict`'s limits hold. Returns the
    plain version's (sorted distances, kept), the rows that differ and
    (real-valued rows) the verdict."""
    from vss_tpu_torch.index import select as sl

    stats = []
    want = sl._select_neighbors_plain(call["q_vecs"], *_select_args(call), stats=stats,
                                      **_select_kw(call))
    outs = [("_select_launch", sl._select_launch(*_select_args(call), layout=layout,
                                                 **_select_kw(call)))]
    if layout is None:
        outs.append(("select_neighbors", sl.select_neighbors(call["q_vecs"], *_select_args(call),
                                                             **_select_kw(call))))
    torch.cuda.synchronize()
    A = call["cand_i"].shape[0]
    exact = exact_sums(call)
    n_diff, verdict, n_host = 0, None, None
    for entry, out in outs:
        if out.shape != want.shape or out.dtype != want.dtype:
            fail(f"select_neighbors {label}, {entry}: {tuple(out.shape)} {out.dtype} != "
                 f"{tuple(want.shape)} {want.dtype}")
        n_diff = int((out != want).any(1).sum())
        if exact and n_diff:
            fail(f"select_neighbors {label}, {entry}: {n_diff} of {A} rows differ from the plain "
                 f"version's (exact sums)")
        if not exact:
            if n_host is None:
                n_host = int((plain_on_host(call) != want.cpu()).any(1).sum())
            verdict = select_verdict(call, out, want, stats[0], n_host)
            log(f"  {label}, {entry}: " + verdict_line(verdict))
            if verdict["faults"]:
                fail(f"select_neighbors {label}, {entry}: " + "; ".join(verdict["faults"]))
    rows = _select_rows(call)
    log(f"  {label}: {A} rows x {call['cand_i'].shape[1]} candidates, m={call['m']}, "
        f"{rows.dtype} d={rows.shape[-1]} {call['metric']}, layout "
        f"{'auto' if layout is None else layout}: "
        + ("ids equal (exact sums)" if exact else
           f"{A - n_diff} of {A} rows equal, {n_diff} differ"
           + (" (each at a near-tie)" if n_diff else "")))
    return stats[0], n_diff, verdict


def select_controls(label: str, call, stats, n_host: int) -> dict:
    """Two versions of lower precision than the kernel, each held to
    `select_verdict`'s limits in its place: the plain version with the
    rows rounded to bf16, and with its candidate-to-candidate products in
    TF32. Each must break a limit, or the limits would pass such a kernel
    too. Returns their verdicts."""
    from vss_tpu_torch.index import select as sl

    want = sl._select_neighbors_plain(call["q_vecs"], *_select_args(call), **_select_kw(call))
    rounded = dict(call)
    key = "cand_vecs" if call.get("cand_vecs") is not None else "vectors"
    rounded[key] = call[key].bfloat16().float()
    outs = {"rows rounded to bf16": sl._select_neighbors_plain(
        rounded["q_vecs"], *_select_args(rounded), **_select_kw(rounded))}
    precision = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")  # TF32 in the batched product
    try:
        outs["products in TF32"] = sl._select_neighbors_plain(
            call["q_vecs"], *_select_args(call), **_select_kw(call))
    finally:
        torch.set_float32_matmul_precision(precision)
    verdicts = {}
    for name, out in outs.items():
        v = select_verdict(call, out, want, stats, n_host)
        log(f"  {label}, control ({name}): " + verdict_line(v) + ": "
            + ("; ".join(v["faults"]) if v["faults"] else "no limit broken"))
        if not v["faults"]:
            fail(f"select_neighbors {label}: the control with {name} breaks no limit, so the "
                 f"limits cannot tell such a kernel from a sound one")
        verdicts[name] = {k: v[k] for k in ("differ", "worst_gap", "tol", "host_differ")}
    return verdicts


def select_timing(label: str, call, stats, smem_ns: float, out_dir: str) -> dict:
    """The kernel's device time at the call's shape (torch.profiler's
    trace), the time between CUDA events around 20 wrapper calls, the eager
    loop's wall time, the bound and the dependent-step floor. Bound: each
    distinct candidate row (each given candidate vector) of the active rows
    with a finite distance read once, ids and distances read and ids written
    once; the multiply-adds that a decision reads (each kept candidate but
    the m-th against each later finite one up to the row's last decision)
    and the norms of the finite candidates up to it, at the peak rate of
    the rows' type (int8 rows at the int8 rate; bf16 and f32 rows are
    multiplied in f32). Floor: the longest row's chain, a dependent read of
    shared memory for each decision (until the m-th keep) and each keep."""
    from vss_tpu_torch.index import select as sl

    cd, kept = stats
    A, Cp = cd.shape
    m = call["m"]
    rows = _select_rows(call)
    d = rows.shape[-1]
    act = call.get("active")
    act = torch.ones(A, dtype=torch.bool, device=cd.device) if act is None else act
    keeps = kept & act[:, None]
    reached = keeps.int().cumsum(1) >= m
    # positions 0 .. visited-1 of a row are decided: up to its m-th keep
    visited = torch.where(reached.any(1), reached.int().argmax(1) + 1, Cp)
    decided = torch.arange(Cp, device=cd.device)[None, :] < visited[:, None]
    fin = torch.isfinite(cd) & act[:, None] & decided
    after = fin.flip(1).int().cumsum(1).flip(1) - fin.int()
    products = int((after * (keeps & ~reached)).sum())
    ops = 2.0 * d * (products + int(fin.sum()))
    kind = "int8" if rows.dtype == torch.int8 else "f32"
    chain = int(torch.where(act, visited + keeps.sum(1), 0).max()) if A else 0
    ci = call["cand_i"]
    live = (ci >= 0) & torch.isfinite(call["cand_d"]) & act[:, None]
    row_bytes = d * rows.element_size()
    if call.get("cand_vecs") is not None:
        n_rows = int(live.sum())
    else:
        n_rows = int(torch.unique(ci[live]).numel())
    C = ci.shape[1]
    bytes_moved = n_rows * row_bytes + A * C * 8 + A * m * 4 + A
    b_ms, b_by = bound(bytes_moved, ops, kind)
    floor_ms = chain * smem_ns / 1e6
    args, kw = _select_args(call), _select_kw(call)
    ms = device_ms(lambda: sl._select_launch(*args, **kw), 20, "select_kernel", out_dir)
    event_ms = cuda_ms(lambda: sl._select_launch(*args, **kw), 20)
    plain_times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sl._select_neighbors_plain(call["q_vecs"], *args, **kw)
        torch.cuda.synchronize()
        plain_times.append((time.perf_counter() - t0) * 1e3)
    plain_ms = min(plain_times)
    log(f"  {label}: kernel {ms:.4f} ms device time ({event_ms:.4f} ms between CUDA events "
        f"around 20 wrapper calls), eager loop {plain_ms:.3f} ms wall, bound {b_ms:.5f} ms "
        f"({b_by}: {bytes_moved} B, {n_rows} rows of {row_bytes} B, {ops:.4g} {kind} operations, "
        f"{products} products of the keeps), dependent-step floor {floor_ms:.5f} ms ({chain} "
        f"steps x {smem_ns:.2f} ns), {int(keeps.sum())} keeps over {int(act.sum())} active rows")
    return dict(shape=label, rows=A, candidates=C, m=m, ms=ms, event_ms=event_ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, bytes=bytes_moved, ops=ops,
                ops_kind=kind, floor_ms=floor_ms, floor_steps=chain, keeps=int(keeps.sum()),
                active_rows=int(act.sum()))


def select_build_calls(name: str, calls, m0: int, smem_ns: float, out_dir: str) -> list:
    """`select_variant` on a bulk build's captured calls (`capture_select`
    with `first_per_shape`); the refine chunk (m0 slots, no candidate
    vectors) also timed. Returns its `select_timing`."""
    shapes = []
    for call in calls:
        A, C = call["cand_i"].shape
        given = call.get("cand_vecs") is not None
        stats = select_variant(f"{name}: first chunk of {A} x {C}, m={call['m']}"
                               + (", candidate vectors given" if given else ""), call)[0]
        if call["m"] == m0 and not given:
            shapes.append(select_timing(f"{name} refine chunk {A} x {C}, m={call['m']}, f32",
                                        call, stats, smem_ns, out_dir))
    return shapes


def wave_select_calls(idx, wave_vecs) -> tuple:
    """The select_neighbors calls of one WAVE-row insert of `wave_vecs`
    into a clone of `idx`: (the base level's selection, the base
    back-links' re-selection)."""
    calls = []
    clone = idx.clone()
    with capture_select(calls):
        clone.insert(wave_vecs[:WAVE], np.arange(4 * N, 4 * N + WAVE))
    torch.cuda.synchronize()
    m0 = idx.config.m0
    i0 = next(i for i, c in enumerate(calls) if c["m"] == m0)
    return calls[i0 - 1], calls[i0]


def check_select(dev, idx, wave_vecs, build_calls, smem_ns: float, out_dir: str) -> dict:
    """The select_neighbors kernel against `_select_neighbors_plain`
    (`select_variant`) at the main path's shapes, with real candidate
    lists: the first insert wave's base-level selection (WAVE x 144, m=16)
    and base back-links (its rows x 48, cap 32, the overflow rows active),
    taken from one wave inserted into a clone of the 1M index; the first
    chunk of each of the auto build's calls (`build_calls`: refine, upper
    levels, back-links with candidate vectors); each layout forced at the
    wave's shape; the gist width (d=960, cosine) on a synthetic clustered
    corpus: int8 tape rows, real-valued f32 candidate vectors (in each
    layout) and a real-valued bf16 tape. The wave, back-link and refine
    shapes are timed (`select_timing`)."""
    from vss_tpu_torch.index import select as sl

    log("select_neighbors")
    wave_call, back_call = wave_select_calls(idx, wave_vecs)
    if tuple(wave_call["cand_i"].shape) != (WAVE, idx.config.ef_construction + 16):
        fail(f"select_neighbors: the wave's selection has candidates "
             f"{tuple(wave_call['cand_i'].shape)}")
    shapes = []
    stats = select_variant(f"wave: {WAVE} x 144, m=16", wave_call)[0]
    shapes.append(select_timing(f"wave {WAVE} x 144, m=16, int8", wave_call, stats, smem_ns,
                                out_dir))
    for layout in (1, 2):
        select_variant(f"wave, layout {layout} forced", wave_call, layout=layout)
    n_active = int(back_call["active"].sum())
    stats = select_variant(f"base back-links: {back_call['cand_i'].shape[0]} x 48, cap 32, "
                           f"{n_active} overflow rows active", back_call)[0]
    shapes.append(select_timing(f"base back-links {back_call['cand_i'].shape[0]} x 48, cap 32",
                                back_call, stats, smem_ns, out_dir))
    shapes += select_build_calls("auto build", build_calls, idx.config.m0, smem_ns, out_dir)
    one_launch_no_sync(lambda: sl.select_neighbors(wave_call["q_vecs"], *_select_args(wave_call),
                                                   **_select_kw(wave_call)), "select_neighbors")
    log("  select_neighbors on CUDA tensors: one launch, no host sync (sync debug mode "
        "\"error\")")
    gist = select_gist_width(dev)
    wave = shapes[0]
    return dict(ms=wave["ms"], plain_ms=wave["plain_ms"], bound_ms=wave["bound_ms"],
                bound_by=wave["bound_by"], library_ms=None, max_abs_err=0.0,
                floor_ms=wave["floor_ms"], shared_read_ns=smem_ns, shapes=shapes, gist=gist)


def select_gist_width(dev) -> dict:
    """`select_variant` at the gist width (SELECT_GIST: d=960, cosine) on
    a synthetic clustered corpus with kNN candidate lists: int8 tape rows,
    real-valued f32 candidate vectors (in each layout) and a real-valued
    bf16 tape; on the f32 rows, `select_controls`. Returns the real-valued
    variants' verdicts and the controls'."""
    from vss_tpu_torch.ops import bruteforce_topk
    from vss_tpu_torch.ops.distance import gathered_distances

    gd, gn, ga, gc = SELECT_GIST
    gen = torch.Generator(device=dev).manual_seed(5)
    cent = torch.rand((64, gd), generator=gen, device=dev)
    gv = (cent[torch.randint(0, 64, (gn,), generator=gen, device=dev)]
          + 0.12 * torch.randn((gn, gd), generator=gen, device=dev)).abs()
    g8 = (gv / gv.abs().max() * 127).round().to(torch.int8)
    _, knn = bruteforce_topk(g8[:ga].float(), g8.float(), gc + 1, "cosine", device=dev)
    ci = knn[:, 1:].to(torch.int32).contiguous()
    base = dict(q_vecs=gv[:ga], cand_i=ci, m=32, metric="cosine")
    call = dict(base, vectors=g8, cand_d=gathered_distances(
        g8[:ga].float(), g8[ci.long()].float(), "cosine"))
    select_variant(f"gist width: int8 tape, {ga} x {gc}, d={gd}", call)
    cv = gv[ci.long()]
    call = dict(base, vectors=gv, cand_vecs=cv, cand_d=gathered_distances(gv[:ga], cv, "cosine"))
    label = f"gist width: real-valued f32 candidate vectors, {ga} x {gc}, d={gd}"
    verdicts = {}
    for layout in (None, 1, 2):
        stats, _, v = select_variant(label + ("" if layout is None else
                                              f", layout {layout} forced"), call, layout=layout)
        verdicts[f"f32, layout {layout}"] = {k: v[k] for k in ("differ", "worst_gap", "tol",
                                                               "host_differ")}
        if layout is None:
            controls = select_controls(label, call, stats, v["host_differ"])
    gb = gv.to(torch.bfloat16)
    call = dict(base, vectors=gb, cand_d=gathered_distances(gv[:ga], gb[ci.long()].float(),
                                                            "cosine"))
    v = select_variant(f"gist width: real-valued bf16 tape, {ga} x {gc}, d={gd}", call)[2]
    verdicts["bf16"] = {k: v[k] for k in ("differ", "worst_gap", "tol", "host_differ")}
    return dict(verdicts=verdicts, controls=controls)


# ----------------------------------------------------------------------
# the select_k kernel: the k smallest of each row, after K2, K3 and K4

# the callers of select_k on the main path, by function, and what each call
# is (scan_topk's phase-B selection runs inside rescore_topk)
SELECT_K_SITES = {
    "_select_subsegments": "scan_topk's segment selections (ops/scan.py:121 supers, :128 subs)",
    "bruteforce_topk": "the oracle's winnow (ops/topk.py, segments to rescore)",
    "_rescore_block": "the oracle's winnow rescore",
}
# the shapes of those calls at the flagship (512 queries, 1,000,000 rows),
# for `--select-k-only`, which makes them from random data: (site, rows,
# columns, k, masked and NaN as +inf)
SELECT_K_SHAPES = [
    ("_select_subsegments", 512, 7813, 12, False), ("_select_subsegments", 512, 48, 12, False),
    ("_select_subsegments", 512, 7813, 112, False), ("_select_subsegments", 512, 448, 112, False),
    ("bruteforce_topk", 512, 7813, 10, False), ("_rescore_block", 512, 1280, 10, False),
]


@contextlib.contextmanager
def capture_select_k(calls: dict):
    """Record the first `select_k` call of each (caller, shape, k, options)
    made while in place, with clones of its inputs, in `calls`; the calls
    go on unchanged. The caller is the function that called
    `_select_min_k` or `select_k`."""
    from vss_tpu_torch.ops import topk

    real = topk.select_k

    def spy(d, k, valid=None, nan_as_inf=False):
        frame = sys._getframe(1)
        if frame.f_code.co_name == "_select_min_k":
            frame = frame.f_back
        site = frame.f_code.co_name
        key = (site, tuple(d.shape), k, valid is not None, nan_as_inf)
        if key not in calls:
            calls[key] = dict(site=site, d=d.clone(), k=k, nan_as_inf=nan_as_inf,
                              valid=None if valid is None else valid.clone())
        return real(d, k, valid, nan_as_inf)

    topk.select_k = spy
    try:
        yield calls
    finally:
        topk.select_k = real


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal to the last bit, NaN payloads and the sign of zero included."""
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def select_k_variant(label: str, d, k: int, valid=None, nan_as_inf=False, splits=None,
                     reference=None) -> None:
    """The select_k kernel (through `_select_k_launch`, with `splits` blocks
    a row or the wrapper's choice) against `_select_k_plain` on the same CUDA
    tensors (or against `reference`, a plain result computed elsewhere):
    values bit for bit, positions equal."""
    from vss_tpu_torch.ops import topk

    got = topk._select_k_launch(d, k, valid, nan_as_inf, splits)
    want = reference or topk._select_k_plain(d, k, valid, nan_as_inf)
    torch.cuda.synchronize()
    if not torch.equal(got[1], want[1].to(got[1].device)):
        bad = int((got[1] != want[1].to(got[1].device)).any(1).sum())
        fail(f"select_k {label}: positions differ from the plain version's in {bad} of "
             f"{d.shape[0]} rows")
    if not same_bits(got[0], want[0].to(got[0].device)):
        fail(f"select_k {label}: values differ from the plain version's")
    R, C = d.shape
    log(f"  {label}: {R} x {C}, k={k}, splits "
        f"{topk._select_k_splits(R, C) if splits is None else splits}"
        f"{', masked' if valid is not None else ''}{', NaN as +inf' if nan_as_inf else ''}: "
        f"equal (values bit for bit, positions)")


def select_k_rows(seed: int, R: int, C: int, kind: str, dev):
    """f32 [R, C] rows on `dev`: "normal" N(0, 1); "ties" small integers;
    "edge" small integers with +-0, +-inf and NaN among them, a row of
    NaN, a row of +inf and one with three values below +inf (as
    tests/test_torch_selectk_emulated.py makes them, every NaN positive:
    the one a card's arithmetic makes)."""
    rng = np.random.default_rng(seed)
    if kind == "normal":
        return torch.from_numpy(rng.normal(size=(R, C)).astype(np.float32)).to(dev)
    x = rng.integers(-3, 4, (R, C)).astype(np.float32)
    if kind == "edge":
        u = rng.random((R, C))
        x[u < 0.1] = -0.0
        x[(u >= 0.1) & (u < 0.2)] = 0.0
        x[(u >= 0.2) & (u < 0.25)] = np.inf
        x[(u >= 0.25) & (u < 0.28)] = -np.inf
        x[(u >= 0.28) & (u < 0.33)] = np.nan
        if R >= 4:
            x[1] = np.nan
            x[2] = np.inf
            x[3] = np.inf
            x[3, rng.choice(C, min(C, 3), replace=False)] = -1.0
    return torch.from_numpy(x).to(dev)


def select_k_edge_cases(dev) -> None:
    """`select_k_variant` at the edge cases of the emulated tests, in both
    orders and both layouts: ties, +-0, +-inf, NaN (some and all), rows of
    +inf; k = C, k = 1, k = 32 / 33 / 256, C = 1, R = 0, k = 0; the mask
    and NaN options; rows falling from start to end (every value passes
    the running threshold). A NaN with its sign bit set (a host's NaN) is
    held against the plain version on the host, and whether the plain
    version on the card agrees is logged."""
    from vss_tpu_torch.ops import topk

    for kind in ("ties", "edge"):
        for R, C, k, splits in ((3, 1, 1, 1), (4, 40, 40, 1), (4, 20, 20, 1), (4, 300, 150, 7),
                                (2, 9, 9, 9), (5, 77, 1, 1), (0, 50, 10, 1), (3, 50, 0, 1),
                                (4, 3000, 32, 1), (4, 3000, 32, 3), (4, 3000, 33, 1),
                                (4, 3000, 33, 3), (3, 2500, 256, 1), (3, 2500, 256, 2)):
            d = select_k_rows(R * 7 + C + k, R, C, kind, dev)
            select_k_variant(f"{kind}", d, k, splits=splits)
    d = select_k_rows(11, 4, 2600, "edge", dev)
    valid = torch.from_numpy(np.random.default_rng(3).random(2600) > 0.3).to(dev)
    valid[:5] = False
    for k in (1, 10, 32, 33, 100):
        for splits in (1, 3):
            select_k_variant("edge", d, k, valid=valid, splits=splits)
            select_k_variant("edge", d, k, nan_as_inf=True, splits=splits)
            select_k_variant("edge", d, k, valid=valid, nan_as_inf=True, splits=splits)
    select_k_variant("all masked", d, 40, valid=torch.zeros_like(valid), splits=2)
    falling = -torch.arange(6000, dtype=torch.float32, device=dev).repeat(2, 1)
    for k, splits in ((7, 1), (150, 1), (150, 2)):
        select_k_variant("falling rows", falling, k, splits=splits)
    neg = select_k_rows(12, 4, 500, "edge", dev)
    neg[:, ::17] = -float("nan")
    for k in (10, 60):
        host = topk._select_k_plain(neg.cpu(), k)
        card = topk._select_k_plain(neg, k)
        agree = torch.equal(card[1].cpu(), host[1]) and same_bits(card[0].cpu(), host[0])
        select_k_variant(f"NaN with the sign bit set (the plain version on the card "
                         f"{'agrees' if agree else 'differs'})", neg, k, reference=host)


def select_k_timing(label: str, call, out_dir: str) -> dict:
    """The kernel's device time at the call's shape (torch.profiler's
    trace, 20 launches), the plain version's and `torch.topk(largest=False,
    sorted=True)`'s (CUDA events; not stable, so no port of the kernel,
    but the library's yardstick), and the bound: each value read once, the
    mask read once, the values and positions written once, over 3.35
    TB/s (a compare a value is far below the f32 rate's time)."""
    from vss_tpu_torch.ops import topk

    d, k, valid, nan = call["d"], call["k"], call["valid"], call["nan_as_inf"]
    R, C = d.shape
    bytes_moved = R * C * 4 + (C if valid is not None else 0) + R * k * 8
    b_ms, b_by = bound(bytes_moved, float(R * C), "f32")
    ms = device_ms(lambda: topk.select_k(d, k, valid, nan), 20, "select_k_kernel", out_dir)
    big = R * C > 1 << 26
    plain_ms = cuda_ms(lambda: topk._select_k_plain(d, k, valid, nan), 3 if big else 10)
    lib_ms = cuda_ms(lambda: torch.topk(d, k, dim=1, largest=False, sorted=True),
                     5 if big else 20)
    log(f"  {label}: kernel {ms:.5f} ms device time, bound {b_ms:.5f} ms ({b_by}, "
        f"{bytes_moved} B), plain {plain_ms:.4f} ms, torch.topk {lib_ms:.4f} ms")
    return dict(shape=label, site=call["site"], rows=R, columns=C, k=k,
                masked=valid is not None, ms=ms, bound_ms=b_ms, bound_by=b_by,
                plain_ms=plain_ms, library_ms=lib_ms, splits=topk._select_k_splits(R, C))


def check_select_k(dev, calls: dict, out_dir: str) -> dict:
    """The select_k kernel against `_select_k_plain` on the card
    (`select_k_variant`) at every captured call (`capture_select_k`: one
    batch of each path of phase 4, or `SELECT_K_SHAPES` made from random
    data), in the layout the wrapper picks and in the other one; the edge
    cases (`select_k_edge_cases`); one launch and no host sync under sync
    debug mode "error"; each call's times (`select_k_timing`). The scan's
    first selection (512 x 7,813, k=12) heads the kernel table."""
    from vss_tpu_torch.ops import topk

    log("select_k")
    shapes = []
    for call in calls.values():
        d, k, valid, nan = call["d"], call["k"], call["valid"], call["nan_as_inf"]
        R, C = d.shape
        label = f"{call['site']} {R} x {C}, k={k}"
        select_k_variant(label, d, k, valid, nan)
        auto = topk._select_k_splits(R, C)
        select_k_variant(label + ", other layout", d, k, valid, nan,
                         splits=1 if auto > 1 else max(2, min(8, C // 2048)))
        shapes.append(select_k_timing(label, call, out_dir))
    select_k_edge_cases(dev)
    head = next(c for c in calls.values() if c["site"] == "_select_subsegments")
    one_launch_no_sync(lambda: topk._select_min_k(head["d"], head["k"]), "select_k")
    chunk = [c for c in calls.values() if c["valid"] is not None]
    if chunk:
        c = chunk[0]
        one_launch_no_sync(lambda: topk.select_k(c["d"], c["k"], c["valid"], True), "select_k")
    log("  select_k on CUDA tensors: one launch, no host sync (sync debug mode \"error\")")
    top = next(s for s in shapes if s["site"] == "_select_subsegments")
    return dict(ms=top["ms"], plain_ms=top["plain_ms"], bound_ms=top["bound_ms"],
                bound_by=top["bound_by"], library_ms=top["library_ms"], max_abs_err=0.0,
                shapes=shapes)


def select_k_splits_sweep(calls: dict) -> None:
    """The kernel's time (CUDA events, 10 launches) at each wide call's
    shape with 1 to 16 blocks a row, beside the wrapper's choice: the data
    for `_select_k_splits`."""
    from vss_tpu_torch.ops import topk

    for call in calls.values():
        d, k, valid, nan = call["d"], call["k"], call["valid"], call["nan_as_inf"]
        R, C = d.shape
        if C < 16 * topk._SK_TILE:
            continue
        times = {s: round(cuda_ms(lambda: topk._select_k_launch(d, k, valid, nan, s), 10), 5)
                 for s in (1, 2, 3, 4, 5, 6, 8, 12, 16)}
        log(f"  splits sweep {call['site']} {R} x {C}, k={k}: ms by blocks a row {times}; "
            f"the wrapper takes {topk._select_k_splits(R, C)}")


def synthetic_select_k_calls(dev) -> dict:
    """`SELECT_K_SHAPES` from random data, as `capture_select_k` records
    calls: normal values, the chunk's mask dropping a tenth of the
    columns."""
    gen = torch.Generator(device=dev).manual_seed(9)
    calls = {}
    for site, R, C, k, opts in SELECT_K_SHAPES:
        d = torch.randn((R, C), generator=gen, device=dev)
        valid = torch.rand((C,), generator=gen, device=dev) > 0.1 if opts else None
        calls[(site, (R, C), k, opts, opts)] = dict(site=site, d=d, k=k, valid=valid,
                                                     nan_as_inf=opts)
    return calls


@contextlib.contextmanager
def plain_selection():
    """Every row-wise selection by its plain version while in place:
    `select_k` as `_select_k_plain` (k argmin passes up to k = 32, a stable
    sort above; the chunked oracle's mask and NaN as two `torch.where`s of
    its whole block), as the port selected before the select_k kernel."""
    from vss_tpu_torch.ops import topk

    real = topk.select_k
    topk.select_k = topk._select_k_plain
    try:
        yield
    finally:
        topk.select_k = real


def before_after(label: str, fn, queries, out_dir: str, before_fn=None, before_ctx=None,
                 agree=None, truth=None) -> dict:
    """A serving path over the query batches "before" and "after", in turns
    (before, after, after, before): before is `fn` with the plain
    selections (`plain_selection`), or inside `before_ctx()` where given (a
    context that puts another plain version in place), or `before_fn`
    where given (the parent's route, composed in this script); after is
    `fn`. Its ms per batch (the mean of its two runs), its outputs checked
    (ids equal and distances bit for bit, or by `agree(label, before,
    after)` where given; with `truth`, recall of each within 0.0001), one
    batch of each under the profiler (kernels per batch, busy ms, idle
    share) and the peak memory of one batch of each."""
    ms = {"before": [], "after": []}
    outs = {}

    def ctx():
        if before_ctx is not None:
            return before_ctx()
        return contextlib.nullcontext() if before_fn else plain_selection()

    for which in ("before", "after", "after", "before"):
        with ctx() if which == "before" else contextlib.nullcontext():
            out, times = timed_batches(before_fn or fn if which == "before" else fn, queries)
        ms[which].append(sum(times) / len(times))
        outs.setdefault(which, out)
    (bd, bi), (ad, ai) = outs["before"], outs["after"]
    checked = {}
    if agree is not None:
        checked = agree(label, outs["before"], outs["after"])
    elif not np.array_equal(bi, ai) or not np.array_equal(bd.view(np.int32), ad.view(np.int32)):
        fail(f"{label}: ids or distances after differ from before "
             f"({int((bi != ai).any(1).sum())} rows of ids)")
    if truth is not None:
        checked["recall_before"], checked["recall_after"] = recall(bi, truth), recall(ai, truth)
        if abs(checked["recall_before"] - checked["recall_after"]) > 1e-4:
            fail(f"{label}: recall {checked['recall_before']} before, "
                 f"{checked['recall_after']} after")
    mean = {w: sum(v) / len(v) for w, v in ms.items()}
    qb = queries[:BATCH]
    with ctx():
        prof_b = profile_batch(f"{label}, before", before_fn or fn, qb, mean["before"], out_dir)
        peak_b = peak_mb(lambda: (before_fn or fn)(qb))
    prof_a = profile_batch(f"{label}, after", fn, qb, mean["after"], out_dir)
    peak_a = peak_mb(lambda: fn(qb))
    log(f"{label}: before {mean['before']:.3f} ms/batch {[round(t, 3) for t in ms['before']]}, "
        f"peak {peak_b:.1f} MB; after {mean['after']:.3f} {[round(t, 3) for t in ms['after']]}, "
        f"peak {peak_a:.1f} MB; "
        f"{json.dumps(checked) if checked or agree else 'ids and distances equal'}")
    return {"before_ms": mean["before"], "after_ms": mean["after"], "runs": ms,
            "before": prof_b, "after": prof_a, "before_peak_mb": peak_b,
            "after_peak_mb": peak_a, **checked}


# ----------------------------------------------------------------------
# the pivot seeding (pivot_seeds)

# a sharded shard's pivot sample at the flagship: about 250,000 rows a
# shard, level >= 1 nodes padded to a power of two
P_SHARD = 16_384


def seeds_route(g, cfg, q, slots, vecs, n_seeds, qn):
    """The graph search's seeding as the port ran it before the pivot_seeds
    kernel, on the tensors' device: `pivot_seeds` (the product, the
    epilogue, the mask, the selection by `select_k`, the slot map), then K1
    over the seeds."""
    from vss_tpu_torch.index import search as sr
    from vss_tpu_torch.ops.gather import gather_distances

    seeds, _ = sr.pivot_seeds(g, cfg, q, slots, vecs, n_seeds, qn)
    return seeds, gather_distances(g.vectors, seeds, q, cfg.metric, qn)


@contextlib.contextmanager
def parent_seeding():
    """While in place, `hnsw_search` seeds as the port did before the
    pivot_seeds kernel (`seeds_route`: the f32 GEMM, `pivot_seeds` with
    `select_k`, K1), from the pivots' rows in the tape's dtype, as the
    pivot caches hold them (their f32 copy and norms made again every
    batch)."""
    from vss_tpu_torch.index import search as sr

    real = sr.scored_pivot_seeds

    def route(graph, config, q, slots, vecs, n_seeds, q_norms=None, pivot_norms=None):
        return seeds_route(graph, config, q, slots, vecs.to(graph.vectors.dtype), n_seeds,
                           q_norms)

    sr.scored_pivot_seeds = route
    try:
        yield
    finally:
        sr.scored_pivot_seeds = real


@contextlib.contextmanager
def seeding_log(calls: list):
    """While in place, each `scored_pivot_seeds` call appends its
    arguments and its seeds to `calls`."""
    from vss_tpu_torch.index import search as sr

    real = sr.scored_pivot_seeds

    def spy(*args):
        out = real(*args)
        calls.append((args, out[0]))
        return out

    sr.scored_pivot_seeds = spy
    try:
        yield
    finally:
        sr.scored_pivot_seeds = real


def seeds_at_near_ties(label, fn, queries, after) -> np.ndarray:
    """`fn` (a graph search) once more over the query batches, its outputs
    bit for bit `after`'s, with each seeding call's seeds held against the
    f32 GEMM route's on the same arguments (`gemm_product`): equal but at
    near-ties (`seeds_near_ties`, which fails on any other). Returns the
    query rows, bool [n], whose seeds differ in some call (a sharded
    search seeds each shard)."""
    from vss_tpu_torch.index import search as sr

    excused = np.zeros(queries.shape[0], bool)
    outs = []
    for s in range(0, queries.shape[0], BATCH):
        calls = []
        with seeding_log(calls):
            outs.append(fn(queries[s:s + BATCH]))
        for args, got in calls:
            graph, config, q, slots, vecs, n_seeds, qn, pn = args
            with gemm_product():
                want = sr.scored_pivot_seeds(*args)[0]
            differ = (got != want).any(1)
            if bool(differ.any()):
                q = q.float()
                pv = vecs.float()
                qn = (q * q).sum(-1) if qn is None else qn
                pn = (pv * pv).sum(-1) if pn is None else pn
                seeds_near_ties(label, got, want, q @ pv.T, q, pivot_rows_of(vecs, slots), qn,
                                pn, slots, config.metric, got.shape[1])
                excused[s:s + q.shape[0]] |= differ.cpu().numpy()
    again = [torch.cat(parts).cpu().numpy() for parts in zip(*outs)]
    if not (np.array_equal(again[1], after[1])
            and np.array_equal(again[0].view(np.int32), after[0].view(np.int32))):
        fail(f"{label}: a second run of the search differs from the first")
    return excused


def graph_agree(fn, queries):
    """agree() for `before_after` over a graph search `fn` seeded before
    from the f32 GEMM's product (`parent_seeding`) and after from
    pivot_product's: ids equal in every row but those whose seeds differ
    at a near-tie (`seeds_at_near_ties`: the two products sum in another
    order; the beam and the rerank are the same, so equal seeds give equal
    results), and distances bit for bit in every row whose ids are
    equal."""
    def agree(label, before, after):
        (bd, bi), (ad, ai) = before, after
        excused = seeds_at_near_ties(label, fn, queries, after)
        same = (bi == ai).all(1)
        if not (same | excused).all():
            fail(f"{label}: ids differ from before in {int((~same & ~excused).sum())} rows "
                 f"whose seeds are the same")
        if not np.array_equal(bd[same].view(np.int32), ad[same].view(np.int32)):
            fail(f"{label}: distances differ from before in rows whose ids are equal")
        return {"rows_differ": int((~same).sum()), "seeds_at_near_ties": int(excused.sum())}
    return agree


@contextlib.contextmanager
def gemm_product():
    """While in place, `scored_pivot_seeds` takes the f32 GEMM for its
    product whatever the tape (`pivot_product_takes` false), so that the
    pivot_seeds kernel is held against its route on the same product."""
    from vss_tpu_torch.index import search as sr

    real = sr.pivot_product_takes
    sr.pivot_product_takes = lambda dtype: False
    try:
        yield
    finally:
        sr.pivot_product_takes = real


def pivot_seeds_variant(label, g, cfg, q, slots, vecs, n_seeds, norms=None, splits=None,
                        plain=True) -> float:
    """The pivot_seeds kernel (through `scored_pivot_seeds` with the f32 GEMM's
    product, `gemm_product`, or with `splits` blocks a row through
    `_pivot_seeds_launch`) against the route
    it replaces (`seeds_route`) on the same tensors: seeds equal, distances
    bit for bit. With `plain`, also against its plain version
    (`_scored_pivot_seeds_plain` with the plain selection): seeds equal,
    distances within REL_TOL of the magnitude of the terms. Returns that
    largest difference."""
    from vss_tpu_torch.index import search as sr

    qn = (q * q).sum(-1)
    k = min(n_seeds, slots.shape[0])
    if splits is None:
        with gemm_product():
            got = sr.scored_pivot_seeds(g, cfg, q, slots, vecs, n_seeds, qn, norms)
    else:
        pv = vecs.float()
        got = sr._pivot_seeds_launch(q @ pv.T, qn, (pv * pv).sum(-1), slots, g.vectors, q,
                                     cfg.metric, k, splits)
    want = seeds_route(g, cfg, q, slots, vecs, n_seeds, qn)
    torch.cuda.synchronize()
    if got[0].shape != (q.shape[0], k) or not torch.equal(got[0], want[0]):
        fail(f"pivot_seeds {label}: seeds differ from the route's in "
             f"{int((got[0] != want[0]).any(1).sum()) if got[0].shape == want[0].shape else '?'}"
             f" of {q.shape[0]} rows")
    if not same_bits(got[1], want[1]):
        fail(f"pivot_seeds {label}: distances differ from the route's")
    err = 0.0
    if plain:
        with plain_selection():
            ps, pd = sr._scored_pivot_seeds_plain(g, cfg, q, slots, vecs, n_seeds, qn)
        if not torch.equal(ps, got[0]):
            fail(f"pivot_seeds {label}: seeds differ from the plain version's")
        err = compare(f"pivot_seeds {label} against the plain version", got[1], pd,
                      dist_scale(q, g.vectors, cfg.metric))
    log(f"  {label}: {q.shape[0]} x {slots.shape[0]}, k={k}, {cfg.metric}, "
        f"{str(g.vectors.dtype)[6:]} d={g.vectors.shape[1]}, splits "
        f"{splits or sr._select_k_splits(q.shape[0], slots.shape[0])}: equal to the route "
        f"(seeds, distances bit for bit)")
    return err


def seeds_world(seed, B, P, d, dtype, dev, kind="normal", pad=0.25):
    """(graph, q [B, d], slots [P], pivot rows [P, d] f32) on `dev`, as
    tests/test_torch_seeds_emulated.py makes them: a tape of 2P rows (at
    least 16) of normal values (int8: integers to +-60), P slots of
    distinct rows, a share `pad` of them -1 (the tail and two inside),
    queries near the rows; kind "ties": small integers, each row three
    times in the tape."""
    rng = np.random.default_rng(seed)
    n = max(2 * P, 16)
    if kind == "ties":
        x = np.repeat(rng.integers(-3, 4, (n // 3 + 1, d)), 3, 0)[:n].astype(np.float32)
        qv = rng.integers(-3, 4, (B, d)).astype(np.float32)
    else:
        x = rng.normal(size=(n, d)).astype(np.float32)
        if dtype == torch.int8:
            x = np.round(x * 20)
        qv = (x[rng.integers(0, n, B)] + rng.normal(size=(B, d))).astype(np.float32)
    slots = rng.permutation(n)[:P].astype(np.int32)
    n_pad = int(P * pad)
    if n_pad:
        slots[P - n_pad:] = -1
        slots[rng.choice(P - n_pad, min(2, P - n_pad), replace=False)] = -1
    table = torch.from_numpy(x).to(dev, dtype)
    slots = torch.from_numpy(slots).to(dev)
    return (types.SimpleNamespace(vectors=table), torch.from_numpy(qv).to(dev), slots,
            table[slots.clamp(min=0).long()].float())


def pivot_seeds_edge_cases(dev) -> None:
    """`pivot_seeds_variant` at the emulated test's shapes and edge cases:
    every metric on int8, bf16 and f32 tapes at widths that take 16-byte
    loads and widths that rule them out; P = 4,096, 7 and 1 with -1
    padding; n_seeds 1, 4, 32 and 33; one block a row and rows split;
    ties between duplicate rows; a NaN query, zero vectors, a NaN row;
    every slot -1; B = 0; the 960-d cosine width (the gist arm)."""
    from vss_tpu_torch import HNSWConfig

    shapes = [(4096, 4, 3, None), (4096, 4, 1, 3), (4096, 1, 3, None), (4096, 32, 2, 2),
              (4096, 33, 2, None), (7, 4, 3, None), (7, 33, 2, 2), (1, 4, 2, None)]
    tapes = [(torch.int8, 32), (torch.int8, 20), (torch.bfloat16, 24), (torch.bfloat16, 9),
             (torch.float32, 12), (torch.float32, 7)]
    for dtype, d in tapes:
        for metric in ("l2sq", "cosine", "ip"):
            cfg = HNSWConfig(dims=d, metric=metric)
            for P, n_seeds, B, splits in shapes:
                g, q, slots, pv = seeds_world(P * 7 + n_seeds + B + d, B, P, d, dtype, dev)
                pivot_seeds_variant(f"edge {P}, {n_seeds}, {B}", g, cfg, q, slots, pv, n_seeds,
                                    splits=splits)
    for n_seeds, splits in ((4, 1), (4, 3), (32, 2), (33, 1), (33, 3)):
        g, q, slots, pv = seeds_world(n_seeds + splits, 3, 600, 16, torch.float32, dev,
                                      kind="ties", pad=0)
        for metric in ("l2sq", "cosine", "ip"):
            pivot_seeds_variant("ties", g, HNSWConfig(dims=16, metric=metric), q, slots, pv,
                                n_seeds, splits=splits)
    g, q, slots, pv = seeds_world(5, 4, 300, 12, torch.float32, dev)
    q[1, 3] = float("nan")
    q[2] = 0.0
    g.vectors[slots[:5].clamp(min=0).long()] = 0.0
    g.vectors[int(slots[7]), 2] = float("nan")
    pv = g.vectors[slots.clamp(min=0).long()].float()
    for metric in ("l2sq", "cosine", "ip"):
        for n_seeds, splits in ((4, 1), (4, 2), (33, 1), (33, 2)):
            # NaN values: the plain selection on the card orders a NaN with
            # its sign bit set otherwise (check_select_k); the route decides
            pivot_seeds_variant("a NaN query, zero vectors, a NaN row", g,
                                HNSWConfig(dims=12, metric=metric), q, slots, pv, n_seeds,
                                splits=splits, plain=False)
    g, q, slots, pv = seeds_world(6, 3, 64, 16, torch.int8, dev)
    for metric in ("l2sq", "cosine"):
        pivot_seeds_variant("every slot -1", g, HNSWConfig(dims=16, metric=metric), q,
                            torch.full_like(slots, -1), pv, 4)
    pivot_seeds_variant("an empty batch", g, HNSWConfig(dims=16), q[:0], slots, pv, 4,
                        plain=False)
    g, q, slots, pv = seeds_world(8, 64, 2048, 960, torch.int8, dev)
    pivot_seeds_variant("the gist width", g, HNSWConfig(dims=960, metric="cosine"), q, slots,
                        pv, 4)


def pivot_seeds_timing(label, g, cfg, q, slots, vecs, norms, n_seeds, out_dir) -> dict:
    """At one shape: the kernel's device time (the trace, 20 launches) over
    the product computed once; the whole seeding after (the product and
    the kernel) and the route before it (`seeds_route` from the pivots'
    rows in the tape's dtype), each by CUDA events and by one traced call
    (kernels, busy ms); the plain version (`_scored_pivot_seeds_plain` with
    the plain selection); the bound: the product read once, the norms and
    slots once, the query and seed rows once, the outputs written once,
    over 3.35 TB/s, against the epilogue's and the rescoring's f32
    operations over 67 TFLOP/s. No single PyTorch call computes this."""
    from vss_tpu_torch.index import search as sr

    B, P, d = q.shape[0], slots.shape[0], q.shape[1]
    k = min(n_seeds, P)
    qn = (q * q).sum(-1)
    dots = q @ vecs.T
    ms = device_ms(lambda: sr._pivot_seeds_launch(dots, qn, norms, slots, g.vectors, q,
                                                  cfg.metric, k), 20, "pivot_seeds_kernel",
                   out_dir)
    rows = vecs.to(g.vectors.dtype)

    def after():
        return sr.scored_pivot_seeds(g, cfg, q, slots, vecs, n_seeds, qn, norms)

    def before():
        return seeds_route(g, cfg, q, slots, rows, n_seeds, qn)

    after_ms, before_ms = cuda_ms(after, 20), cuda_ms(before, 20)
    kernels = {}
    for which, fn in (("before", before), ("after", after)):
        events, lost = traced(fn, out_dir, f"pivot seeding {label} {which}")
        kernels[which] = {"kernels": len(events), "lost": lost,
                          "busy_ms": sum(e["dur"] for e in events) / 1e3}
    with plain_selection():
        plain_ms = cuda_ms(lambda: sr._scored_pivot_seeds_plain(g, cfg, q, slots, vecs, n_seeds,
                                                                qn), 5)
    bytes_moved = B * P * 4 + P * 8 + B * 4 + B * d * 4 + B * k * d * g.vectors.element_size() \
        + B * k * 8
    b_ms, b_by = bound(bytes_moved, B * P * 3 + B * k * d * 4, "f32")
    log(f"  {label}: kernel {ms:.5f} ms device time, bound {b_ms:.5f} ms ({b_by}, "
        f"{bytes_moved} B); the seeding after {after_ms:.4f} ms ({kernels['after']}), the route "
        f"before {before_ms:.4f} ms ({kernels['before']}); plain {plain_ms:.4f} ms")
    return dict(shape=label, queries=B, pivots=P, k=k, ms=ms, bound_ms=b_ms, bound_by=b_by,
                plain_ms=plain_ms, library_ms=None, seeding_after_ms=after_ms,
                route_before_ms=before_ms, traced=kernels)


def synthetic_pivot_index(dev, vecs, queries, rng):
    """For `--pivot-seeds-only`: (an object with the `graph`, `config` and
    `pivots()` that `check_pivot_seeds` reads, the first batch of queries
    and the first insert wave's rows, both scaled). The corpus quantized to
    an int8 tape as the index quantizes it; its pivots a sample of rows
    drawn with the index's level odds (1/16 at M=16 reach level 1, about
    62,500 of 10^6), padded with -1 to a power of two, as
    `graph_pivots` pads them."""
    from vss_tpu_torch import HNSWConfig
    from vss_tpu_torch.index.dense import pivot_rows

    scale = float(np.abs(vecs).max()) / 127.0
    tape = torch.from_numpy(np.clip(np.round(vecs / scale), -127, 127).astype(np.int8)).to(dev)
    sample = np.nonzero(rng.random(vecs.shape[0]) < 1 / 16)[0]
    slots = np.full(1 << (sample.size - 1).bit_length(), -1, np.int32)
    slots[: sample.size] = sample
    slots = torch.from_numpy(slots).to(dev)
    p_slots, p_rows, p_norms = pivot_rows(slots, tape[slots.clamp(min=0).long()])
    pivots = (p_slots, p_rows.float(), p_norms)  # as `HNSWIndex.pivots` gives them
    index = types.SimpleNamespace(graph=types.SimpleNamespace(vectors=tape),
                                  config=HNSWConfig(dims=D, storage_dtype="int8"),
                                  pivots=lambda: pivots)
    wave = sift_like(rng, WAVE, 0, D, None)[0]
    q = torch.from_numpy(queries[:BATCH]).to(dev) / scale
    return index, q.contiguous(), (torch.from_numpy(wave).to(dev) / scale).contiguous()


# a graph search seeded from more pivots than select_k takes
EF_WIDE, N_SEEDS_WIDE = 320, 300


def wide_seed_search(idx, qb):
    """`search` at ef=EF_WIDE seeded from N_SEEDS_WIDE pivots
    (`hnsw_search`'s `n_seeds`, which `HNSWIndex.search` leaves at 4):
    above select_k's widest k, so the seeding is the route itself,
    `pivot_seeds` with the stable sort, then K1. Returns (distances,
    rowids) as `search` does."""
    from vss_tpu_torch.index.dense import rescale_distances
    from vss_tpu_torch.index.search import hnsw_search

    slots, vecs, norms = idx.pivots()
    g = idx.graph
    d, s = hnsw_search(g, idx.config, qb / idx.vector_scale, K, ef=EF_WIDE,
                       assume_all_valid=idx.deleted_count == 0, pivot_slots=slots,
                       pivot_vecs=vecs, pivot_norms=norms, n_seeds=N_SEEDS_WIDE,
                       rerank_tape=idx.rerank_tape)
    return rescale_distances(d, idx.vector_scale, idx.config.metric), idx._rowids(g, s)


def check_pivot_seeds(dev, idx, q_scaled, wave_scaled, out_dir) -> dict:
    """The pivot_seeds kernel against the route it replaces (`seeds_route`:
    `pivot_seeds` with `select_k`, then K1), seeds equal and distances bit
    for bit, and against its plain version within the tolerance: at the
    serving shape (512 queries over the 1M int8 index's pivots, k=4, with
    the cached norms and without, each metric, the other layout, k = 33 and
    256), at one query (rows split) and in one block, at a sharded shard's
    shape (512 x 16,384), at the sharded insert's (the first wave's 1,024
    rows, k=1), above 256 seeds (the route itself, K1 launched), and at the
    edge cases (`pivot_seeds_edge_cases`); one launch and no host sync
    under sync debug mode "error"; the times (`pivot_seeds_timing`) at
    the serving shape, the sharded shape and one query."""
    from vss_tpu_torch import HNSWConfig, csrc
    from vss_tpu_torch.index import search as sr

    log("pivot_seeds")
    g, cfg = idx.graph, idx.config
    slots, vecs, norms = idx.pivots()
    q = q_scaled
    err = pivot_seeds_variant("serving, the cached norms", g, cfg, q, slots, vecs, 4, norms)
    pivot_seeds_variant("serving, norms made in the wrapper", g, cfg, q, slots, vecs, 4)
    for metric in ("cosine", "ip"):
        pivot_seeds_variant("serving", g, HNSWConfig(dims=D, metric=metric,
                                                     storage_dtype="int8"), q, slots, vecs, 4)
    pivot_seeds_variant("serving, the other layout", g, cfg, q, slots, vecs, 4, splits=8)
    for n_seeds in (33, 256):
        pivot_seeds_variant("serving", g, cfg, q, slots, vecs, n_seeds, norms)
    pivot_seeds_variant("one query", g, cfg, q[:1], slots, vecs, 4, norms)
    pivot_seeds_variant("one query, one block", g, cfg, q[:1], slots, vecs, 4, splits=1)
    s_slots = slots[:P_SHARD].clone()
    s_slots[-P_SHARD // 10:] = -1
    s_vecs = vecs[:P_SHARD].contiguous()
    s_norms = (s_vecs * s_vecs).sum(-1)
    pivot_seeds_variant("a shard's pivots", g, cfg, q, s_slots, s_vecs, 4, s_norms)
    pivot_seeds_variant("the sharded insert's wave", g, cfg, wave_scaled, slots, vecs, 1, norms)
    k1, seeds = csrc.KERNELS["gather_distances"].launches, sr._SEEDS.launches
    pivot_seeds_variant("above 256 seeds (the route)", g, cfg, q[:64], slots, vecs, 300, norms,
                        plain=False)
    if csrc.KERNELS["gather_distances"].launches == k1 or sr._SEEDS.launches != seeds:
        fail("pivot_seeds above 256 seeds: the wrapper did not take the route (K1)")
    pivot_seeds_edge_cases(dev)
    qn = (q * q).sum(-1)
    with gemm_product():
        one_launch_no_sync(lambda: sr.scored_pivot_seeds(g, cfg, q, slots, vecs, 4, qn, norms),
                           "pivot_seeds")
        one_launch_no_sync(lambda: sr.scored_pivot_seeds(g, cfg, q[:1], slots, vecs, 4, qn[:1],
                                                         norms), "pivot_seeds")
    log("  pivot_seeds on CUDA tensors after the f32 GEMM: one launch, no host sync (sync "
        "debug mode \"error\")")
    shapes = [pivot_seeds_timing(f"serving {q.shape[0]} x {slots.shape[0]}, k=4", g, cfg, q,
                                 slots, vecs, norms, 4, out_dir),
              pivot_seeds_timing(f"a shard's {q.shape[0]} x {P_SHARD}, k=4", g, cfg, q, s_slots,
                                 s_vecs, s_norms, 4, out_dir),
              pivot_seeds_timing(f"one query x {slots.shape[0]}, k=4", g, cfg, q[:1], slots,
                                 vecs, norms, 4, out_dir)]
    top = shapes[0]
    return dict(ms=top["ms"], plain_ms=top["plain_ms"], bound_ms=top["bound_ms"],
                bound_by=top["bound_by"], library_ms=None, max_abs_err=err, shapes=shapes)


# ----------------------------------------------------------------------
# the pivot product (pivot_product)

# the product's shapes on the main paths (label, queries, pivots, width):
# the gist cell's batch over its 1M index's pivots, sift's, and the insert
# wave's 1,024 rows at the gist width (k = 1)
# (label, queries, pivots, width, seeds a query): the main paths' shapes
PIVOT_PRODUCT_SHAPES = [("gist serving", 512, 65_536, 960, 4),
                        ("sift serving", 512, 65_536, 128, 4),
                        ("insert wave", 1024, 65_536, 960, 1),
                        ("openai serving", 512, 65_536, 1536, 4),
                        ("sift one query", 1, 65_536, 128, 4)]
# rows of the synthetic tape the pivots are drawn from
PIVOT_TAPE_ROWS = 1_000_000


def pivot_world(seed, B, P, d, dtype, dev, n=None, pad=0.05):
    """(rows [P, d], slots [P] i32, queries [B, d] f32, tape [n, d]) on
    `dev`, made on the card: a tape of int8 values in [-127, 127] (bf16:
    normals x 40 rounded), P distinct slots, the last share `pad` of them
    -1, and their rows, as `graph_pivots` pads and gathers them; queries
    near the pivots' rows."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    n = n or max(2 * P, 16)
    if dtype == torch.int8:
        tape = torch.randint(-127, 128, (n, d), generator=gen, device=dev, dtype=torch.int8)
    else:
        tape = (torch.randn((n, d), generator=gen, device=dev) * 40).to(dtype)
    slots = torch.randperm(n, generator=gen, device=dev)[:P].to(torch.int32)
    n_pad = int(P * pad)
    if n_pad:
        slots[P - n_pad:] = -1
    pick = torch.randint(0, max(P - n_pad, 1), (B,), generator=gen, device=dev)
    rows = tape[slots.clamp(min=0).long()].contiguous()
    q = rows[pick].float() + torch.randn((B, d), generator=gen, device=dev) * 8
    return rows, slots, q.contiguous(), tape


def product_launches(d: int, dtype) -> int:
    """The launches of one `pivot_product` call over rows of d values of
    `dtype` on this card: one a column group of the kernel's plan."""
    from vss_tpu_torch.index import search as sr

    fn = sr._PIVOTS.function("vss_pivot_product_plan", ctypes.c_int,
                             [ctypes.c_int] * 5 + [ctypes.c_void_p] * 4)
    smem_max = getattr(torch.cuda.get_device_properties(0), "shared_memory_per_block_optin",
                       232_448)
    out = [ctypes.c_int() for _ in range(4)]
    if fn(512, 65_536, d, torch.empty((), dtype=dtype).element_size(), smem_max,
          *(ctypes.byref(v) for v in out)) <= 0:
        fail(f"pivot_product: the plan refuses rows of {d} {dtype} values")
    return -(-d // out[3].value)


def rows_listing_an_id_twice(ids: torch.Tensor) -> int:
    """Rows of `ids` (adjacency rows or answers) that hold an id >= 0 twice."""
    s = torch.sort(ids.to(torch.int64), 1).values
    return int(((s[:, 1:] == s[:, :-1]) & (s[:, 1:] >= 0)).any(1).sum())


# the benchmark's seeds at which the port answered a row twice while the
# connectivity repair wrote a bridge into a row that listed its other end
# already: `sift1m`, query 8,877 (row 155,022 at ranks 2 and 3), and the
# left-out cell `sift1m.churn` (two answers by recall step 192)
WITNESS_SEED = 2_147_483_653
WITNESS_QUERY = 8877
CHURN_WITNESS_SEED = 2_147_610_013


def check_witnesses(dev) -> dict:
    """The two witnesses through `vssbench/` on its own data: the `sift1m`
    index of WITNESS_SEED (no adjacency row lists an id twice; query
    WITNESS_QUERY alone, in its batch of 512, every batch of the pool and
    queries 8,800-8,899 alone answer no row twice), and 3 s of the
    `sift1m.churn` cell (from `vssbench/left_out.json`) at
    CHURN_WITNESS_SEED, which must read `correct` with `bad_answers` 0."""
    from vssbench import cell
    from vssbench.data import Corpus
    from vssbench.system import PortSystem

    root = os.path.dirname(os.path.abspath(__file__))
    cfg = cell.load_json(root, "vssbench/configs/sift1m.json")
    corpus = Corpus(cfg["corpus"], WITNESS_SEED, dev)
    base = corpus.base()
    pool = corpus.queries(int(cfg["queries"]["pool"])).cpu().numpy()
    system = PortSystem(cfg["index"], cfg["corpus"]["dims"], dev)
    system.prepare()
    system.build(base)
    del base
    g = system.index.graph
    graph_rows = rows_listing_an_id_twice(g.adj0) + rows_listing_an_id_twice(g.upper_adj)
    first = WITNESS_QUERY // 512 * 512
    batch = system.search(pool[first:first + 512], 10, 64)[1][WITNESS_QUERY - first]
    alone = system.search(pool[WITNESS_QUERY:WITNESS_QUERY + 1], 10, 64)[1][0]
    in_batches = sum(rows_listing_an_id_twice(torch.as_tensor(system.search(pool[s:s + 512], 10,
                                                                            64)[1]))
                     for s in range(0, pool.shape[0], 512))
    single = sum(rows_listing_an_id_twice(torch.as_tensor(system.search(pool[i:i + 1], 10,
                                                                        64)[1]))
                 for i in range(8800, 8900))
    out = dict(graph_rows=graph_rows, bridged=system.index.build_stats.get("bridged"),
               query=WITNESS_QUERY, in_batch=np.asarray(batch).tolist(),
               alone=np.asarray(alone).tolist(), pool_in_batches=in_batches,
               single_8800_8899=single)
    log(f"witness sift1m seed {WITNESS_SEED}: {json.dumps(out)}")
    if graph_rows or in_batches or single or len(set(out["alone"])) != len(out["alone"]) \
            or len(set(out["in_batch"])) != len(out["in_batch"]):
        fail(f"witness sift1m seed {WITNESS_SEED}: a row listed or answered twice")
    del system
    torch.cuda.empty_cache()

    real = cell.load_benchmark

    def with_left_out(root=root):
        bench = real(root)
        left = cell.load_json(root, "vssbench/left_out.json")
        for key in ("workloads", "end_to_end", "per_layer"):
            bench[key] += left[key]
        return bench

    cell.load_benchmark = with_left_out
    try:
        r = cell.run_cell("sift1m.churn", CHURN_WITNESS_SEED, 3.0, False, str(dev),
                          time.perf_counter(), root=root)
    finally:
        cell.load_benchmark = real
    churn = {k: v["value"] for k, v in r["check"].items()}
    log(f"witness sift1m.churn seed {CHURN_WITNESS_SEED}: correct {r['correct']}, {churn}")
    if not r["correct"] or churn.get("bad_answers"):
        fail(f"witness sift1m.churn seed {CHURN_WITNESS_SEED}: not correct ({churn})")
    out["churn"] = dict(correct=r["correct"], **churn)
    return out


def pivot_rows_of(rows, slots) -> torch.Tensor:
    """The pivots' rows in f64, zeros at slot -1."""
    return torch.where((slots >= 0)[:, None], rows.double(), 0.0)


def dot_bound(q, x64) -> torch.Tensor:
    """The f32 dot bound of each entry, 2 d 2^-24 sum |q||x|, in f64."""
    return 2.0 * q.shape[1] * 2.0 ** -24 * (q.double().abs() @ x64.abs().T)


def product_verdict(label, got, q, rows, slots) -> dict:
    """`got` (the kernel's product) against the float64 product on the card,
    every entry within its f32 dot bound (`dot_bound`), and so is the f32
    GEMM that the kernel replaced (`torch.matmul`); the two also within
    the bound of each other. Returns the largest error of each as a share
    of the bound."""
    x = pivot_rows_of(rows, slots)
    want = q.double() @ x.T
    bnd = dot_bound(q, x)
    lib = (q @ x.float().T).double()
    shares = {}
    for name, v in (("kernel", got.double()), ("library", lib)):
        err = (v - want).abs()
        if not bool((err <= bnd).all()):
            fail(f"pivot_product {label}: the {name}'s product is off the float64 one by more "
                 f"than the f32 dot bound in {int((err > bnd).sum())} entries")
        shares[name] = float((err / bnd.clamp(min=1e-300)).max())
    if not bool(((got.double() - lib).abs() <= bnd).all()):
        fail(f"pivot_product {label}: the kernel and the f32 GEMM differ by more than the bound")
    return shares


def pivot_product_special(dev) -> None:
    """A NaN and an inf in the queries: NaN and +-inf in the places the f32
    GEMM has them, the other queries within the bound. One-hot pivot rows:
    each product is the query's value, bit for bit (zeros equal), for
    normals, values near the f32 maximum, subnormals; a row of 1 and
    2^-140, which the split does not hold, off by no more than the bits
    it drops."""
    from vss_tpu_torch.index import search as sr

    for dtype, d in ((torch.int8, 960), (torch.bfloat16, 40), (torch.int8, 1536)):
        rows, slots, q, _ = pivot_world(11, 6, 300, d, dtype, dev)
        q[1, 3] = float("nan")
        q[2, 5] = float("inf")
        q[3, 7] = -float("inf")
        got = sr.pivot_product(q, rows, slots)
        lib = q @ pivot_rows_of(rows, slots).float().T
        if not (torch.equal(got.isnan(), lib.isnan()) and torch.equal(got.isposinf(),
                                                                      lib.isposinf())
                and torch.equal(got.isneginf(), lib.isneginf())):
            fail(f"pivot_product {dtype} d={d}: NaN or inf in other places than the GEMM's")
        fine = torch.tensor([0, 4, 5], device=dev)
        product_verdict(f"{dtype} d={d} beside NaN and inf queries", got[fine], q[fine], rows,
                        slots)
    # one-hot rows in one column group (200) and across two (1,536) and
    # five (4,400)
    for d in (1536, 4400, 200):
        eye = torch.zeros((d + 3, d), dtype=torch.int8, device=dev)
        eye[torch.arange(d), torch.arange(d)] = 1
        slots = torch.cat([torch.randperm(d, device=dev), torch.full((56,), -1, device=dev)]).to(
            torch.int32)
        eye = eye[slots.clamp(min=0).long()].contiguous()
        gen = torch.Generator(device=dev).manual_seed(12)
        normal = torch.randn((4, d), generator=gen, device=dev)
        bits = torch.randint(1, 1 << 23, (4, d), generator=gen, device=dev, dtype=torch.int32)
        subnormal = (bits | (torch.randint(0, 2, (4, d), generator=gen, device=dev,
                                           dtype=torch.int32) << 31)).view(torch.float32)
        q = torch.cat([normal, normal * 3e37, subnormal]).contiguous()
        q[0, :9] = 0.0
        q[1, :9] = -0.0
        got = sr.pivot_product(q, eye, slots)
        want = torch.where((slots >= 0)[None, :], q[:, slots.clamp(min=0).long()], 0.0)
        nz = want != 0
        if not (torch.equal(got[nz].view(torch.int32), want[nz].view(torch.int32))
                and bool((got[~nz] == 0).all())):
            fail(f"pivot_product: one-hot pivots of {d} values do not give back the queries bit "
                 f"for bit")
    # a row of 1 and 2^-140: its 2^-140 lie 140 binades below its 1, past
    # what the split holds (s = 0), so each is lost; the product is off by
    # at most the bits below 2^-133 of its values
    mixed = torch.ones((1, d), device=dev)
    mixed[0, 1::2] = 2.0 ** -140
    got = sr.pivot_product(mixed, eye, slots)
    x = pivot_rows_of(eye, slots)
    lost = (mixed.double() @ x.T - got.double()).abs()
    if not bool((lost <= dot_bound(mixed, x) + 2.0 ** -133 * x.abs().sum(1)[None, :]).all()):
        fail("pivot_product: a row of 1 and 2^-140 off by more than its lost bits")
    log("  NaN and inf queries as the GEMM (960, 40, 1,536); one-hot pivots give back normals, "
        "values near the f32 maximum, subnormals and zeros bit for bit (200, 1,536, 4,400)")


def pivot_product_edge_cases(dev) -> None:
    """The kernel against the float64 product at the emulated tests' edge
    shapes: int8 and bf16 tapes at widths that take 16-byte loads (128,
    960, 1,088, 1,536 and 4,400 int8; 128, 960, 1,024 and 1,536 bf16) and
    widths that rule them out (40, 100 and 1,100 int8, 9, 36 and 4,100
    bf16), so one column group and several, 1, 33 and 70 queries (not a
    multiple of the query tile), 300 pivots (not a multiple of 128) with
    -1 padding, so each slab width the plan picks (128 columns at int8
    960, 64 at int8 1,088 and bf16 960 and 1,024), and B = 0. Each call
    counts one launch a column group."""
    from vss_tpu_torch.index import search as sr

    for dtype, d in ((torch.int8, 128), (torch.int8, 960), (torch.int8, 1088), (torch.int8, 40),
                     (torch.int8, 100), (torch.int8, 200), (torch.int8, 1100), (torch.int8, 1536),
                     (torch.int8, 4400), (torch.bfloat16, 128), (torch.bfloat16, 960),
                     (torch.bfloat16, 1024), (torch.bfloat16, 1536), (torch.bfloat16, 4100),
                     (torch.bfloat16, 9), (torch.bfloat16, 36)):
        for B in (1, 33, 70):
            rows, slots, q, _ = pivot_world(B + d, B, 300, d, dtype, dev)
            before = sr._PIVOTS.launches
            got = sr.pivot_product(q, rows, slots)
            if sr._PIVOTS.launches - before != product_launches(d, dtype):
                fail(f"pivot_product {dtype} d={d}: counted {sr._PIVOTS.launches - before} "
                     f"launches, not one a column group ({product_launches(d, dtype)})")
            product_verdict(f"{str(dtype)[6:]} d={d} B={B}", got, q, rows, slots)
    rows, slots, q, _ = pivot_world(3, 4, 300, 128, torch.int8, dev)
    before = sr._PIVOTS.launches
    if sr.pivot_product(q[:0], rows, slots).shape != (0, 300) or sr._PIVOTS.launches != before:
        fail("pivot_product with no queries launched or gave another shape")
    log("  edge shapes: every width, dtype and batch within the f32 dot bound, one launch "
        "counted a column group")


def seeds_near_ties(label, got, want, dots, q, x64, qn, pn, slots, metric: str, k: int) -> int:
    """Seeds of the new product (`got`) against the f32 GEMM's (`want`):
    equal in every row but those where two of the GEMM route's k + 1
    nearest pivots lie within the two products' error of each other (each
    dot within its f32 bound, `dot_bound`, so the two differ by at most
    twice it, which the metric's epilogue scales). Returns the rows that
    differ."""
    from vss_tpu_torch.ops.distance import Metric, _epilogue

    differ = (got != want).any(1).nonzero()[:, 0]
    if differ.numel() == 0:
        return 0
    m = Metric.parse(metric)
    dq = torch.where((slots >= 0)[None, :], _epilogue(dots[differ], qn[differ, None], pn[None, :],
                                                      m), float("inf"))
    err = 2.0 * dot_bound(q[differ], x64)
    if m == Metric.L2SQ:
        err = 2.0 * err
    elif m == Metric.COSINE:
        err = err / (qn[differ, None].double() * pn[None, :].double()).sqrt().clamp(min=1e-300)
    near, order = torch.topk(dq, k + 1, largest=False)
    tol = torch.gather(err, 1, order).amax(1)
    gaps = (near[:, 1:] - near[:, :-1]).double().amin(1)
    bad = int((gaps > 2.0 * tol).sum())
    if bad:
        fail(f"pivot_product seeding {label}: seeds differ from the f32 GEMM route's in {bad} "
             f"rows with no near-tie among its {k + 1} nearest pivots")
    return int(differ.numel())


def pivot_product_seeding(label, B, P, d, dev, metric="l2sq", n_seeds=4) -> dict:
    """`scored_pivot_seeds` over an int8 tape (the pivot_product kernel, then
    pivot_seeds) against the route it replaced (the f32 GEMM, then
    pivot_seeds): seeds equal but at near-ties (`seeds_near_ties`), each
    seed's distance K1's (`gather_distances`) bit for bit; one launch of
    each kernel (of the product, one a column group), no host sync."""
    from vss_tpu_torch import HNSWConfig, csrc
    from vss_tpu_torch.index import search as sr
    from vss_tpu_torch.ops.gather import gather_distances

    rows, slots, q, tape = pivot_world(B + P + d, B, P, d, torch.int8, dev, n=PIVOT_TAPE_ROWS)
    g, cfg = types.SimpleNamespace(vectors=tape), HNSWConfig(dims=d, metric=metric,
                                                             storage_dtype="int8")
    pv = rows.float()
    qn, pn = (q * q).sum(-1), (pv * pv).sum(-1)
    k = min(n_seeds, P)
    before = {name: csrc.KERNELS[name].launches for name in ("pivot_product", "pivot_seeds")}
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = sr.scored_pivot_seeds(g, cfg, q, slots, rows, n_seeds, qn, pn)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    ran = {name: csrc.KERNELS[name].launches - n for name, n in before.items()}
    want_ran = {"pivot_product": product_launches(d, torch.int8), "pivot_seeds": 1}
    if ran != want_ran:
        fail(f"pivot_product seeding {label}: launched {ran}, not {want_ran}")
    dots = q @ pv.T
    want = sr._pivot_seeds_launch(dots, qn, pn, slots, tape, q, metric, k)
    if not same_bits(got[1], gather_distances(tape, got[0], q, metric, qn)):
        fail(f"pivot_product seeding {label}: seed distances are not K1's bit for bit")
    differ = seeds_near_ties(label, got[0], want[0], dots, q, pivot_rows_of(rows, slots), qn, pn,
                             slots, metric, k)
    log(f"  seeding {label}: {B} x {P} x {d} int8 {metric}, k={k}: launches {ran}, no host "
        f"sync; seeds equal the f32 GEMM route's but in {differ} rows, each at a near-tie; "
        f"seed distances K1's bit for bit")
    return {"rows_differ": differ}


def pivot_product_timing(label, B, P, d, dev, out_dir) -> dict:
    """At one shape of the main paths, pivots from a PIVOT_TAPE_ROWS-row int8
    tape:
    the kernel's product against the float64 one (`product_verdict`); its
    device time a call (the trace, 20 calls, every column group's launch);
    the f32 GEMM it replaced (`torch.matmul` over the
    pivots' f32 rows, the route before, CUDA events); the plain version
    (`_pivot_product_plain`, three f32 GEMMs); the bound: 6 B P d bf16
    operations (three planes) at 989 TFLOP/s against the pivot rows, the
    queries, the slots and the output once at 3.35 TB/s."""
    from vss_tpu_torch.index import search as sr

    rows, slots, q, _ = pivot_world(B + P + d, B, P, d, torch.int8, dev, n=PIVOT_TAPE_ROWS)
    shares = product_verdict(label, sr.pivot_product(q, rows, slots), q, rows, slots)
    ms = device_ms_of(lambda: sr.pivot_product(q, rows, slots), 20, ["pivot_product_kernel"],
                      product_launches(d, torch.int8), out_dir)
    pv = rows.float()
    library_ms = cuda_ms(lambda: q @ pv.T, 20)
    plain_ms = cuda_ms(lambda: sr._pivot_product_plain(q, rows, slots), 5)
    ops = 6.0 * B * P * d
    bytes_moved = P * d + B * d * 4 + B * P * 4 + P * 4
    b_ms, b_by = bound(bytes_moved, ops, "bf16")
    log(f"  {label} {B} x {P} x {d} int8: kernel {ms:.4f} ms device time "
        f"({ops / ms / 1e9:.1f} TFLOP/s on three planes); bound {b_ms:.4f} "
        f"ms ({b_by}); the f32 GEMM it replaced {library_ms:.4f} ms; plain {plain_ms:.4f} ms; "
        f"largest error / bound: {shares}")
    return dict(shape=label, queries=B, pivots=P, d=d, ms=ms, bound_ms=b_ms,
                bound_by=b_by, tflops=ops / ms / 1e9, library_ms=library_ms, plain_ms=plain_ms,
                error_share_of_bound=shares)


def check_pivot_product(dev, out_dir) -> dict:
    """The pivot_product kernel: against the float64 product within the f32
    dot bound at the main paths' shapes (`PIVOT_PRODUCT_SHAPES`) and the
    edge shapes, NaN / inf queries and one-hot pivots
    (`pivot_product_special`), one launch and no host sync (two at the
    text-embedding width 1,536: one a column group); the seeding through
    it against the f32 GEMM's at every shape of `PIVOT_PRODUCT_SHAPES`
    (the wave's at k = 1), and under cosine at the gist and text-embedding
    widths; the times (`pivot_product_timing`)."""
    from vss_tpu_torch.index import search as sr

    log("pivot_product")
    pivot_product_edge_cases(dev)
    pivot_product_special(dev)
    rows, slots, q, _ = pivot_world(5, 512, 4096, 960, torch.int8, dev)
    one_launch_no_sync(lambda: sr.pivot_product(q, rows, slots), "pivot_product")
    rows, slots, q, _ = pivot_world(5, 512, 4096, 1536, torch.int8, dev)
    one_launch_no_sync(lambda: sr.pivot_product(q, rows, slots), "pivot_product", n=2)
    log("  pivot_product on CUDA tensors: one launch a column group (960: one; 1,536: two), no "
        "host sync")
    del rows, slots, q
    seeding = {}
    for label, B, P, d, n_seeds in PIVOT_PRODUCT_SHAPES:
        seeding[label] = pivot_product_seeding(label, B, P, d, dev, n_seeds=n_seeds)
    for label, d in (("gist serving, cosine", 960), ("openai serving, cosine", 1536)):
        seeding[label] = pivot_product_seeding(label, 512, 65_536, d, dev, metric="cosine")
    shapes = [pivot_product_timing(label, B, P, d, dev, out_dir)
              for label, B, P, d, _ in PIVOT_PRODUCT_SHAPES]
    top = shapes[0]
    return dict(ms=top["ms"], plain_ms=top["plain_ms"], bound_ms=top["bound_ms"],
                bound_by=top["bound_by"], library_ms=top["library_ms"], shapes=shapes,
                seeding=seeding, ptxas=ptxas_entries("pivots", "pivot_product_kernel"))


# ----------------------------------------------------------------------
# phases B and C of the exact scan (rescore_topk)


def scan_segs(q, tape, xn, valid, k: int, keep=None, metric="l2sq"):
    """The sub-segments `scan_topk` keeps for queries `q` (scaled units):
    K2, then `_select_subsegments`, at keep = 2k (`scan_search`'s) unless
    given, capped as `scan_topk` caps it."""
    from vss_tpu_torch.ops import scan as s

    keep = min(2 * k if keep is None else keep, s._GROUP * -(-tape.shape[0] // s._SEG))
    subs = s.native_segmin(q.to(torch.bfloat16), tape, xn, valid, metric)
    return s._select_subsegments(subs, keep)


def rescore_m(k: int, segs, rr) -> int:
    """`scan_topk`'s phase-B pool."""
    return min(max(2 * k, k + 6), segs.shape[1] * 32) if rr is not None else k


def true_dists(q, rows, metric: str) -> np.ndarray:
    """float64 distances of each query to its rows, on the host: q [B, d],
    rows [B, C, d] (numpy)."""
    q = q.astype(np.float64)[:, None, :]
    rows = rows.astype(np.float64)
    if metric == "l2sq":
        return ((q - rows) ** 2).sum(-1)
    dots = (q * rows).sum(-1)
    if metric == "ip":
        return 1.0 - dots
    den = np.sqrt((q * q).sum(-1) * (rows * rows).sum(-1))
    return 1.0 - np.where(den > 0, dots / np.where(den > 0, den, 1.0), 0.0)


def rescore_verdict(got, want, q, segs, tape, xn, valid, rr, m: int, metric: str) -> dict:
    """Kernel (`got`) against plain version (`want`) of rescore_topk on the
    same inputs, within the tolerance of `check_rescore`: +inf in the same
    places, distances within REL_TOL of the magnitude of their terms
    (`dist_scale` of the queries and the rows scored last: the rerank
    tape, else the tape), and ids equal except at a near-tie: both ids'
    float64 distances within that tolerance, or one of them at phase B's
    m-th place, its phase-B value and the next one's within REL_TOL of
    the tape's `dist_scale`. Returns the counts and `ok`."""
    from vss_tpu_torch.ops import scan as s

    gd, gi = got
    wd, wi = want
    out = {"rows": int(gd.shape[0]), "bit_equal": bool(bit_equal(gd, wd) and torch.equal(gi, wi))}
    if gd.shape != wd.shape or gi.shape != wi.shape:
        return dict(out, ok=False, why=f"shapes {tuple(gd.shape)} != {tuple(wd.shape)}")
    fin = torch.isfinite(wd)
    if not torch.equal(torch.isfinite(gd), fin):
        return dict(out, ok=False, why="finite in one version only")
    src = rr if rr is not None else tape
    tol = REL_TOL * dist_scale(q, src, metric)
    btol = REL_TOL * dist_scale(q, tape, metric)
    err = float((gd[fin] - wd[fin]).abs().max()) if bool(fin.any()) else 0.0
    out.update(max_abs_err=err, tol=tol)
    if not err <= tol:
        return dict(out, ok=False, why=f"max_abs_err {err:.6g} over tol {tol:.6g}")
    differ = (gi != wi).any(1).nonzero()[:, 0].tolist()
    near_final = near_b = bad = 0
    for b in differ:
        ids = sorted({int(i) for i in torch.cat([gi[b], wi[b]]).tolist() if i >= 0})
        td = true_dists(q[b:b + 1].cpu().numpy(), src[torch.tensor(ids, device=src.device)]
                        .float().cpu().numpy()[None], metric)[0]
        t = dict(zip(ids, td))
        brows, bvals = s._phase_b_plain(q[b:b + 1], segs[b:b + 1], tape, xn, valid,
                                        rr is not None, s.Metric.parse(metric))
        bv = bvals[0].cpu().numpy()
        pv = {}
        for r, v in zip(brows[0].tolist(), bv.tolist()):
            pv[r] = min(v, pv.get(r, v))
        srt = np.sort(bv)
        vm = srt[m - 1] if m - 1 < srt.size else np.inf
        vn = srt[m] if m < srt.size else np.inf
        for j in (gi[b] != wi[b]).nonzero()[:, 0].tolist():
            a, w = int(gi[b, j]), int(wi[b, j])
            if a >= 0 and w >= 0 and abs(t[a] - t[w]) <= tol:
                near_final += 1
            elif abs(vm - vn) <= btol and any(x >= 0 and x in pv and min(
                    abs(pv[x] - vm), abs(pv[x] - vn)) <= btol for x in (a, w)):
                near_b += 1
            else:
                bad += 1
    out.update(rows_differ=len(differ), near_ties_final=near_final, near_ties_phase_b=near_b,
               not_near=bad)
    return dict(out, ok=bad == 0, why=f"{bad} ids differ at no near-tie" if bad else "")


def rescore_variant(label, q, segs, tape, xn, valid, rr, k: int, metric="l2sq", splits=None,
                    exact=False) -> dict:
    """The rescore_topk kernel against its plain version (`_rescore_chunks`,
    the parent's phases B and C) on the card: `rescore_verdict`'s tolerance,
    or with `exact` (integer-valued inputs: every sum exact) ids equal and
    distances bit for bit (cosine: within the tolerance where PyTorch's
    sqrt or division rounds otherwise)."""
    from vss_tpu_torch.ops import scan as s
    from vss_tpu_torch.ops.distance import Metric

    m = rescore_m(k, segs, rr)
    got = s._rescore_launch(q, segs, tape, xn, valid, rr, m, k, Metric.parse(metric), splits)
    want = s._rescore_chunks(q, segs, tape, xn, valid, rr, m, k, Metric.parse(metric))
    v = rescore_verdict(got, want, q, segs, tape, xn, valid, rr, m, metric)
    if exact and not v["bit_equal"] and (metric != "cosine" or not v["ok"]):
        fail(f"rescore_topk {label}: not bit for bit on exact sums ({v})")
    if not v["ok"]:
        fail(f"rescore_topk {label}: {v['why']} ({v})")
    layout = splits or s._rescore_splits(q.shape[0], segs.shape[1])
    log(f"  {label}: {q.shape[0]} queries, keep {segs.shape[1]}, m={m}, k={k}, {metric}, "
        f"{str(tape.dtype)[6:]} tape, rerank "
        f"{None if rr is None else str(rr.dtype)[6:]}, {layout} block(s) a query: "
        f"{'bit for bit' if v['bit_equal'] else 'within tolerance'} (max_abs_err "
        f"{v.get('max_abs_err', 0):.6g}, tol {v.get('tol', 0):.6g}, rows with other ids "
        f"{v.get('rows_differ', 0)}: near-ties final {v.get('near_ties_final', 0)}, phase B "
        f"{v.get('near_ties_phase_b', 0)})")
    return v


def rescore_timing(label, q, segs, tape, xn, valid, rr, k: int, out_dir: str) -> dict:
    """Device time of the kernel (from the trace), the plain version's time
    (CUDA events), and the bound: the bytes the call must move, each input
    read once (the distinct kept sub-segments' rows, norms and flags; the
    distinct rows of the phase-B pools, from the plain version's phase B;
    the queries and segment ids; the outputs),
    over the memory rate, against its f32 operations over the f32 rate."""
    from vss_tpu_torch.ops import scan as s

    m = rescore_m(k, segs, rr)
    nq, keep = segs.shape
    nx, d = tape.shape
    ms = device_ms(lambda: s.rescore_topk(q, segs, tape, xn, valid, rr, m, k, "l2sq"), 20,
                   "rescore_topk", out_dir)
    plain_ms = cuda_ms(lambda: s._rescore_chunks(q, segs, tape, xn, valid, rr, m, k,
                                                 s.Metric.L2SQ), 3)
    useg = torch.unique(segs[segs >= 0])
    rows = int(torch.clamp(nx - useg.long() * 32, 0, 32).sum())
    bytes_moved = (nq * d * 4 + nq * 4 + nq * keep * 4 + rows * (d * tape.element_size() + 5)
                   + nq * k * 8)
    pool_rows = 0
    if rr is not None:
        brows, bvals = s._phase_b_plain(q, segs, tape, xn, valid, True, s.Metric.L2SQ)
        bv, bp = s._select_min_k(bvals, m)
        pool = torch.where(torch.isfinite(bv), brows.gather(1, bp.long()), -1)
        pool_rows = int(torch.unique(pool[pool >= 0]).numel())
        bytes_moved += pool_rows * d * rr.element_size()
        del brows, bvals
    per_query = nq * keep * 32 * (d * tape.element_size() + 5) + (nq * m * d * 4 if rr is not None
                                                                  else 0)
    cand = int((segs >= 0).sum()) * 32
    ops = 2.0 * cand * d + 3.0 * nq * m * d
    b_ms, b_by = bound(bytes_moved, ops, "f32")
    log(f"  {label}: kernel {ms:.4f} ms device, plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms "
        f"({b_by}: {bytes_moved / 1e6:.1f} MB, {useg.numel()} distinct sub-segments, "
        f"{pool_rows} distinct pool rows; counted per query {per_query / 1e6:.1f} MB, "
        f"{per_query / HBM_BYTES_PER_S * 1e3:.4f} ms)")
    return dict(label=label, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                mb=bytes_moved / 1e6, per_query_mb=per_query / 1e6)


# check_rescore's ragged tape: rows (not a multiple of 32), queries
RESCORE_RAGGED = (70_037, 200)


def check_rescore(dev, tape, xn, valid, rr, q, rng, out_dir) -> dict:
    """The rescore_topk kernel against its plain version (`_rescore_chunks`)
    on the flagship's tapes (int8 `tape` with norms `xn`, flags `valid`,
    the f32 rerank tape `rr`) and queries `q` (scaled units), at the real
    segments that K2 and `_select_subsegments` keep (`scan_segs`): k = 10
    and 100 (`scan_search`'s), 1, 32 and 128 (keep 256), one query (its
    segments split), the other layout, every metric, an f32 tape without
    a rerank tape, a bf16 tape, a ragged 70,037-row tape; exact on
    integer-valued queries and rerank rows; a control (phase C on
    bf16-rounded rerank rows) that must break the tolerance; one launch
    and no host sync; the times at k = 10 and 100."""
    from vss_tpu_torch.ops import scan as s

    log("rescore_topk")
    segs = {k: scan_segs(q, tape, xn, valid, k) for k in (1, 10, 32, 100, 128)}
    verdicts = {}
    for k in (10, 100, 1, 32, 128):
        verdicts[k] = rescore_variant(f"flagship k={k}", q, segs[k], tape, xn, valid, rr, k)
    rescore_variant("flagship k=100, 2 blocks a query", q, segs[100], tape, xn, valid, rr, 100,
                    splits=2)
    for k in (10, 100):
        rescore_variant(f"one query, k={k}", q[:1], segs[k][:1], tape, xn, valid, rr, k)
        rescore_variant(f"one query, k={k}, one block", q[:1], segs[k][:1], tape, xn, valid, rr,
                        k, splits=1)
    for metric in ("cosine", "ip"):
        rescore_variant("flagship k=10", q, scan_segs(q, tape, xn, valid, 10, metric=metric),
                        tape, xn, valid, rr, 10, metric)
    # the stored tape in f32 (no rerank tape) and in bf16 (with one)
    rr_n = (rr.float() ** 2).sum(-1)
    rescore_variant("f32 tape, no rerank tape, k=10", q, scan_segs(q, rr, rr_n, valid, 10), rr,
                    rr_n, valid, None, 10)
    bt = rr.to(torch.bfloat16)
    bt_n = (bt.float() ** 2).sum(-1)
    rescore_variant("bf16 tape, k=10", q, scan_segs(q, bt, bt_n, valid, 10), bt, bt_n, valid, rr,
                    10)
    # ragged: 70,037 rows, a tenth invalid, a zero row
    n, nq_r = RESCORE_RAGGED
    t = torch.from_numpy(rng.integers(-127, 128, (n, D)).astype(np.int8)).to(dev)
    t[11] = 0
    tn = (t.float() ** 2).sum(-1)
    v = torch.from_numpy(rng.random(n) > 0.1).to(dev)
    tr = t.float() + torch.from_numpy(rng.normal(size=(n, D)).astype(np.float32)).to(dev)
    qq = (t[torch.from_numpy(rng.integers(0, n, nq_r)).to(dev)].float()
          + torch.from_numpy(rng.normal(size=(nq_r, D)).astype(np.float32) * 8).to(dev))
    for k in (10, 100):
        for metric in ("l2sq", "cosine", "ip"):
            rescore_variant(f"ragged {n} rows, k={k}", qq,
                            scan_segs(qq, t, tn, v, k, metric=metric), t, tn, v, tr, k, metric)
    # exact: integer-valued queries and rerank rows, every sum exact
    qi = q.round()
    ti = tape.float()
    for k in (10, 100):
        for metric in ("l2sq", "ip", "cosine"):
            rescore_variant(f"integer-valued, k={k}", qi, scan_segs(qi, tape, xn, valid, k,
                                                                     metric=metric),
                            tape, xn, valid, ti, k, metric, exact=True)
    # the control: phase C on bf16-rounded rerank rows must break the tolerance
    m = rescore_m(100, segs[100], rr)
    got = s._rescore_launch(q, segs[100], tape, xn, valid, rr, m, 100, s.Metric.L2SQ)
    ctrl = s._rescore_chunks(q, segs[100], tape, xn, valid, rr.to(torch.bfloat16), m, 100,
                             s.Metric.L2SQ)
    cv = rescore_verdict(got, ctrl, q, segs[100], tape, xn, valid, rr, m, "l2sq")
    if cv["ok"]:
        fail(f"rescore_topk: the control (phase C on bf16 rerank rows) stays within the "
             f"tolerance ({cv})")
    log(f"  control, phase C on bf16-rounded rerank rows, k=100: breaks the tolerance "
        f"({cv['why']})")
    one_launch_no_sync(lambda: s.rescore_topk(q, segs[100], tape, xn, valid, rr, m, 100, "l2sq"),
                       "rescore_topk")
    one_launch_no_sync(lambda: s.rescore_topk(q[:1], segs[10][:1], tape, xn, valid, rr, 20, 10,
                                              "l2sq"), "rescore_topk")
    log("  rescore_topk on CUDA tensors: one launch, no host sync (sync debug mode \"error\")")
    shapes = [rescore_timing(f"scan_search k={k}: {q.shape[0]} queries, keep {2 * k}", q,
                             segs[k], tape, xn, valid, rr, k, out_dir) for k in (10, 100)]
    shapes.append(rescore_timing("one query, k=100", q[:1], segs[100][:1], tape, xn, valid, rr,
                                 100, out_dir))
    top = shapes[1]
    return dict(ms=top["ms"], plain_ms=top["plain_ms"], bound_ms=top["bound_ms"],
                bound_by=top["bound_by"], library_ms=None,
                max_abs_err=verdicts[100]["max_abs_err"], shapes=shapes)


@contextlib.contextmanager
def plain_rescore():
    """Phases B and C by their plain version while in place: `rescore_topk`
    as `_rescore_chunks` (the gathered block in query chunks, the batched
    product, `select_k`, the rerank and a stable sort), as the port scanned
    before the rescore_topk kernel."""
    from vss_tpu_torch.ops import scan as s

    real = s.rescore_topk

    def plain(q, segs, tape, x_norms, valid, rerank_tape, m, k, metric):
        return s._rescore_chunks(q, segs, tape, x_norms, valid, rerank_tape, m, k,
                                 s.Metric.parse(metric))

    s.rescore_topk = plain
    try:
        yield
    finally:
        s.rescore_topk = real


def scan_agree(vecs: np.ndarray, queries: np.ndarray):
    """A check of `before_after` for a scan path with the plain phases B and
    C before and the kernel after: +inf in the same places, distances
    within REL_TOL of their magnitude, ids equal except at a near-tie
    (both ids' float64 distances to the query, from the f32 corpus, within
    that tolerance). Returns the counts; fails otherwise."""
    def agree(label, before, after) -> dict:
        (bd, bi), (ad, ai) = before, after
        fin = np.isfinite(bd)
        if not np.array_equal(np.isfinite(ad), fin):
            fail(f"{label}: finite distances in other places before and after")
        scale = float(np.abs(bd[fin]).max())
        err = float(np.abs(ad[fin] - bd[fin]).max())
        if not err <= REL_TOL * scale:
            fail(f"{label}: distances after differ from before by {err} (tol "
                 f"{REL_TOL * scale})")
        rows = np.nonzero((ai != bi).any(1))[0]
        bad = near = 0
        for b in rows:
            for j in np.nonzero(ai[b] != bi[b])[0]:
                a, w = int(ai[b, j]), int(bi[b, j])
                t = true_dists(queries[b:b + 1], vecs[[a, w]][None], "l2sq")[0]
                if abs(t[0] - t[1]) <= REL_TOL * scale:
                    near += 1
                else:
                    bad += 1
        log(f"{label}: distances within {err:.6g} (tol {REL_TOL * scale:.6g}); {rows.size} rows "
            f"with other ids, {near} near-ties, {bad} not")
        if bad:
            fail(f"{label}: {bad} ids differ before and after at no near-tie")
        return {"max_abs_err": err, "rows_differ": int(rows.size), "near_ties": near}
    return agree


# ----------------------------------------------------------------------
# the graph search's rerank (rerank_pool)

# check_rerank_pool's shapes: name, queries, pool (ef), k, d, metric and
# the tape's rows: the gist and openai cells' calls, one query of sift's
# width (the held-back q1 cell's), and phase 4's two graph paths over the
# sift-like index (`graph_path` at ef=EF, `wide_path` at ef=EF_WIDE)
RERANK_SHAPES = (("gist", 512, 64, 10, 960, "l2sq", 1_000_000),
                 ("openai", 512, 64, 10, 1536, "cosine", 990_000),
                 ("q1", 1, 64, 10, 128, "l2sq", 1_000_000),
                 ("sift", 512, 64, 10, 128, "l2sq", 1_000_000),
                 ("sift wide", 512, 320, 10, 128, "l2sq", 1_000_000))


def rerank_world(seed: int, B: int, ef: int, d: int, rows: int, dev, integer=False):
    """(q [B, d] f32, pool ids [B, ef] i32, rerank tape [rows, d] f32), made
    on the card from `seed`: a tape of N(0, 30^2) values (integers in
    [-40, 40] with `integer`, every sum exact), pools of random rows with
    the last 5 slots -1 in every third query, each query near its pool's
    first row, one pool row repeated at a later position in every query."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if integer:
        tape = torch.randint(-40, 41, (rows, d), generator=g, device=dev).float()
        noise = torch.randint(-5, 6, (B, d), generator=g, device=dev).float()
    else:
        tape = torch.randn((rows, d), generator=g, device=dev) * 30.0
        noise = torch.randn((B, d), generator=g, device=dev) * 10.0
    ids = torch.randint(0, rows, (B, ef), generator=g, device=dev, dtype=torch.int32)
    ids[:, ef // 2] = ids[:, 1]
    ids[::3, ef - 5:] = -1
    q = (tape[ids[:, 0].long()] + noise).contiguous()
    return q, ids, tape


def rerank_verdict(got, want, q, ids, tape, metric: str) -> dict:
    """Kernel (`got`) against plain version (`want`) of rerank_pool on the
    same inputs, within `rescore_verdict`'s tolerance: ids -1 exactly where
    the distance is not finite, in the same places, distances within
    REL_TOL of the magnitude of their terms (`dist_scale` of the queries and
    the pool's rows), and ids equal except at a near-tie (both ids' float64
    distances within that tolerance). Returns the counts and `ok`."""
    gd, gi = got
    wd, wi = want
    out = {"rows": int(gd.shape[0]), "bit_equal": bool(bit_equal(gd, wd) and torch.equal(gi, wi))}
    if gd.shape != wd.shape or gi.shape != wi.shape:
        return dict(out, ok=False, why=f"shapes {tuple(gd.shape)} != {tuple(wd.shape)}")
    fin = torch.isfinite(wd)
    if not torch.equal(torch.isfinite(gd), fin) or not torch.equal(gi < 0, ~fin):
        return dict(out, ok=False, why="finite in one version only, or an id -1 at a finite "
                                       "distance")
    pool = tape[torch.unique(ids[ids >= 0]).long()]
    tol = REL_TOL * dist_scale(q, pool, metric)
    err = float((gd[fin] - wd[fin]).abs().max()) if bool(fin.any()) else 0.0
    out.update(max_abs_err=err, tol=tol)
    if not err <= tol:
        return dict(out, ok=False, why=f"max_abs_err {err:.6g} over tol {tol:.6g}")
    bad = near = 0
    for b, j in (gi != wi).nonzero().tolist():
        a, w = int(gi[b, j]), int(wi[b, j])
        t = true_dists(q[b:b + 1].cpu().numpy(), tape[[a, w]].cpu().numpy()[None], metric)[0]
        if abs(t[0] - t[1]) <= tol:
            near += 1
        else:
            bad += 1
    out.update(ids_differ=near + bad, near_ties=near, not_near=bad)
    return dict(out, ok=bad == 0, why=f"{bad} ids differ at no near-tie" if bad else "")


def rerank_variant(label, q, ids, tape, k: int, metric: str, entry, exact=False) -> dict:
    """The rerank_pool kernel against its plain version (`_rerank_pool_plain`,
    the torch ops the search ran before it) on the card: `rerank_verdict`'s
    tolerance, or with `exact` (integer-valued inputs: every sum exact) ids
    equal and distances bit for bit (cosine: within the tolerance where
    PyTorch's sqrt or division rounds otherwise)."""
    from vss_tpu_torch.index import search as sr

    qn = (q * q).sum(-1)
    got = sr.rerank_pool(q, ids, tape, metric, k, entry, qn)
    want = sr._rerank_pool_plain(q, ids, tape, sr.Metric.parse(metric), k, entry, qn)
    v = rerank_verdict(got, want, q, ids, tape, metric)
    if exact and not v["bit_equal"] and (metric != "cosine" or not v["ok"]):
        fail(f"rerank_pool {label}: not bit for bit on exact sums ({v})")
    if not v["ok"]:
        fail(f"rerank_pool {label}: {v['why']} ({v})")
    log(f"  {label}: {q.shape[0]} queries, pool {ids.shape[1]}, k={k}, {metric}, "
        f"{str(tape.dtype)[6:]} tape of {tape.shape[0]} x {tape.shape[1]}: "
        f"{'bit for bit' if v['bit_equal'] else 'within tolerance'} (max_abs_err "
        f"{v.get('max_abs_err', 0):.6g}, tol {v.get('tol', 0):.6g}, ids at near-ties "
        f"{v.get('near_ties', 0)})")
    return v


@contextlib.contextmanager
def plain_rerank():
    """The graph search's rerank by its plain version while in place:
    `rerank_pool` as `_rerank_pool_plain` (K5's gather, the torch ops and
    the stable sort), as the port reranked before the rerank_pool kernel."""
    from vss_tpu_torch.index import search as sr

    real = sr.rerank_pool

    def plain(q, ids, rerank_tape, metric, k, entry, q_norms=None):
        return sr._rerank_pool_plain(q, ids, rerank_tape, sr.Metric.parse(metric), k, entry,
                                     q_norms)

    sr.rerank_pool = plain
    try:
        yield
    finally:
        sr.rerank_pool = real


def check_rerank_pool(dev, out_dir: str, read_ns: float) -> dict:
    """The rerank_pool kernel against its plain version on the card at the
    gist cell's call (512 x 64 x 960 l2sq), the openai cell's (512 x 64 x
    1,536 cosine), one query of sift's width (1 x 64 x 128) and phase 4's
    two graph paths (512 x 64 and 512 x 320 x 128 l2sq), each on a tape of
    the cell's rows: within the tolerance on real values, bit for bit on
    integer values; bf16 tapes, ip, pools of 4,096 and 10,000 (k up to
    5,000: the kernel's chunks and rounds) and an empty graph besides; one
    launch and no host sync at each shape; the kernel's
    device time beside its byte bound (each query's pool rows read once,
    with the queries, ids and outputs) or, at one query, its floor (the
    pool's ids, then its rows: two dependent reads of `read_ns`), and
    beside the torch route's (the plain version, CUDA events); and a
    gist-shaped `HNSWIndex.search` (512 queries, 960-d l2sq, int8 tape with
    its f32 rerank tape) counting one rerank_pool launch a call, its
    answers the plain rerank's."""
    from vss_tpu_torch import HNSWConfig, HNSWIndex, csrc
    from vss_tpu_torch.index import search as sr

    log("rerank_pool")
    entry = torch.zeros((), dtype=torch.int32, device=dev)
    shapes, errs = [], []
    for i, (name, B, ef, k, d, metric, rows) in enumerate(RERANK_SHAPES):
        q, ids, tape = rerank_world(1000 + i, B, ef, d, rows, dev)
        label = f"{name}: {B} x {ef} x {d}"
        errs.append(rerank_variant(label, q, ids, tape, k, metric, entry)["max_abs_err"])
        rerank_variant(f"{label}, bf16 tape", q, ids, tape.to(torch.bfloat16), k, metric, entry)
        rerank_variant(f"{label}, ip", q, ids, tape, k, "ip", entry)
        rerank_variant(f"{label}, k = ef", q, ids, tape, ef, metric, entry)
        rerank_variant(f"{label}, an empty graph", q, ids, tape, k, metric,
                       torch.full((), -1, dtype=torch.int32, device=dev))
        one_launch_no_sync(lambda: sr.rerank_pool(q, ids, tape, metric, k, entry), "rerank_pool")
        qn = (q * q).sum(-1)
        ms = device_ms(lambda: sr.rerank_pool(q, ids, tape, metric, k, entry, qn), 50,
                       "rerank_pool_kernel", out_dir)
        event_ms = cuda_ms(lambda: sr.rerank_pool(q, ids, tape, metric, k, entry, qn), 50)
        plain_ms = cuda_ms(lambda: sr._rerank_pool_plain(q, ids, tape, sr.Metric.parse(metric),
                                                          k, entry, qn), 20)
        bytes_moved = B * ef * d * 4 + B * d * 4 + B * 4 + B * ef * 4 + B * k * 8
        b_ms, b_by = bound(bytes_moved, 3.0 * B * ef * d, "f32")
        floor_ms = 2 * read_ns / 1e6
        log(f"  {label} {metric}: kernel {ms:.4f} ms device ({event_ms:.4f} ms between CUDA "
            f"events), bound {b_ms:.4f} ms ({b_by}: {bytes_moved / 1e6:.1f} MB, each query's rows once), "
            f"floor {floor_ms:.4f} ms (two dependent reads), the torch route {plain_ms:.4f} ms")
        shapes.append(dict(label=f"{label} {metric}", ms=ms, event_ms=event_ms, plain_ms=plain_ms,
                           bound_ms=b_ms, bound_by=b_by, floor_ms=floor_ms))
        qi, idi, ti = rerank_world(2000 + i, B, ef, d, min(rows, 100_000), dev, integer=True)
        for met in ("l2sq", "ip", "cosine"):
            rerank_variant(f"{name} integer-valued, {met}", qi, idi, ti, k, met, entry, exact=True)
        del q, ids, tape, qi, idi, ti
        torch.cuda.empty_cache()
    # wide pools: 4,096 positions a query (one chunk of the kernel's sort),
    # and 10,000 (three chunks) with k past a chunk (two rounds of outputs)
    q, ids, tape = rerank_world(3000, 8, 4096, 128, 100_000, dev)
    rerank_variant("8 x 4,096 x 128 l2sq", q, ids, tape, 100, "l2sq", entry)
    q, ids, tape = rerank_world(3001, 8, 10_000, 128, 100_000, dev)
    for kw in (100, 5_000):
        rerank_variant(f"8 x 10,000 x 128 l2sq, k={kw}", q, ids, tape, kw, "l2sq", entry)
        one_launch_no_sync(lambda: sr.rerank_pool(q, ids, tape, "l2sq", kw, entry), "rerank_pool")
    qi, idi, ti = rerank_world(3002, 4, 10_000, 128, 100_000, dev, integer=True)
    rerank_variant("4 x 10,000 x 128 integer-valued, k=5,000", qi, idi, ti, 5_000, "l2sq", entry,
                   exact=True)
    # a gist-shaped index: one rerank_pool launch a search call, its
    # answers the plain rerank's
    rng = np.random.default_rng(4)
    vecs = rng.normal(size=(20_000, 960)).astype(np.float32) * 30
    idx = HNSWIndex.build(vecs, HNSWConfig(dims=960, metric="l2sq", storage_dtype="int8"),
                          device=dev)
    qb = torch.from_numpy(vecs[:BATCH] + rng.normal(size=(BATCH, 960)).astype(np.float32)).to(dev)
    idx.search(qb, K, ef=EF)
    before = {n: kk.launches for n, kk in csrc.KERNELS.items()}
    got = idx.search(qb, K, ef=EF)
    ran = {n: kk.launches - before[n] for n, kk in csrc.KERNELS.items()
           if kk.launches != before[n]}
    if ran.get("rerank_pool") != 1 or ran.get("gather_rows"):
        fail(f"rerank_pool: a gist-shaped search launched {ran}, not one rerank_pool and no "
             f"gather_rows")
    with plain_rerank():
        want = idx.search(qb, K, ef=EF)
    gd, gi, wd, wi = (t.cpu().numpy() for t in (*got, *want))
    fin = np.isfinite(wd)
    if not np.array_equal(np.isfinite(gd), fin):
        fail("rerank_pool: the gist-shaped search's finite distances sit elsewhere than the "
             "plain rerank's")
    tol = REL_TOL * float(np.abs(wd[fin]).max())
    err = float(np.abs(gd[fin] - wd[fin]).max())
    near = bad = 0
    qh = qb.cpu().numpy()
    for b, j in zip(*np.nonzero(gi != wi)):
        t = true_dists(qh[b:b + 1], vecs[[int(gi[b, j]), int(wi[b, j])]][None], "l2sq")[0]
        near, bad = (near + 1, bad) if abs(t[0] - t[1]) <= tol else (near, bad + 1)
    if err > tol or bad:
        fail(f"rerank_pool: the gist-shaped search differs from the plain rerank's (max_abs_err "
             f"{err}, tol {tol}, {bad} ids at no near-tie)")
    log(f"  gist-shaped HNSWIndex.search ({idx.count} x 960 l2sq, int8 with an f32 rerank tape, "
        f"{BATCH} queries, k={K}, ef={EF}): launches {ran}; against the plain rerank's answers "
        f"max_abs_err {err:.6g} (tol {tol:.6g}), ids at near-ties {near}")
    del idx
    return dict(ms=shapes[0]["ms"], plain_ms=shapes[0]["plain_ms"],
                bound_ms=shapes[0]["bound_ms"], bound_by=shapes[0]["bound_by"], library_ms=None,
                max_abs_err=errs[0], shapes=shapes, search_launches=ran)


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


def adjacency_hash(index, n: int) -> str:
    """sha256 of the graph's adjacency over its first n slots: their levels,
    base rows, and upper rows in level order (the scatter sinks, which
    nothing reads, left out)."""
    g = index.graph
    h = hashlib.sha256()
    up = g.upper_row[:n]
    rows = up[up >= 0].long()
    for t in (g.levels[:n], g.adj0[:n], up, g.upper_adj[rows]):
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


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
    for kname in ("gather_rows", "greedy_descent", "beam_search", "select_neighbors"):
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
    for kname in ("greedy_descent", "select_neighbors"):
        if steps[f"insert {N_RECYCLE} rows into recycled slots"]["launches"][kname] <= 0:
            fail(f"kernel {kname} was not launched by the recycling insert")
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
    for kname in ("greedy_descent", "beam_search", "select_neighbors"):
        if steps[f"wave build of {nb} rows"]["launches"][kname] <= 0:
            fail(f"kernel {kname} was not launched by the wave build")
    # the same build with the plain select_neighbors (the eager loop through
    # K5) in place of the kernel: on the int8 tape the sums are exact, so
    # the adjacency must be the same
    from vss_tpu_torch.index import build as wb
    from vss_tpu_torch.index import select as sl

    wb.select_neighbors = sl._select_neighbors_plain
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain_built = HNSWIndex.build(vecs[:nb], idx.config, method="wave", wave_size=WAVE,
                                      device=dev)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
    finally:
        wb.select_neighbors = sl.select_neighbors
    hashes = {"kernel": adjacency_hash(built, nb), "plain": adjacency_hash(plain_built, nb)}
    log(f"wave build of {nb} rows: adjacency sha256 {hashes['kernel']} with the "
        f"select_neighbors kernel, {hashes['plain']} with the plain version ({plain_s:.2f} s "
        f"against {wave_s:.2f} s)")
    if hashes["kernel"] != hashes["plain"]:
        fail("the wave build's adjacency differs between the select_neighbors kernel and its "
             "plain version")
    del plain_built
    return {
        "card": smi, "steps": steps,
        "insert": {"rows": N_INSERT, "wave": WAVE, "rows_per_s": N_INSERT / ins_s,
                   "self_hit_at_1": self_hit, "capacity": [cap0, 2 * cap0]},
        "delete": {"rows": int(gone.size), "recall_at_10_with_tombstones": r_deleted},
        "recycle": {"rows": N_RECYCLE, "rows_per_s": N_RECYCLE / rec_s},
        "compact": {"seconds": compact_s, "rows": int(live.sum()),
                    "recall_at_10": r_compact, "scan_recall_at_10": r_compact_scan},
        "wave_build": {"rows": nb, "seconds": wave_s, "recall_at_10": r_wave,
                       "plain_select_seconds": plain_s, "adjacency_sha256": hashes["kernel"]},
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
    need("hnsw_index_scan", "beam_search", "pivot_seeds")
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
    need("hnsw_index_join", "beam_search", "pivot_seeds", "rerank_pool")
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
    for k, kname in ((K, "scan_segmin"), (K_DEEP, "pairwise_topk")):
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
    need("calibrate", "native_segmin", "rescore_topk")
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
        need("exact_scan_join", "native_segmin", "rescore_topk")
        got, _ = join_ids(res, "r_id", "l_qid", nq, K)
        exact_checks["flagship"] = recall(got, truth)
    # a corpus where the exact scan wins: the first N_COST_SMALL rows
    db.create_table("items_small", {"id": ids[:N_COST_SMALL], "vec": vecs[:N_COST_SMALL]})
    db.sql("CREATE INDEX idx_small ON items_small USING HNSW (vec) "
           "WITH (metric='l2sq', storage='int8')")
    ks_sql = f"SELECT l_qid, r_id FROM knn_join(queries, items_small, qvec, vec, {K})"
    choices["join of 2048, small corpus"] = explain(db, ks_sql, "EXACT_SCAN_JOIN").splitlines()[1]
    res = step("exact_scan_join small", lambda: db.sql(ks_sql))
    need("exact_scan_join small", "native_segmin", "rescore_topk")
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

    graph_kernels = ("beam_search", "pivot_seeds", "rerank_pool")

    # ---- the sharded bulk build
    idx = step("build", lambda: ShardedHNSWIndex.build(vecs, cfg, mesh))
    # the select_neighbors kernel in refine, upper levels and back-links, K5
    # in the back-links, K3 in the repair
    need("build", "gather_rows", "scan_segmin", "select_neighbors")
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
                          ("native_segmin", "rescore_topk"), N)
    srow = idx.slot_rowid_array()
    if srow.shape != (SHARDS, idx.graphs[0].capacity):
        fail(f"slot_rowid_array is {srow.shape}")
    mask = torch.from_numpy((srow % 2 == 0) & (srow >= 0)).to(dev)
    _, gm_ids = run_path("search, filter id % 2 = 0", lambda qb: idx.search(
        qb, K, ef=EF, filter_mask=mask), graph_kernels, N)
    _, sm_ids = run_path("scan_search, filter id % 2 = 0", lambda qb: idx.scan_search(
        qb, K, filter_mask=mask), ("native_segmin", "rescore_topk"), N)
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
    # the seeding before the pivot_seeds and pivot_product kernels
    # (`seeds_route`, per shard: the f32 GEMM) for the search's before,
    # both kernels after
    def parent_search(qb):
        with parent_seeding():
            return idx.search(qb, K, ef=EF)

    parent_search(q_all[:BATCH])  # warm the route before the turns
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
        "before_after": {
            "scan_search k=10": before_after("sharded scan_search k=10",
                                             lambda qb: idx.scan_search(qb, K), q_all, out_dir),
            "scan_search k=10, phases B and C": before_after(
                "sharded scan_search k=10, phases B and C", lambda qb: idx.scan_search(qb, K),
                q_all, out_dir, before_ctx=plain_rescore, agree=scan_agree(vecs, queries),
                truth=truth),
            "search k=10 ef=64": before_after("sharded search k=10 ef=64",
                                              lambda qb: idx.search(qb, K, ef=EF), q_all,
                                              out_dir, before_fn=parent_search,
                                              agree=graph_agree(lambda qb: idx.search(
                                                  qb, K, ef=EF), q_all))},
    }

    # ---- writes: insert, delete, compact
    wrng = np.random.default_rng(seed + 4)
    new_vecs, _, _ = sift_like(wrng, N_INSERT, 0, D, centers)
    step(f"insert {N_INSERT} rows", lambda: idx.insert(new_vecs, np.arange(N, N + N_INSERT)))
    need(f"insert {N_INSERT} rows", "beam_search", "pivot_seeds", "gather_rows", "greedy_descent",
         "select_neighbors")
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
                         ("native_segmin", "rescore_topk"), n1)
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


def iid_arm(dev, launches, smem_ns: float, out_dir: str) -> dict:
    """bench.py's iid corpus (standard normal x 50, seed 7) cut to N_IID
    rows, m=48, built with `auto`: the IVF lists sample below the recall
    bar there, so the scan pass (K2) makes the candidate lists. Then
    recall@10 at the deep ef ladder of bench.py, the select_neighbors
    kernel against its plain version on the first chunk of each of the
    build's calls (m0=96: refine 128 candidates, the scan pass's cap;
    back-links 112), the refine chunk timed, and K2 timed at the build's shape (SCAN_BATCH
    queries over the tape)."""
    from vss_tpu_torch import HNSWConfig, HNSWIndex
    from vss_tpu_torch.ops import bruteforce_topk
    from vss_tpu_torch.ops import scan as s

    rng = np.random.default_rng(7)
    iv = rng.standard_normal((N_IID, D)).astype(np.float32) * 50.0
    iq = torch.from_numpy(rng.standard_normal((NQ, D)).astype(np.float32) * 50.0).to(dev)
    cfg = HNSWConfig(dims=D, metric="l2sq", storage_dtype="int8", m=48)
    calls = []
    with capture_select(calls, first_per_shape=True):
        index, seconds, counts = timed_build(f"iid auto build of {N_IID} rows, m=48",
                                             lambda: HNSWIndex.build(iv, cfg, device=dev),
                                             launches)
    log("select_neighbors on the iid build's calls (m=48)")
    select_shapes = select_build_calls("iid build", calls, cfg.m0, smem_ns, out_dir)
    del calls
    stats = index.build_stats
    if stats.get("mode") != "hybrid" or not stats.get("scan_fallback"):
        fail(f"the iid build took {stats}; expected the hybrid mode with its scan fallback")
    if counts["native_segmin"] <= 1 or counts["rescore_topk"] <= 1:
        fail(f"K2 and rescore_topk were launched {counts['native_segmin']} and "
             f"{counts['rescore_topk']} times during the iid build: the scan pass did not run "
             f"on it")
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
            "select_neighbors": select_shapes,
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
        pv_slots, pv_vecs, _ = idx.pivots()
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


def k2_only(dev, vecs, queries, smi, krng, out_dir, parent=None) -> int:
    """`--k2-only`: check_k2 on the corpus quantized as the int8 index
    quantizes it, with the index's capacity of rows (the last 8 invalid),
    and without the graph build. With `parent` (`--k2-parent`), that
    checkout's K2 and this one in turns: K2 at the main shape, one query,
    d=960 and the build's shape, and `scan_topk` at `scan_search`'s
    settings (k = 10 and 100, keep 2k, the f32 rerank tape)."""
    from vss_tpu_torch.ops import scan as s
    from vss_tpu_torch.ops.scan import scan_topk

    scale = float(np.abs(vecs).max()) / 127.0
    cap = N + 8
    rr = torch.zeros((cap, D), dtype=torch.float32, device=dev)
    rr[:N] = torch.from_numpy(vecs).to(dev) / scale
    tape = rr.round().clamp(-127, 127).to(torch.int8)
    xn = (tape.float() ** 2).sum(-1)
    valid = torch.arange(cap, device=dev) < N
    q_all = torch.from_numpy(queries).to(dev)
    q_scaled = (q_all[:BATCH] / scale).contiguous()
    result = check_k2(dev, tape, xn, valid, q_scaled, krng)
    if parent:
        old = load_parent_k2(parent)
        qb = q_scaled.to(torch.bfloat16)
        q960 = torch.from_numpy(krng.normal(size=(BATCH, 960)).astype(np.float32) * 5).to(
            dev, torch.bfloat16)
        t960 = torch.from_numpy(krng.integers(-127, 128, (70_037, 960)).astype(np.int8)).to(dev)
        n960 = (t960.float() ** 2).sum(-1)
        v960 = torch.ones(t960.shape[0], dtype=torch.bool, device=dev)
        tb, vb = tape[:N_IID], valid[:N_IID]
        qs = tb[:SCAN_BATCH].float().to(torch.bfloat16)
        turns = {
            "main": k2_turns("K2 main shape", lambda: s.native_segmin(qb, tape, xn, valid, "l2sq"),
                             old, 20),
            "one query": k2_turns("K2 one query",
                                  lambda: s.native_segmin(qb[:1], tape, xn, valid, "l2sq"), old, 20),
            "d=960": k2_turns("K2 512 x int8 70,037 x 960",
                              lambda: s.native_segmin(q960, t960, n960, v960, "l2sq"), old, 20),
            "build shape": k2_turns(f"K2 {SCAN_BATCH} x int8 {N_IID} x {D}",
                                    lambda: s.native_segmin(qs, tb, xn[:N_IID], vb, "l2sq"), old, 5),
        }
        for k in (K, K_DEEP):
            def fn(qb, k=k):
                d, i = scan_topk(qb / scale, tape, k, "l2sq", valid_mask=valid, x_norms=xn,
                                 rerank_tape=rr, keep=2 * k, device=dev)
                return d * scale * scale, i
            with parent_k2(old):  # warm both before the turns
                fn(q_all[:BATCH])
            fn(q_all[:BATCH])
            turns[f"scan_topk k={k}"] = before_after(
                f"scan_topk k={k}, the parent's K2", fn, q_all, out_dir,
                before_ctx=lambda: parent_k2(old), agree=scan_agree(vecs, queries))
        result["parent_turns"] = turns
    log(smi)
    log(json.dumps({"native_segmin": result}))
    return 0


def rescore_only(dev, vecs, queries, smi, out_dir) -> int:
    """`--rescore-only`: check_rescore on the corpus quantized as the int8
    index quantizes it (the index's capacity of rows, the last 8 invalid,
    the f32 rerank tape of the scaled rows), without the graph build; then
    `scan_topk` at `scan_search`'s k = 10 and 100 (keep 2k) with the plain
    phases B and C before and the kernel after, in turns."""
    from vss_tpu_torch.ops.scan import scan_topk

    scale = float(np.abs(vecs).max()) / 127.0
    cap = N + 8
    rr = torch.zeros((cap, D), dtype=torch.float32, device=dev)
    rr[:N] = torch.from_numpy(vecs).to(dev) / scale
    tape = rr.round().clamp(-127, 127).to(torch.int8)
    xn = (tape.float() ** 2).sum(-1)
    valid = torch.arange(cap, device=dev) < N
    q_all = torch.from_numpy(queries).to(dev)
    result = check_rescore(dev, tape, xn, valid, rr, (q_all[:BATCH] / scale).contiguous(),
                           np.random.default_rng(2), out_dir)
    for k in (K, K_DEEP):
        def fn(qb, k=k):
            d, i = scan_topk(qb / scale, tape, k, "l2sq", valid_mask=valid, x_norms=xn,
                             rerank_tape=rr, keep=2 * k, device=dev)
            return d * scale * scale, i
        result[f"scan_topk k={k}"] = before_after(
            f"scan_topk k={k}, phases B and C", fn, q_all, out_dir, before_ctx=plain_rescore,
            agree=scan_agree(vecs, queries))
    log(smi)
    log(json.dumps({"rescore_topk": result}))
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
    ap.add_argument("--k2-parent", metavar="DIR", default=None,
                    help="a checkout of another tree (its vss_tpu_torch/csrc/scan.cu): with "
                         "--k2-only, its K2 and this one in turns, K2 alone and in scan_topk; "
                         "in the full run, scan_search k=10 and 100 with each")
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
    ap.add_argument("--select-k-only", action="store_true",
                    help="build selectk.cu alone and run check_select_k on the main path's "
                         "shapes made from random data, without the index build; prints the "
                         "kernel's entry and no result line")
    ap.add_argument("--pairwise-topk-only", action="store_true",
                    help="build pairtopk.cu, distance.cu and selectk.cu alone and run "
                         "check_pairwise_topk and the k=100 oracle before and after on the "
                         "corpus, without the index build; prints the kernel's entry and no "
                         "result line")
    ap.add_argument("--pivot-seeds-only", action="store_true",
                    help="build seeds.cu, selectk.cu, gather.cu and pivots.cu alone and run "
                         "check_pivot_seeds over the corpus quantized to int8 with a pivot "
                         "sample drawn as the index draws its levels, without the index build; "
                         "prints the kernel's entry and no result line")
    ap.add_argument("--pivot-product-only", action="store_true",
                    help="build pivots.cu, seeds.cu, selectk.cu and gather.cu alone and run "
                         "check_pivot_product on tapes made on the card, without the corpus or "
                         "the index build; prints the kernel's entry and no result line")
    ap.add_argument("--witnesses-only", action="store_true",
                    help="build every kernel and run check_witnesses alone: the benchmark's "
                         "sift1m index and churn cell at the seeds where an answer once named "
                         "a row twice; prints the result line of the witnesses")
    ap.add_argument("--rescore-only", action="store_true",
                    help="build rescore.cu, scan.cu and selectk.cu alone and run check_rescore "
                         "on the corpus quantized to int8, then scan_topk at k=10 and 100 with "
                         "the plain phases B and C and with the kernel, without the index "
                         "build; prints the kernel's entry and no result line")
    ap.add_argument("--rerank-only", action="store_true",
                    help="build every kernel and run check_rerank_pool alone: the graph "
                         "search's rerank at the gist, openai and one-query shapes on tapes "
                         "made on the card, and a gist-shaped HNSWIndex.search; prints the "
                         "kernel's entry and no result line")
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
    libs = ["scan", "selectk", "rescore"] if args.k2_only else sorted(csrc.SOURCES)
    if args.select_k_only:
        libs = ["selectk"]
    if args.pairwise_topk_only:
        libs = ["pairtopk", "distance", "selectk"]
    if args.pivot_seeds_only:
        libs = ["seeds", "selectk", "gather", "pivots"]
    if args.pivot_product_only:
        libs = ["pivots", "seeds", "selectk", "gather"]
    if args.rescore_only:
        libs = ["rescore", "scan", "selectk"]
    if args.beam_serving:
        libs = ["beam", "gather"]
    log(f"build: {csrc.build(libs):.2f} s for {libs}")
    for lib in libs:
        path = os.path.join(csrc.BUILD_DIR, f"{lib}.log")
        if os.path.exists(path):
            for line in open(path).read().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  ptxas {lib}: {line.strip()}")

    if args.witnesses_only:
        log(json.dumps({"witnesses": check_witnesses(dev)}))
        return 0
    if args.rerank_only:
        log(smi)
        entry = check_rerank_pool(dev, args.trace_dir or os.path.join(csrc.BUILD_DIR, "traces"),
                                  dependent_read_ns(dev))
        entry["launches"] = csrc.KERNELS["rerank_pool"].launches
        log(smi)
        log(json.dumps({"rerank_pool": entry}))
        return 0
    if args.pivot_product_only:
        log(smi)
        entry = check_pivot_product(dev, args.trace_dir or os.path.join(csrc.BUILD_DIR, "traces"))
        entry["launches"] = csrc.KERNELS["pivot_product"].launches
        log(json.dumps({"pivot_product": entry}))
        return 0

    # ---- data (set-up): bench.py's SIFT-like generator
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    vecs, queries, centers = sift_like(rng, N, NQ, D)
    log(f"data: {N} x {D} corpus, {NQ} queries in {time.perf_counter() - t0:.1f} s")
    if args.k2_only:
        return k2_only(dev, vecs, queries, smi, np.random.default_rng(args.seed + 1),
                       args.trace_dir or os.path.join(csrc.BUILD_DIR, "traces"), args.k2_parent)
    if args.beam_serving:
        return beam_serving(dev, vecs, queries, smi, args.beam_serving)
    out_dir = args.trace_dir or os.path.join(csrc.BUILD_DIR, "traces")
    if args.select_k_only:
        log(smi)
        calls = synthetic_select_k_calls(dev)
        log(json.dumps({"select_k": check_select_k(dev, calls, out_dir)}))
        select_k_splits_sweep(calls)
        return 0
    if args.pairwise_topk_only:
        log(smi)
        x = torch.from_numpy(vecs).to(dev)
        q_all = torch.from_numpy(queries).to(dev)
        entry = check_pairwise_topk(dev, x, q_all[:BATCH].contiguous(),
                                    np.random.default_rng(args.seed + 1), out_dir)
        entry["oracle k=100"] = before_after(
            "oracle k=100", lambda qb: bruteforce_topk(qb, x, K_DEEP, "l2sq", device=dev), q_all,
            out_dir, before_fn=lambda qb: k4_route_bruteforce(qb, x, K_DEEP))
        log(json.dumps({"pairwise_topk": entry}))
        return 0
    if args.pivot_seeds_only:
        log(smi)
        index, q_scaled, wave_scaled = synthetic_pivot_index(
            dev, vecs, queries, np.random.default_rng(args.seed + 2))
        log(json.dumps({"pivot_seeds": check_pivot_seeds(dev, index, q_scaled, wave_scaled,
                                                         out_dir)}))
        return 0
    if args.rescore_only:
        return rescore_only(dev, vecs, queries, smi, out_dir)
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
    build_calls = []  # the first select_neighbors call of each shape, for check_select
    with capture_select(build_calls, first_per_shape=True):
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
    twice = rows_listing_an_id_twice(idx.graph.adj0) + rows_listing_an_id_twice(
        idx.graph.upper_adj)
    if twice:
        fail(f"the auto build wrote {twice} adjacency rows that list an id twice")
    log(f"auto build: sampled IVF list recall@10 {build_stats['ivf_sampled_recall']:.4f}, scan "
        f"fallback {'ran' if build_stats['scan_fallback'] else 'did not run'}, "
        f"{build_stats['bridged']} nodes bridged by the repair, {unreached} of {N} still out of "
        f"reach of the entry over base-layer edges (64 sweeps), no row lists an id twice")
    # the sampled oracle runs the scan (K2, then rescore_topk); refine, the
    # upper levels and the back-links select neighbours (the
    # select_neighbors kernel), the back-links gather their rows (K5)
    for kname in ("native_segmin", "rescore_topk", "gather_rows", "select_neighbors"):
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
        "pairwise_topk": check_pairwise_topk(dev, x, q, krng, out_dir),
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
    results["select_neighbors"] = check_select(dev, idx, wave_vecs, build_calls,
                                               shared_read_ns(dev), out_dir)
    del build_calls
    # select_k at every call of one batch of each path of phase 4
    sk_calls = {}
    with capture_select_k(sk_calls):
        idx.scan_search(q, K)
        idx.scan_search(q, K_DEEP)
        idx.search(q, K, ef=EF)
        bruteforce_topk(q, x, K, "l2sq", device=dev)
        bruteforce_topk(q, x, K_DEEP, "l2sq", device=dev)
    torch.cuda.synchronize()
    missing = set(SELECT_K_SITES) - {c["site"] for c in sk_calls.values()}
    if missing:
        fail(f"select_k: no call from {sorted(missing)} on the main path")
    results["select_k"] = check_select_k(dev, sk_calls, out_dir)
    del sk_calls
    wave_scaled = (torch.from_numpy(wave_vecs).to(dev) / idx.vector_scale).contiguous()
    results["pivot_seeds"] = check_pivot_seeds(dev, idx, q_scaled, wave_scaled, out_dir)
    results["pivot_product"] = check_pivot_product(dev, out_dir)
    results["rescore_topk"] = check_rescore(dev, idx.graph.vectors, idx.norms(), idx.graph.valid,
                                            idx.rerank_tape, q_scaled, krng, out_dir)
    results["rerank_pool"] = check_rerank_pool(dev, out_dir,
                                                results["beam_search"]["dependent_read_ns"])
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
    # above SELECT_K_MAX the chunked oracle keeps K4 and the plain selection
    x_k4 = x[:N_K4_PATH]
    (gt300_d, gt300_i), gt300_ms = run_path(
        "oracle k=300", lambda qb: bruteforce_topk(qb, x_k4, 300, "l2sq", device=dev))
    (sc_d, sc_i), scan_ms = run_path("scan_search k=10", lambda qb: idx.scan_search(qb, K))
    (sc100_d, sc100_i), scan100_ms = run_path(
        "scan_search k=100", lambda qb: idx.scan_search(qb, K_DEEP))
    (gr_d, gr_i), graph_ms = run_path(
        f"search k=10 ef={EF}", lambda qb: idx.search(qb, K, ef=EF))
    # more seeds than select_k takes: the seeding's route, which keeps K1
    # launched on its own
    wide_path = f"search k={K} ef={EF_WIDE}, {N_SEEDS_WIDE} pivot seeds"
    (gw_d, gw_i), wide_ms = run_path(wide_path, lambda qb: wide_seed_search(idx, qb))

    # ---- checks of what came out
    for label, (dd, ii, k) in {
        "oracle k=10": (gt_d, gt_i, K), "oracle k=100": (gt100_d, gt100_i, K_DEEP),
        "scan k=10": (sc_d, sc_i, K), "scan k=100": (sc100_d, sc100_i, K_DEEP),
        "graph k=10": (gr_d, gr_i, K), "oracle k=300": (gt300_d, gt300_i, 300),
        wide_path: (gw_d, gw_i, K),
    }.items():
        if dd.shape != (NQ, k) or ii.shape != (NQ, k):
            fail(f"{label}: shapes {dd.shape} {ii.shape}")
        if not np.isfinite(dd).all() or (ii < 0).any() or (ii >= N).any():
            fail(f"{label}: non-finite distances or ids out of range")
        if (np.diff(dd, axis=1) < 0).any():
            fail(f"{label}: distances not ascending")
    # two independent exact paths (K3 winnow, pairwise_topk) agree
    agree = recall(gt100_i[:, :K], gt_i)
    log(f"oracle k=10 (K3) vs first 10 of k=100 (pairwise_topk): id agreement {agree:.6f}")
    if agree < 0.999:
        fail("the two oracle paths disagree")
    # K4 with the plain selection (k=300) and pairwise_topk (k=256) over the
    # same rows: the same distances bit for bit, so the same first 256
    from vss_tpu_torch.ops import topk as t3
    p256 = [t.cpu().numpy() for t in t3.pairwise_topk(q_all[:BATCH], x_k4, 256, "l2sq")]
    if not (np.array_equal(gt300_i[:BATCH, :256], p256[1])
            and np.array_equal(gt300_d[:BATCH, :256].view(np.int32), p256[0].view(np.int32))):
        fail("oracle k=300 (K4, plain selection) differs from pairwise_topk k=256 in its first "
             "256")
    log(f"oracle k=300 (K4 and the plain selection) over {N_K4_PATH} rows: its first 256 equal "
        f"pairwise_topk k=256's, ids and distances bit for bit")
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
    r_graph, r_wide = recall(gr_i, gt_i), recall(gw_i, gt_i)
    log(f"recall@10 scan_search {r_scan:.4f}; recall@100 scan_search {r_scan100:.4f}; "
        f"recall@10 search ef={EF} {r_graph:.4f} (the same corpus built by the native builder: "
        f"{NATIVE_RECALL}); {wide_path} {r_wide:.4f}")
    # where the time goes: one batch of each serving path under the profiler
    profiles = {
        "scan": profile_batch("scan_search k=10", lambda qb: idx.scan_search(qb, K), q,
                              scan_ms, out_dir),
        "graph": profile_batch(f"search k=10 ef={EF}", lambda qb: idx.search(qb, K, ef=EF), q,
                               graph_ms, out_dir),
    }
    # the plain selections against select_k on each path, in one process
    graph_path = f"search k=10 ef={EF}"
    before_vs_after = {
        label: before_after(label, fn, q_all, out_dir) for label, fn in (
            ("oracle k=10", lambda qb: bruteforce_topk(qb, x, K, "l2sq", device=dev)),
            ("scan_search k=10", lambda qb: idx.scan_search(qb, K)),
            ("scan_search k=100", lambda qb: idx.scan_search(qb, K_DEEP)))}
    # the scans: the plain phases B and C (the parent's) before, the
    # rescore_topk kernel after
    for k, truth in ((K, gt_i), (K_DEEP, gt100_i)):
        label = f"scan_search k={k}, phases B and C"
        before_vs_after[label] = before_after(
            label, lambda qb, k=k: idx.scan_search(qb, k), q_all, out_dir,
            before_ctx=plain_rescore, agree=scan_agree(vecs, queries), truth=truth)
    # with --k2-parent: the scans with that checkout's K2 before, this one
    # after
    if args.k2_parent:
        k2_old = load_parent_k2(args.k2_parent)
        for k, truth in ((K, gt_i), (K_DEEP, gt100_i)):
            with parent_k2(k2_old):  # warm both before the turns
                idx.scan_search(q, k)
            idx.scan_search(q, k)
            label = f"scan_search k={k}, the parent's K2"
            before_vs_after[label] = before_after(
                label, lambda qb, k=k: idx.scan_search(qb, k), q_all, out_dir,
                before_ctx=lambda: parent_k2(k2_old), agree=scan_agree(vecs, queries),
                truth=truth)
    # the graph search: the seeding before the pivot_seeds and
    # pivot_product kernels (`seeds_route`: the f32 GEMM) before, both
    # kernels after
    def parent_search(qb):
        with parent_seeding():
            return idx.search(qb, K, ef=EF)

    parent_search(q)  # warm the route before the turns
    before_vs_after[graph_path] = before_after(
        graph_path, lambda qb: idx.search(qb, K, ef=EF), q_all, out_dir, before_fn=parent_search,
        agree=graph_agree(lambda qb: idx.search(qb, K, ef=EF), q_all))
    # the graph paths' rerank: the plain version (K5's gather, the torch
    # ops and the stable sort) before, the rerank_pool kernel after, on the
    # same pools (the seeding and the beam are the same on both sides)
    for label, fn, truth in ((graph_path, lambda qb: idx.search(qb, K, ef=EF), gt_i),
                             (wide_path, lambda qb: wide_seed_search(idx, qb), gt_i)):
        with plain_rerank():  # warm the route before the turns
            fn(q)
        before_vs_after[f"{label}, the rerank"] = before_after(
            f"{label}, the rerank", fn, q_all, out_dir, before_ctx=plain_rerank,
            agree=scan_agree(vecs, queries), truth=truth)
    # the k=100 oracle: the parent's route (K4 blocks and select_k, composed
    # here) before, pairwise_topk after
    before_vs_after["oracle k=100"] = before_after(
        "oracle k=100", lambda qb: bruteforce_topk(qb, x, K_DEEP, "l2sq", device=dev), q_all,
        out_dir, before_fn=lambda qb: k4_route_bruteforce(qb, x, K_DEEP))
    summary = {
        "card": smi, "n": N, "d": D, "queries": NQ, "batch": BATCH,
        "build": {"method": "auto", "seconds": build_s, "stats": build_stats,
                  "launches": build_counts},
        "scan": {"ms_per_batch": scan_ms, "qps": BATCH / scan_ms * 1e3, "recall_at_10": r_scan},
        "scan_k100": {"ms_per_batch": scan100_ms, "qps": BATCH / scan100_ms * 1e3,
                      "recall_at_100": r_scan100},
        "graph": {"ef": EF, "ms_per_batch": graph_ms, "qps": BATCH / graph_ms * 1e3,
                  "recall_at_10": r_graph},
        "graph_wide_seeds": {"ef": EF_WIDE, "n_seeds": N_SEEDS_WIDE, "ms_per_batch": wide_ms,
                             "recall_at_10": r_wide},
        "oracle_ms_per_batch": {"k10": gt_ms, "k100": gt100_ms,
                                f"k300 over {N_K4_PATH} rows": gt300_ms},
        "launches_per_path": per_path,
        "profiles": profiles,
        "before_after": before_vs_after,
        "host_us_per_call": host_us,
    }
    log("main path: " + json.dumps(summary))
    if r_scan < 0.99:
        fail(f"scan recall@10 {r_scan} < 0.99")
    if r_graph < 0.85 or r_wide < 0.85:
        fail(f"graph recall@10 {r_graph}, with {N_SEEDS_WIDE} seeds {r_wide}: under 0.85")
    needed = {"scan_segmin": ["oracle k=10"], "pairwise_topk": ["oracle k=100"],
              "pairwise": ["oracle k=300"],
              "native_segmin": ["scan_search k=10"], "beam_search": [graph_path, wide_path],
              "rescore_topk": ["scan_search k=10", "scan_search k=100"],
              "select_k": ["oracle k=10", "scan_search k=10", "scan_search k=100"],
              # the seeding and the rerank of the graph search; K1 on its
              # own only past select_k's widest k
              "pivot_seeds": [graph_path], "pivot_product": [graph_path],
              "rerank_pool": [graph_path, wide_path],
              "gather_distances": [wide_path]}
    for kname, labels in needed.items():
        for label in labels:
            if per_path[label][kname] <= 0:
                fail(f"kernel {kname} was not launched on the path '{label}'")
    for label in ("scan_search k=10", "scan_search k=100"):
        if per_path[label]["rescore_topk"] != NQ // BATCH:
            fail(f"{label}: rescore_topk launched {per_path[label]['rescore_topk']} times in "
                 f"{NQ // BATCH} batches, not once a batch")
    if per_path[graph_path]["gather_distances"] or per_path[graph_path]["select_k"]:
        fail(f"{graph_path} launched gather_distances or select_k: its seeding is pivot_seeds")
    if per_path[graph_path]["rerank_pool"] != NQ // BATCH or per_path[graph_path]["gather_rows"]:
        fail(f"{graph_path}: rerank_pool launched {per_path[graph_path]['rerank_pool']} times in "
             f"{NQ // BATCH} batches, gather_rows {per_path[graph_path]['gather_rows']}: not one "
             f"rerank_pool a batch and no gather")
    log(f"{graph_path}, {NQ // BATCH} batches: beam_search launched "
        f"{per_path[graph_path]['beam_search']} times, pivot_seeds "
        f"{per_path[graph_path]['pivot_seeds']}, rerank_pool "
        f"{per_path[graph_path]['rerank_pool']}, gather_rows 0, gather_distances 0")
    summary["entry"] = entry_call(dev, launches, out_dir)

    # ---- phase 5: the write path, on the same index
    write = write_path(args.seed, idx, dev, smi, vecs, x, q_all, centers, launches, out_dir)
    log("write path: " + json.dumps(write))
    del idx

    # ---- phase 6: the builders side by side, the iid arm, and on request
    # the 960-d arm
    builds = {"builders": compare_builders(dev, vecs, q_all, launches),
              "iid": iid_arm(dev, launches, results["select_neighbors"]["shared_read_ns"],
                             out_dir)}
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
        "pairwise_topk": ("vss_tpu_torch/csrc/pairtopk.cu",
                          "vss_tpu/ops/distance.py:113 (K4) with the XLA scan step of "
                          "vss_tpu/ops/topk.py:62-100 (mask, NaN as +inf, the stable merge)"),
        "gather_rows": ("vss_tpu_torch/csrc/gather.cu", "vss_tpu/ops/gather.py:39"),
        "beam_search": ("vss_tpu_torch/csrc/beam.cu",
                        "vss_tpu/ops/gather.py:142 and :39 inside the loop of "
                        "vss_tpu/index/search.py:442"),
        "greedy_descent": ("vss_tpu_torch/csrc/descent.cu",
                           "vss_tpu/index/search.py:102-150, with vss_tpu/ops/gather.py:142 "
                           "(K1) and :39 (K5) inside its step"),
        "select_neighbors": ("vss_tpu_torch/csrc/select.cu",
                             "vss_tpu/index/select.py:35-105, with vss_tpu/ops/gather.py:39 "
                             "(K5) inside"),
        "select_k": ("vss_tpu_torch/csrc/selectk.cu",
                     "vss_tpu/ops/topk.py:38 (_iter_min_k) and vss_tpu/ops/scan.py:125 "
                     "(_select_min_k, lax.top_k above k=32): XLA after K2, K3 and K4"),
        "pivot_seeds": ("vss_tpu_torch/csrc/seeds.cu",
                        "vss_tpu/ops/gather.py:142 (K1, the seed rescoring of "
                        "vss_tpu/index/search.py:520-526) with the XLA pivot seeding of "
                        "vss_tpu/index/search.py:451-493 (epilogue, mask, top_k, slot map)"),
        "pivot_product": ("vss_tpu_torch/csrc/pivots.cu",
                          "the XLA pivot product of vss_tpu/index/search.py:451-493 "
                          "(dot_general of the queries and the pivots' f32 rows), a cuBLAS "
                          "f32 GEMM in the port before"),
        "rescore_topk": ("vss_tpu_torch/csrc/rescore.cu",
                         "vss_tpu/ops/scan.py:216-321 (the XLA after K2: _rescore_native, "
                         "_gather_segment_blocks, _rescore_native_block)"),
        "rerank_pool": ("vss_tpu_torch/csrc/rerank.cu",
                        "vss_tpu/index/search.py:537-552 (the XLA after K5: the pool's rows "
                        "taken from the rerank tape, the direct difference or "
                        "gathered_distances, the mask, the stable sort, the k cut)"),
    }
    table = [
        {"name": kname, "route": "cuda", "source": meta[kname][0], "replaces": meta[kname][1],
         "launches": launches[kname], **results[kname]}
        for kname in ("gather_distances", "native_segmin", "scan_segmin", "pairwise",
                      "pairwise_topk", "gather_rows", "beam_search", "greedy_descent",
                      "select_neighbors", "select_k", "pivot_seeds", "pivot_product",
                      "rescore_topk", "rerank_pool")
    ]
    log(smi)
    log(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
