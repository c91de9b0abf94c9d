"""Batched HNSW search: seeding + base-layer beam search + exact rerank.

Reproduces `vss_tpu/index/search.py`: the serving search and, through
the `level` argument of `beam_search_base`, the construction beams of
`index/build.py`:

  * batch-first: a whole [B] batch of queries traverses in lockstep;
    per-query early exit is a `done` mask;
  * no visited set: novelty is tested by membership against the
    candidate pool, the expansion history and the result pool;
  * two pools: the candidate pool drives traversal and ignores
    tombstones (deleted nodes still route); the result pool only admits
    `valid & filter` nodes.

The JAX package runs the beam and the greedy descent each as one
`lax.while_loop` with its gather kernels inside. Here, for CUDA tensors,
each is one launch of a hand-written kernel with no host sync:

  * `beam_search_base` launches `beam_search` (`csrc/beam.cu`): one thread
    block per query runs the whole loop with the pools in shared memory,
    the adjacency load (kernel K5's work) and the scoring (kernel K1's) as
    device functions inside it (pools too large for shared memory live in
    a per-query workspace in device memory instead; rows of 512 bytes or
    more are copied into shared memory together before a warp scores
    each, where that fits, `_BEAM.routed` counting those launches);
  * `greedy_descent` launches `greedy_descent` (`csrc/descent.cu`): one
    thread block per query walks the upper levels, reading each adjacency
    row and scoring its neighbours with the same device functions, the
    argmin and the level drop in registers and shared memory.

Nothing of one query's state is read by another, so the batch's lockstep
loop and B independent loops give the same result; each kernel's
iteration counter is the largest any query ran.

`_beam_search_base_plain` and `_greedy_descent_plain` are the kernels'
plain versions and what runs for CPU tensors: the lockstep loops in
PyTorch, every distance through K1 (`ops/gather.gather_distances`) and
every adjacency gather through K5 (`ops/gather.gather_rows`), each the
hand-written kernel on CUDA and its plain version on the CPU, so that on
the card they are the kernels' references. The beam loop checks its done
latch on the host every `_SYNC_EVERY` iterations; iterations after every
query is done change nothing, so the result equals a check every
iteration. The descent loop checks at every step.

The pivot seeding (`scored_pivot_seeds`) is, for CUDA tensors, the
product of the queries and the pivots and one launch of the
`pivot_seeds` kernel (`csrc/seeds.cu`): the metric epilogue, the
padding mask, the stable k smallest, the slot map and each seed's
distance (kernel K1's code) in one pass over the product, no host sync.
Over an int8 or bf16 tape the product is the `pivot_product` kernel
(`csrc/pivots.cu`: the pivots' tape rows on the tensor cores against
each f32 query split exactly into three bf16 planes, `split_planes`; one
launch, or one a column group for rows past 1,088 int8 / 1,024 bf16
values); over an f32 tape, `torch.matmul` in f32. The product is the
span `vss.search.product` inside `vss.search.seed`. Its plain version,
and what runs for CPU tensors, is `pivot_seeds` followed by K1's plain
version.

The rerank (`rerank_pool`) is, for CUDA tensors, one launch of the
`rerank_pool` kernel (`csrc/rerank.cu`): each query's ef-wide result pool
rescored from the full-precision side tape by id, sorted stably and cut to
k, the empty graph's answer read on the device. Its plain version, and what
runs for CPU tensors, is `_rerank_pool_plain`: the rows gathered through
K5, the torch ops and a stable sort.

`hnsw_search` records its phases as the spans `vss.search.seed`, `.beam`
and `.rerank` while the torch profiler runs (`utils/trace.py`).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from vss_tpu_torch import csrc
from vss_tpu_torch.index.graph import HNSWConfig, HNSWGraph
# `select_k` is called through its module, so that a patch of
# `topk.select_k` (chip_smoke.py's plain selection, the tests' spies)
# reaches these calls too
from vss_tpu_torch.ops import topk
from vss_tpu_torch.ops.distance import METRIC_IDS, Metric, _epilogue, gathered_distances
from vss_tpu_torch.ops.gather import _gather_distances_plain, gather_distances, gather_rows
from vss_tpu_torch.ops.topk import SELECT_K_MAX, _select_k_splits
from vss_tpu_torch.utils import round_up
from vss_tpu_torch.utils.trace import span

__all__ = ["hnsw_search", "greedy_descent", "pivot_seeds", "scored_pivot_seeds",
           "pivot_product", "split_planes", "beam_search_base", "beam_smem_bytes",
           "rerank_pool"]

_INF = float("inf")

# host syncs of the plain beam loop's done latch: one per this many iterations
_SYNC_EVERY = 4

# a block's shared memory, the most csrc/beam.cu asks for; past it the
# pools move to the wide layout's workspace in device memory
_BEAM_MAX_SMEM = 232448
# the shared memory a block of the beam's staged route fills with rows, at
# most (`kStageBudget` in csrc/beam.cu): an SM's 233,472 bytes shared by 4
# blocks, less the 1 KB each reserves
_BEAM_STAGE_BUDGET = 233472 // 4 - 1024

# `_BEAM.routed` counts the launches that took the staged route (rows of
# 512 bytes or more: each step's live rows copied to shared memory
# together, then scored by `score_row_wide`, csrc/gather.cuh)
_BEAM = csrc.register(csrc.Kernel(
    "beam_search", "beam", "vss_beam_search",
    [csrc.PTR] * 12 + [ctypes.POINTER(ctypes.c_int)] + [csrc.I32] * 13 + [csrc.I64] * 3,
))

_DESCENT = csrc.register(csrc.Kernel(
    "greedy_descent", "descent", "vss_greedy_descent",
    [csrc.PTR] * 11 + [csrc.I32] * 7,
))

_SEEDS = csrc.register(csrc.Kernel(
    "pivot_seeds", "seeds", "vss_pivot_seeds",
    [csrc.PTR] * 9 + [csrc.I32, csrc.I64] + [csrc.I32] * 5,
))

_PIVOTS = csrc.register(csrc.Kernel(
    "pivot_product", "pivots", "vss_pivot_product",
    [csrc.PTR] * 4 + [csrc.I32] * 4 + [ctypes.POINTER(ctypes.c_int)],
))

_RERANK = csrc.register(csrc.Kernel(
    "rerank_pool", "rerank", "vss_rerank_pool",
    [csrc.PTR] * 7 + [csrc.I32, csrc.I32, csrc.I64] + [csrc.I32] * 4,
))


def _descent_iters(config: HNSWConfig, max_iters: int) -> int:
    """The descent's step cap: `max_iters`, or by default one that no
    descent reaches (levels drop only on non-improving steps; improving
    steps are bounded by path length)."""
    return max_iters if max_iters > 0 else 8 * config.max_levels + 32


def greedy_descent(
    graph: HNSWGraph,
    config: HNSWConfig,
    q: torch.Tensor,
    stop_level=0,
    max_iters: int = 0,
    q_norms: Optional[torch.Tensor] = None,
):
    """Descend from the entry point to `stop_level` (per-query or scalar).

    Returns (cur [B] i32, cur_d [B] f32): the beam-search seed.

    CUDA tensors: one launch of the `greedy_descent` kernel, no host sync.
    CPU tensors: the plain loop."""
    max_iters = _descent_iters(config, max_iters)
    if q.device.type == "cpu":
        return _greedy_descent_plain(graph, config, q, stop_level, max_iters, q_norms)
    return _descent_launch(graph, config, q, stop_level, max_iters, q_norms)[:2]


def _greedy_descent_plain(graph, config, q, stop_level, max_iters, q_norms, visits=None):
    """Plain version of the `greedy_descent` kernel: the batch in lockstep,
    queries that reached their stop level frozen, K5 for the adjacency rows
    and K1 for the distances once per step, the loop head a host sync.
    Returns (cur, cur_d). Given a list `visits`, appends to it one pair a
    step: the tape rows scored (ids >= 0) and the adjacency rows read, by
    queries not yet frozen (`_descent_counters` sums them as the kernel
    counts)."""
    B = q.shape[0]
    dev = q.device
    cur = graph.entry.clamp(min=0).expand(B).clone()
    cur_d = gather_distances(graph.vectors, cur[:, None], q, config.metric, q_norms)[:, 0]
    start = graph.max_level.clamp(min=0)
    stop = torch.as_tensor(stop_level, dtype=torch.int32, device=dev).expand(B)
    lvl = torch.maximum(start.expand(B), stop)
    for _ in range(max_iters):
        live = lvl > stop
        if not bool(live.any()):
            break
        # upper_row column for level `lvl` is lvl-1; only meaningful when lvl >= 1
        col = (lvl - 1).clamp(min=0)
        row = graph.upper_row[cur.long()].gather(1, col[:, None].long())[:, 0]
        active = (lvl > 0) & (row >= 0)
        neigh = gather_rows(graph.upper_adj, row)  # [B, M]
        neigh = torch.where(active[:, None], neigh, -1)
        nd = gather_distances(graph.vectors, neigh, q, config.metric, q_norms)
        if visits is not None:
            visits.append((neigh[(neigh >= 0) & live[:, None]], row[active & live]))
        j = torch.argmin(nd, dim=1, keepdim=True)
        best_d = nd.gather(1, j)[:, 0]
        best_i = neigh.gather(1, j)[:, 0]
        improved = active & (best_d < cur_d) & live
        cur = torch.where(improved, best_i, cur)
        cur_d = torch.where(improved, best_d, cur_d)
        # no improvement (or no row at this level) -> drop a level; frozen
        # queries keep theirs
        lvl = torch.where(improved | ~live, lvl, (lvl - 1).clamp(min=0))
    return cur, cur_d


def _descent_counters(visits) -> tuple:
    """The kernel's three counters from `_greedy_descent_plain`'s
    `visits`: steps (the most any query ran), tape rows scored, adjacency
    rows read."""
    return (len(visits), sum(int(s.numel()) for s, _ in visits),
            sum(int(r.numel()) for _, r in visits))


def _descent_launch(graph, config, q, stop_level, max_iters, q_norms):
    """One launch of the `greedy_descent` kernel over the batch. Returns
    (cur [B] i32, cur_d [B] f32, counters int64 [3]: steps, the most any
    query ran; tape rows scored; adjacency rows read)."""
    B, d = q.shape[0], graph.vectors.shape[1]
    dev = q.device
    q = q.float()
    qn = (q * q).sum(-1) if q_norms is None else q_norms.float()
    q, qn = csrc.operand(q), csrc.operand(qn)
    if isinstance(stop_level, int):
        # filled on the device: a host scalar copied up would sync the host
        stop = torch.full((B,), stop_level, dtype=torch.int32, device=dev)
    else:
        stop = torch.as_tensor(stop_level, dtype=torch.int32, device=dev).expand(B)
    stop = csrc.operand(stop)
    table = csrc.operand(graph.vectors)
    upper_row = graph.upper_row.contiguous()
    upper_adj = graph.upper_adj.contiguous()
    entry, max_level = graph.entry.contiguous(), graph.max_level.contiguous()
    M = upper_adj.shape[1]
    if q.shape != (B, d) or qn.shape != (B,) or stop.shape != (B,):
        raise ValueError(f"greedy_descent: q {tuple(q.shape)}, q norms {tuple(qn.shape)}, "
                         f"stop levels {tuple(stop.shape)} and tape {tuple(table.shape)} "
                         f"disagree")
    if upper_row.dtype != torch.int32 or upper_adj.dtype != torch.int32 \
            or upper_row.dim() != 2 or upper_row.shape[0] != table.shape[0] or M < 1 \
            or entry.dtype != torch.int32 or max_level.dtype != torch.int32 \
            or entry.numel() != 1 or max_level.numel() != 1:
        raise ValueError(f"greedy_descent: upper_row {tuple(upper_row.shape)} "
                         f"{upper_row.dtype}, upper_adj {tuple(upper_adj.shape)} "
                         f"{upper_adj.dtype}, entry {entry.dtype}, max_level "
                         f"{max_level.dtype} do not fit a tape of {table.shape[0]} rows")
    cur = torch.empty((B,), dtype=torch.int32, device=dev)
    cur_d = torch.empty((B,), dtype=torch.float32, device=dev)
    counters = torch.zeros(3, dtype=torch.int64, device=dev)
    if B:
        _DESCENT.launch(
            (q, qn, table, upper_row, upper_adj, entry, max_level, stop),
            q.data_ptr(), qn.data_ptr(), table.data_ptr(), upper_row.data_ptr(),
            upper_adj.data_ptr(), entry.data_ptr(), max_level.data_ptr(), stop.data_ptr(),
            cur.data_ptr(), cur_d.data_ptr(), counters.data_ptr(),
            B, M, d, upper_row.shape[1], csrc.dtype_code(table.dtype),
            METRIC_IDS[Metric.parse(config.metric)], max_iters,
        )
    return cur, cur_d, counters


def _merge_sorted(a_ops, b_ops, num_out: int):
    """Merge two per-row-sorted-ascending operand tuples into the first
    `num_out` columns of their sorted union with one bitonic-merge
    network. a_ops/b_ops: tuples of [B, na]/[B, nb] tensors whose first
    element is the f32 sort key. Ties resolve by network position (not
    stable), as in the JAX package."""
    a_d = a_ops[0]
    B, na = a_d.shape
    nb = b_ops[0].shape[1]
    n = na + nb
    pow2 = 1 << (n - 1).bit_length()
    pad = pow2 - n
    ops = []
    for a, b in zip(a_ops, b_ops):
        fill = _INF if a.is_floating_point() else -1
        parts = [a, b.flip(1)]
        if pad:
            # pad inside the REVERSED b half: a ++ reverse(b ++ inf_pad)
            parts = [a, torch.full((B, pad), fill, dtype=a.dtype, device=a.device), b.flip(1)]
        ops.append(torch.cat(parts, 1))
    step = pow2 // 2
    while step >= 1:
        halves = [o.reshape(B, -1, 2, step) for o in ops]
        swap = halves[0][:, :, 0] > halves[0][:, :, 1]
        out = []
        for h in halves:
            lo, hi = h[:, :, 0], h[:, :, 1]
            out.append(torch.stack(
                [torch.where(swap, hi, lo), torch.where(swap, lo, hi)], 2
            ).reshape(B, -1))
        ops = out
        step //= 2
    return tuple(o[:, :num_out] for o in ops)


def _dedupe_across_groups(neigh: torch.Tensor, E: int, m0: int) -> torch.Tensor:
    """neigh [B, E*m0], E selected nodes' neighbor lists: mark ids already
    present in an earlier group as -1."""
    if E == 1:
        return neigh
    B = neigh.shape[0]
    g = neigh.reshape(B, E, m0)
    cols = [g[:, 0]]
    for j in range(1, E):
        prior = g[:, :j].reshape(B, j * m0)
        cur = g[:, j]
        dup = (cur[:, :, None] == prior[:, None, :]).any(2)
        cols.append(torch.where(dup, -1, cur))
    return torch.cat(cols, 1)


def _dedupe_keep_first(ids: torch.Tensor) -> torch.Tensor:
    """Per row: replace duplicate ids (keeping the first occurrence) with
    -1. The stable sort keeps equal ids in position order, so the first
    of each run is the first occurrence."""
    sorted_ids, sorted_pos = torch.sort(ids, dim=1, stable=True)
    dup_sorted = torch.zeros_like(ids, dtype=torch.bool)
    dup_sorted[:, 1:] = sorted_ids[:, 1:] == sorted_ids[:, :-1]
    # route the dup flags back to the original positions
    dup = torch.zeros_like(dup_sorted).scatter_(1, sorted_pos, dup_sorted)
    return torch.where(dup, -1, ids)


def _sort_by(d: torch.Tensor, i: torch.Tensor):
    """Stable ascending sort of d along dim 1, carrying i."""
    d, order = torch.sort(d, dim=1, stable=True)
    return d, i.gather(1, order)


def _seed_pools(q, seeds, seed_d, ef: int, allow):
    """The pools before the first iteration: (cand_d, cand_i, res_d, res_i),
    each [B, ef], sorted ascending, the seeds at their head."""
    B = q.shape[0]
    dev = q.device
    # seeds may be [B] (single seed, the descent path) or [B, S]
    if seeds.dim() == 1:
        seeds = seeds[:, None]
        seed_d = seed_d[:, None]
    seeds = seeds.to(torch.int32)
    S = seeds.shape[1]
    cand_d = torch.full((B, ef), _INF, device=dev)
    cand_d[:, :S] = seed_d
    cand_i = torch.full((B, ef), -1, dtype=torch.int32, device=dev)
    cand_i[:, :S] = seeds
    seed_ok = allow[seeds.clamp(min=0).long()] & (seeds >= 0)
    res_d = torch.full((B, ef), _INF, device=dev)
    res_d[:, :S] = torch.where(seed_ok, seed_d, _INF)
    res_i = torch.full((B, ef), -1, dtype=torch.int32, device=dev)
    res_i[:, :S] = torch.where(seed_ok, seeds, -1)
    if S > 1:
        # pools are kept sorted ascending (the merge relies on it)
        cand_d, cand_i = _sort_by(cand_d, cand_i)
        res_d, res_i = _sort_by(res_d, res_i)
    return cand_d, cand_i, res_d, res_i


def _beam_sizes(ef, expand, fan, d, max_iters, dual_pool, use_history):
    """(shared bytes besides the pools, pool and history bytes) of one
    query, each unrounded: the layout arithmetic of `csrc/beam.cu`."""
    n = expand * fan
    pow2 = 1 << (ef + n - 1).bit_length()
    hist_len = max_iters * expand if use_history else 0
    rest = 4 * d + 10 * n + 4 * (32 + 32 + 4)
    pools = (17 if dual_pool else 9) * pow2 + 4 * hist_len
    return rest, pools


def beam_smem_bytes(ef: int, expand: int, fan: int, d: int, max_iters: int,
                    dual_pool: bool, use_history: bool, wide: bool = False,
                    itemsize: int = 1) -> int:
    """Shared-memory bytes one block of the beam kernel needs over a tape of
    `itemsize`-byte values: the layout arithmetic of `csrc/beam.cu`
    (`beam_layout`, `plan`), which refuses a launch whose count differs
    from its own. The shared layout holds the pools too; the wide layout
    only the query and the per-iteration buffers. Rows of 512 bytes or
    more take the staged route, which adds the live rows' slot map, an
    mbarrier and as many rows as fit `_BEAM_STAGE_BUDGET` beside the rest
    (at least one, at most a step's slots), where that stays within
    `_BEAM_MAX_SMEM`; else they keep direct loads and add nothing."""
    rest, pools = _beam_sizes(ef, expand, fan, d, max_iters, dual_pool, use_history)
    o = rest if wide else rest + pools
    row_bytes = d * itemsize
    if row_bytes % 16 == 0 and row_bytes >= 512:
        n = expand * fan
        rows = round_up(round_up(round_up(o, 4) + 4 * n, 8) + 8, 16)
        staged = rows + min(n, max(1, (_BEAM_STAGE_BUDGET - rows) // row_bytes)) * row_bytes
        if staged <= _BEAM_MAX_SMEM:
            return staged
    return round_up(o, 16)


def beam_pool_bytes(ef: int, expand: int, fan: int, d: int, max_iters: int,
                    dual_pool: bool, use_history: bool) -> int:
    """Workspace bytes one query of the beam kernel's wide layout needs:
    its pools, their flags and its history."""
    return round_up(_beam_sizes(ef, expand, fan, d, max_iters, dual_pool, use_history)[1], 16)


def _beam_search_base_cuda(graph, config, q, seeds, seed_d, ef, allow, E, max_iters, level,
                           q_norms, dual_pool, use_history):
    """Seed the pools and launch the beam kernel once over the batch."""
    q = q.float()
    if q_norms is None:
        q_norms = (q * q).sum(-1)
    pools = _seed_pools(q, seeds, seed_d, ef, allow)
    res_d, res_i, cand_i, counters = _beam_launch(
        graph, config, q, q_norms.float(), pools, ef, allow, E, max_iters, level,
        dual_pool, use_history)
    return res_d, res_i, cand_i, (counters[0], counters[1])


def _beam_launch(graph, config, q, qn, pools, ef, allow, E, max_iters, level, dual_pool,
                 use_history, _wide=False):
    """One launch of the `beam_search` kernel over pools seeded by
    `_seed_pools`, which it updates in place. Returns (res_d, res_i,
    cand_i, counters) with counters an int64 [3] tensor: iterations, rows
    scored, nodes expanded. The pools stay in a block's shared memory
    where they fit, else (or with `_wide`, which tests use to hold the two
    layouts equal) they go to the wide layout's workspace."""
    fan = config.m0 if level == 0 else config.m
    B, d = q.shape[0], graph.vectors.shape[1]
    sizes = (ef, E, fan, d, max_iters, dual_pool, use_history)
    item = graph.vectors.element_size()
    wide = _wide or beam_smem_bytes(*sizes, itemsize=item) > _BEAM_MAX_SMEM
    need = beam_smem_bytes(*sizes, wide=wide, itemsize=item)
    pool = beam_pool_bytes(*sizes) if wide else 0
    if need > _BEAM_MAX_SMEM:
        raise ValueError(
            f"beam_search: d={d}, E={E}, m0={fan} need {need} bytes of shared memory "
            f"per query even with the pools in device memory, over the {_BEAM_MAX_SMEM} "
            f"a block may have")
    q = csrc.operand(q)
    qn = csrc.operand(qn)
    table = csrc.operand(graph.vectors)
    adj = (graph.adj0 if level == 0 else graph.upper_adj).contiguous()
    upper_row = graph.upper_row.contiguous()
    allow = allow.contiguous()
    cand_d, cand_i, res_d, res_i = (t.contiguous() for t in pools)
    if q.shape != (B, d) or qn.shape != (B,) or q.dtype != torch.float32 \
            or qn.dtype != torch.float32 or cand_d.shape != (B, ef):
        raise ValueError(f"beam_search: q {tuple(q.shape)} {q.dtype}, q norms "
                         f"{tuple(qn.shape)} {qn.dtype}, pools {tuple(cand_d.shape)} and tape "
                         f"{tuple(graph.vectors.shape)} disagree")
    if adj.shape[1] != fan or adj.dtype != torch.int32 or upper_row.dtype != torch.int32 \
            or allow.dtype != torch.bool or level > upper_row.shape[1]:
        raise ValueError(f"beam_search: adjacency {tuple(adj.shape)} {adj.dtype}, upper_row "
                         f"{tuple(upper_row.shape)} {upper_row.dtype}, allow {allow.dtype} "
                         f"do not fit level {level}, fan-out {fan}")
    counters = torch.zeros(3, dtype=torch.int64, device=q.device)
    workspace = torch.empty((B * pool,), dtype=torch.uint8, device=q.device)
    if B:
        staged = ctypes.c_int(0)
        _BEAM.launch(
            (q, qn, table, adj, upper_row, allow, cand_d, cand_i, res_d, res_i, workspace),
            q.data_ptr(), qn.data_ptr(), table.data_ptr(), adj.data_ptr(),
            upper_row.data_ptr(), allow.data_ptr(), cand_d.data_ptr(), cand_i.data_ptr(),
            res_d.data_ptr(), res_i.data_ptr(), counters.data_ptr(),
            workspace.data_ptr() if wide else None, ctypes.byref(staged),
            B, ef, E, fan, d, csrc.dtype_code(table.dtype),
            METRIC_IDS[Metric.parse(config.metric)], max_iters, level, upper_row.shape[1],
            int(dual_pool), int(use_history), int(wide), need, pool, workspace.numel(),
        )
        _BEAM.count_routed(staged.value)
    if not dual_pool:
        res_d, res_i = cand_d, cand_i
    return res_d, res_i, cand_i, counters


def beam_search_base(
    graph: HNSWGraph,
    config: HNSWConfig,
    q: torch.Tensor,
    seeds: torch.Tensor,
    seed_d: torch.Tensor,
    ef: int,
    allow: torch.Tensor,
    expand: int = 1,
    max_iters: int = 0,
    level: int = 0,
    q_norms: Optional[torch.Tensor] = None,
    dual_pool: bool = True,
    use_history: bool = True,
):
    """Beam search with pool size `ef` from per-query seeds.

    allow: bool [cap], nodes admissible to the RESULT pool (valid & not
    tombstoned & user predicate); traversal ignores it. With `level` >= 1
    the beam runs over that upper level's adjacency (`upper_adj` through
    `upper_row[:, level - 1]`, fan-out `m`), as construction does to
    collect each level's candidates. dual_pool=False
    merges the two pools (valid only when every reachable node is
    admissible). use_history=False drops the expansion history.

    Returns (res_d [B, ef] ascending, res_i [B, ef], cand_i [B, ef],
    (iterations, distance evaluations)) with the counters as 0-d tensors.

    CUDA tensors: one launch of the `beam_search` kernel, no host sync, at
    any ef and fan-out (pools past a block's shared memory go to a
    workspace in device memory). CPU tensors: the plain loop.
    """
    if max_iters <= 0:
        max_iters = 4 + (2 * ef) // expand
    run = _beam_search_base_plain if q.device.type == "cpu" else _beam_search_base_cuda
    return run(graph, config, q, seeds, seed_d, ef, allow, expand, max_iters, level,
               q_norms, dual_pool, use_history)


def _beam_search_base_plain(graph, config, q, seeds, seed_d, ef, allow, expand, max_iters,
                            level, q_norms, dual_pool, use_history):
    """Plain version of the `beam_search` kernel: the batch in lockstep,
    a done mask per query, K1 and K5 once per iteration."""
    B = q.shape[0]
    dev = q.device
    m0 = config.m0 if level == 0 else config.m
    E = expand
    hist_len = max_iters * E if use_history else 1
    cand_d, cand_i, res_d, res_i = _seed_pools(q, seeds, seed_d, ef, allow)
    expanded = torch.zeros((B, ef), dtype=torch.bool, device=dev)
    hist = torch.full((B, hist_len), -1, dtype=torch.int32, device=dev)

    def done_mask(cand_d, expanded, res_d):
        unexp_min = torch.where(expanded, _INF, cand_d).amin(1)
        worst = res_d[:, ef - 1] if dual_pool else cand_d[:, ef - 1]
        return (unexp_min > worst) | ~torch.isfinite(unexp_min)

    def neighbors_of(ids):  # ids [B, E] -> [B, E*m0]
        if level == 0:
            adj = gather_rows(graph.adj0, ids)
        else:
            row = graph.upper_row[:, level - 1][ids.clamp(min=0).long()]
            adj = torch.where((row >= 0)[:, :, None], gather_rows(graph.upper_adj, row), -1)
        return torch.where((ids >= 0)[:, :, None], adj, -1).reshape(B, E * m0)

    pool_pos = torch.arange(ef, device=dev)[None, :]
    done = done_mask(cand_d, expanded, res_d)
    iters = torch.zeros((), dtype=torch.int32, device=dev)
    evals = torch.zeros((), dtype=torch.int64, device=dev)
    for it in range(max_iters):
        if it % _SYNC_EVERY == 0 and bool(done.all()):
            break
        iters += (~done.all()).to(torch.int32)
        # pick the E best unexpanded candidates: E passes of (argmin, mask)
        key = torch.where(expanded | done[:, None], _INF, cand_d)
        sel = []
        for _ in range(E):
            p = torch.argmin(key, dim=1, keepdim=True)
            hit = torch.isfinite(key.gather(1, p))
            sel.append(torch.where(hit, cand_i.gather(1, p), -1))
            one_hot = pool_pos == p
            expanded = expanded | (one_hot & hit)
            key = torch.where(one_hot, _INF, key)
        sel_ids = torch.cat(sel, 1)  # [B, E]
        if use_history:
            hist[:, it * E:(it + 1) * E] = sel_ids

        neigh = neighbors_of(sel_ids)  # [B, E*m0]
        known = [cand_i]
        if use_history:
            known.append(hist)
        if dual_pool:
            known.append(res_i)
        known = torch.cat(known, 1)
        dup = (neigh[:, :, None] == known[:, None, :]).any(2)
        neigh = torch.where(dup | (neigh < 0), -1, neigh)
        neigh = _dedupe_across_groups(neigh, E, m0)
        # fused gather + score; sentinel ids cost no load and give +inf
        nd = gather_distances(graph.vectors, neigh, q, config.metric, q_norms)
        evals += (neigh >= 0).sum()

        # fold the new candidates into the sorted pool: one narrow sort of
        # the batch + a bitonic merge
        nd_s, ni_s = _sort_by(nd, neigh)
        new_cand_d, new_cand_i, new_cand_e = _merge_sorted(
            (cand_d, cand_i, expanded.to(torch.int32)),
            (nd_s, ni_s, torch.zeros_like(ni_s)),
            ef,
        )
        new_expanded = new_cand_e.to(torch.bool)
        if dual_pool:
            ok = (neigh >= 0) & allow[neigh.clamp(min=0).long()]
            rd_s, ri_s = _sort_by(torch.where(ok, nd, _INF), neigh)
            new_res_d, new_res_i = _merge_sorted((res_d, res_i), (rd_s, ri_s), ef)
            new_res_i = torch.where(torch.isfinite(new_res_d), new_res_i, -1)
        else:
            new_res_d, new_res_i = res_d, res_i

        # frozen queries keep their state
        keep = done[:, None]
        cand_d = torch.where(keep, cand_d, new_cand_d)
        cand_i = torch.where(keep, cand_i, new_cand_i)
        expanded = torch.where(keep, expanded, new_expanded)
        res_d = torch.where(keep, res_d, new_res_d)
        res_i = torch.where(keep, res_i, new_res_i)
        done = done | done_mask(cand_d, expanded, res_d)
    if not dual_pool:
        res_d, res_i = cand_d, cand_i
    return res_d, res_i, cand_i, (iters, evals)


def pivot_seeds(
    graph: HNSWGraph,
    config: HNSWConfig,
    q: torch.Tensor,
    pivot_slots: torch.Tensor,  # [P] i32
    pivot_vecs: torch.Tensor,  # [P, d]
    n_seeds: int,
    q_norms: Optional[torch.Tensor] = None,
):
    """Seed the beam by an exact scan over a pivot sample (the level >= 1
    nodes): one [B, P] product ranks every coarse region at once, and the
    `n_seeds` nearest pivots per query seed the base beam. The TPU's
    approximate top-k is exact top-k here."""
    pv = pivot_vecs.float()
    with span("vss.search.product"):
        dots = q @ pv.T
    qn = (q * q).sum(-1, keepdim=True) if q_norms is None else q_norms[:, None]
    pn = (pv * pv).sum(-1)[None, :]
    d_qp = _epilogue(dots, qn, pn, Metric.parse(config.metric))
    d_qp = torch.where((pivot_slots >= 0)[None, :], d_qp, _INF)
    # exact smallest-n_seeds, ties to the lower pivot (as lax.top_k)
    sd, sp = topk.select_k(d_qp, min(n_seeds, pivot_slots.shape[0]))
    seeds = torch.where(torch.isfinite(sd), pivot_slots[sp.long()], -1)
    return seeds, sd


def scored_pivot_seeds(
    graph: HNSWGraph,
    config: HNSWConfig,
    q: torch.Tensor,
    pivot_slots: torch.Tensor,  # [P] i32
    pivot_vecs: torch.Tensor,  # [P, d]
    n_seeds: int,
    q_norms: Optional[torch.Tensor] = None,
    pivot_norms: Optional[torch.Tensor] = None,  # [P]
):
    """The pivot seeding with each seed scored the way the beam scores
    every node: (seeds [B, k] i32, seed_d [B, k] f32), k = min(n_seeds, P),
    a seed -1 and its distance +inf where its pivot's distance is not
    finite. `pivot_vecs` are the tape's rows at the slots, in the tape's
    dtype (as the pivot caches keep them) or in f32. `pivot_norms`, the
    squared norms of the pivots' f32 rows (`(pv * pv).sum(-1)`, as
    `pivot_seeds` computes them), spares their reduction on every batch.

    CUDA tensors with k <= SELECT_K_MAX: the product, then one launch of
    the `pivot_seeds` kernel, no host sync; bit for bit `pivot_seeds`
    followed by K1 (`gather_distances`), which is the route above
    SELECT_K_MAX, wherever both take the same product. The product is
    `pivot_product` over an int8 or bf16 tape at the widths it takes
    (`pivot_product_takes`), f32-accurate, differing from the f32 GEMM
    only in the order of its sums; else `torch.matmul` in f32. CPU
    tensors: `_scored_pivot_seeds_plain`."""
    if q.device.type == "cpu":
        return _scored_pivot_seeds_plain(graph, config, q, pivot_slots, pivot_vecs, n_seeds,
                                         q_norms)
    k = min(n_seeds, pivot_slots.shape[0])
    if k > SELECT_K_MAX:
        seeds, _ = pivot_seeds(graph, config, q, pivot_slots, pivot_vecs, n_seeds, q_norms)
        return seeds, gather_distances(graph.vectors, seeds, q, config.metric, q_norms)
    q = q.float()
    qn = (q * q).sum(-1) if q_norms is None else q_norms
    pn = pivot_norms
    if pn is None:
        pv = pivot_vecs.float()
        pn = (pv * pv).sum(-1)
    with span("vss.search.product"):
        if pivot_product_takes(graph.vectors.dtype):
            dots = pivot_product(q, pivot_vecs.to(graph.vectors.dtype), pivot_slots)
        else:
            dots = q @ pivot_vecs.float().T
    return _pivot_seeds_launch(dots, qn, pn, pivot_slots, graph.vectors, q, config.metric, k)


def pivot_product_takes(dtype) -> bool:
    """Whether `pivot_product` takes a tape of `dtype` rows: int8 or bf16
    (exact in bf16; an f32 tape's rows are not), at every width (column
    groups past 1,088 values at int8, 1,024 at bf16)."""
    return dtype in (torch.int8, torch.bfloat16)


def _cut_bf16(v: torch.Tensor) -> torch.Tensor:
    """f32 values with the low 16 bits of their patterns cleared: bf16
    values, each the top 8 significant bits of its input."""
    return (v.view(torch.int32) & -65536).view(torch.float32)


def _query_shift(q: torch.Tensor) -> torch.Tensor:
    """Each row's s (`split_planes`), int32 [B]."""
    u = q.view(torch.int32)
    e = (u >> 23) & 0xFF
    m = u & 0x7FFFFF
    normal = e != 0
    sig = torch.where(normal, m | 0x800000, m)  # the significand, worth 2^base each
    base = torch.where(normal, e - 150, torch.full_like(e, -149))
    high = torch.frexp(sig.double()).exponent - 1
    low = torch.frexp((sig & -sig).double()).exponent - 1
    nz = (u & 0x7FFFFFFF) != 0
    top = torch.where(nz, base + high, -1000).amax(-1)
    lsb = torch.where(nz, base + low, 1000).amin(-1)
    s = torch.minimum(-126 - lsb, -top).clamp(min=0)
    bad = (e == 0xFF).any(-1) | (lsb > 500)
    return torch.where(bad, 0, s).to(torch.int32)


def split_planes(q: torch.Tensor):
    """The exact split `pivot_product` makes of f32 queries q [B, d]: (hi,
    mid, lo, s), three [B, d] f32 tensors of bf16 values and s [B] int32,
    with hi + mid + lo, summed in that order in f32, equal to q 2^s bit for
    bit wherever every set bit of q 2^s is worth 2^-133 or more. hi is
    q 2^s cut to bf16 (its low 16 bits cleared), mid what is left cut, lo
    what is left then. s, in [0, 23], is the least that lifts the row's
    lowest set bit to 2^-126 (no plane subnormal), capped so that the
    row's largest value stays below 2, and 0 for a row with an inf or a
    NaN, which goes whole into hi (a NaN stays one); a zero keeps its sign
    in every plane. So every row whose values are all 2^-103 or more (or
    0), and every row of subnormals, is split exactly."""
    q = q.float().contiguous()
    s = _query_shift(q)
    x = q * torch.exp2(s.float())[:, None]
    hi = _cut_bf16(x)
    r1 = x - hi
    mid = _cut_bf16(r1)
    lo = _cut_bf16(r1 - mid)
    u = q.view(torch.int32)
    special = (u & 0x7F800000) == 0x7F800000
    zero = (u & 0x7FFFFFFF) == 0
    nan = special & ((u & 0x7FFFFF) != 0)
    whole = ((u & -65536) | (nan.to(torch.int32) << 22)).view(torch.float32)
    hi = torch.where(special, whole, torch.where(zero, q, hi))
    mid = torch.where(special, 0.0, torch.where(zero, q, mid))
    lo = torch.where(special, 0.0, torch.where(zero, q, lo))
    return hi, mid, lo, s


def pivot_product(q: torch.Tensor, rows: torch.Tensor, pivot_slots: torch.Tensor) -> torch.Tensor:
    """dots [B, P] f32: each f32 query q [B, d] against each pivot's row,
    0 where its slot is -1 (for finite queries). `rows` [P, d] are the
    pivots' rows as the tape stores them, int8 or bf16 (`graph_pivots`
    gathers them); other dtypes raise. CUDA tensors: one launch of the
    `pivot_product` kernel (`csrc/pivots.cu`) a column group (one group up
    to 1,088 values at int8, 1,024 at bf16); CPU tensors:
    `_pivot_product_plain`."""
    B, d = q.shape if q.dim() == 2 else (-1, -1)
    P = pivot_slots.shape[0] if pivot_slots.dim() == 1 else -1
    if q.dtype != torch.float32 or B < 0 or P < 0 or rows.shape != (P, d) \
            or d == 0 or not pivot_product_takes(rows.dtype) or P >= 2 ** 31:
        raise ValueError(f"pivot_product: queries {tuple(q.shape)} {q.dtype}, rows "
                         f"{tuple(rows.shape)} {rows.dtype}, slots "
                         f"{tuple(pivot_slots.shape)}: takes f32 [B, d] queries, "
                         f"[P, d] int8 or bf16 rows of d > 0 values and [P] slots")
    if q.device.type == "cpu":
        return _pivot_product_plain(q, rows, pivot_slots)
    out = torch.empty((B, P), dtype=torch.float32, device=q.device)
    if B == 0 or P == 0:
        return out
    q = csrc.operand(q)
    rows = csrc.operand(rows)
    slots = csrc.operand(pivot_slots.to(torch.int32))
    launched = ctypes.c_int(0)
    _PIVOTS.launch([q, rows, slots, out], q.data_ptr(), rows.data_ptr(), slots.data_ptr(),
                   out.data_ptr(), B, P, d, csrc.dtype_code(rows.dtype), ctypes.byref(launched),
                   launched=launched)
    return out


def _pivot_product_plain(q, rows, pivot_slots) -> torch.Tensor:
    """Plain version of the `pivot_product` kernel: the split
    (`split_planes`), then the three planes' products with the rows in f32,
    summed hi, mid, lo, times 2^-s."""
    hi, mid, lo, s = split_planes(q)
    x = torch.where((pivot_slots >= 0)[:, None], rows.float(), 0.0)
    return (hi @ x.T + mid @ x.T + lo @ x.T) * torch.exp2(-s.float())[:, None]


def _scored_pivot_seeds_plain(graph, config, q, pivot_slots, pivot_vecs, n_seeds, q_norms):
    """Plain version of the `pivot_seeds` kernel: `pivot_seeds`, then each
    seed scored by K1's plain version."""
    seeds, _ = pivot_seeds(graph, config, q, pivot_slots, pivot_vecs, n_seeds, q_norms)
    q = q.float()
    qn = (q * q).sum(-1) if q_norms is None else q_norms.float()
    return seeds, _gather_distances_plain(graph.vectors, seeds, q,
                                          Metric.parse(config.metric), qn)


def _pivot_seeds_launch(dots, qn, pn, pivot_slots, table, q, metric, k: int,
                        splits: Optional[int] = None):
    """One launch of the `pivot_seeds` kernel over the product `dots`
    [B, P] with `splits` blocks a row (default `_select_k_splits`'s
    choice; tests force either layout). Returns (seeds [B, k] i32,
    seed_d [B, k] f32)."""
    metric = Metric.parse(metric)
    B, P = dots.shape
    d = table.shape[1]
    if dots.dtype != torch.float32 or q.shape != (B, d) or qn.shape != (B,) \
            or pn.shape != (P,) or pivot_slots.shape != (P,) \
            or not 0 <= k <= min(P, SELECT_K_MAX) or P >= 2 ** 31:
        raise ValueError(f"pivot_seeds: dots {tuple(dots.shape)} {dots.dtype}, q "
                         f"{tuple(q.shape)}, q norms {tuple(qn.shape)}, pivot norms "
                         f"{tuple(pn.shape)}, slots {tuple(pivot_slots.shape)}, tape "
                         f"{tuple(table.shape)} and k={k} (k <= min(P, {SELECT_K_MAX})) "
                         f"disagree")
    dev = dots.device
    seeds = torch.empty((B, k), dtype=torch.int32, device=dev)
    seed_d = torch.empty((B, k), dtype=torch.float32, device=dev)
    if B == 0 or k == 0:
        return seeds, seed_d
    splits = _select_k_splits(B, P) if splits is None else splits
    dots, qn, pn, q = (csrc.operand(t.float()) for t in (dots, qn, pn, q))
    slots = csrc.operand(pivot_slots.to(torch.int32))
    table = csrc.operand(table)
    operands = [dots, qn, pn, slots, table, q, seeds, seed_d]
    wptr = None
    if splits > 1:
        ws = torch.empty((B * splits * k * 8 + B * 4,), dtype=torch.uint8, device=dev)
        operands.append(ws)
        wptr = ws.data_ptr()
    _SEEDS.launch(operands, dots.data_ptr(), qn.data_ptr(), pn.data_ptr(), slots.data_ptr(),
                  table.data_ptr(), q.data_ptr(), seeds.data_ptr(), seed_d.data_ptr(), wptr,
                  B, P, d, csrc.dtype_code(table.dtype), METRIC_IDS[metric], k, splits)
    return seeds, seed_d


def rerank_pool(q: torch.Tensor, ids: torch.Tensor, rerank_tape: torch.Tensor, metric,
                k: int, entry: torch.Tensor, q_norms: Optional[torch.Tensor] = None):
    """The graph search's exact rerank: each query's pool `ids` [B, ef]
    (i32, -1 for an empty slot) rescored against the f32 query q [B, d]
    from the full-precision side tape `rerank_tape` [cap, d] (l2sq by the
    direct difference; cosine and ip through the epilogue with the squared
    query norms `q_norms` [B], computed where None), sorted stably by
    (distance, pool position) and cut to its first k <= ef. Returns (dists
    [B, k] f32, ids [B, k] i32): an id -1 or a NaN distance scores +inf,
    an id is -1 where its distance is not finite, and every slot is +inf /
    -1 where the 0-d `entry` is below 0 (an empty graph). CUDA tensors:
    one launch of the `rerank_pool` kernel (`csrc/rerank.cu`; an f32 or
    bf16 tape, else ValueError); CPU tensors: `_rerank_pool_plain`."""
    metric = Metric.parse(metric)
    if q.device.type == "cpu":
        return _rerank_pool_plain(q, ids, rerank_tape, metric, k, entry, q_norms)
    return _rerank_launch(q, ids, rerank_tape, metric, k, entry, q_norms)


def _rerank_pool_plain(q, ids, rerank_tape, metric, k: int, entry, q_norms=None):
    """Plain version of the `rerank_pool` kernel: the pool's rows gathered
    through K5 as f32, the direct difference (l2sq) or
    `gathered_distances`, the masks, a stable sort and the k cut."""
    rv = gather_rows(rerank_tape, ids).float()
    if metric == Metric.L2SQ:
        # direct difference form: the dot-product identity loses digits
        # to cancellation at byte magnitudes
        diff = q[:, None, :] - rv
        rd = (diff * diff).sum(-1)
    else:
        rd = gathered_distances(q, rv, metric, None, q_norms)
    rd = torch.where((ids >= 0) & ~rd.isnan(), rd, _INF)
    res_d, res_i = _sort_by(rd, ids)
    out_d = res_d[:, :k]
    out_i = torch.where(torch.isfinite(out_d), res_i[:, :k], -1)
    empty = entry < 0
    return torch.where(empty, _INF, out_d), torch.where(empty, -1, out_i)


def _rerank_launch(q, ids, rerank_tape, metric, k: int, entry, q_norms=None):
    """One launch of the `rerank_pool` kernel (`rerank_pool`'s CUDA
    route), after the shapes are checked."""
    B, ef = ids.shape if ids.dim() == 2 else (-1, -1)
    cap, d = rerank_tape.shape if rerank_tape.dim() == 2 else (-1, -1)
    if q.dtype != torch.float32 or B < 0 or d < 1 or q.shape != (B, d) or not 1 <= k <= ef \
            or rerank_tape.dtype not in (torch.float32, torch.bfloat16) or entry.numel() != 1 \
            or (q_norms is not None and q_norms.shape != (B,)):
        raise ValueError(f"rerank_pool: queries {tuple(q.shape)} {q.dtype}, pool "
                         f"{tuple(ids.shape)}, tape {tuple(rerank_tape.shape)} "
                         f"{rerank_tape.dtype}, k={k}: takes f32 [B, d] queries, [B, ef] "
                         f"pools with 1 <= k <= ef and an f32 or bf16 [cap, d] tape, d >= 1")
    dev = q.device
    out_d = torch.empty((B, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, k), dtype=torch.int32, device=dev)
    if B == 0:
        return out_d, out_i
    if metric == Metric.COSINE and q_norms is None:
        q_norms = (q * q).sum(-1)
    q = csrc.operand(q)
    ids = csrc.operand(ids.to(torch.int32))
    rows = csrc.operand(rerank_tape)
    entry = entry.to(torch.int32).reshape(1)
    qn = None if q_norms is None else q_norms.float().contiguous()
    operands = [q, ids, rows, entry, out_d, out_i] + ([] if qn is None else [qn])
    _RERANK.launch(operands, q.data_ptr(), None if qn is None else qn.data_ptr(),
                   ids.data_ptr(), rows.data_ptr(), entry.data_ptr(), out_d.data_ptr(),
                   out_i.data_ptr(), B, ef, cap, d, csrc.dtype_code(rows.dtype),
                   METRIC_IDS[metric], k)
    return out_d, out_i


def hnsw_search(
    graph: HNSWGraph,
    config: HNSWConfig,
    q,
    k: int,
    ef: Optional[int] = None,
    filter_mask: Optional[torch.Tensor] = None,
    expand: int = 1,
    max_iters: int = 0,
    with_stats: bool = False,
    assume_all_valid: bool = False,
    use_history: bool = True,
    pivot_slots: Optional[torch.Tensor] = None,
    pivot_vecs: Optional[torch.Tensor] = None,
    n_seeds: int = 4,
    rerank_tape: Optional[torch.Tensor] = None,
    pivot_norms: Optional[torch.Tensor] = None,
):
    """k-NN search over the graph for a batch of queries.

    q: [B, d]. Returns (dists [B, k] ascending f32, slots [B, k] i32, -1
    past the end). `ef` defaults to max(config.ef_search, k).
    `filter_mask` is an optional bool [cap] row predicate; tombstoned
    slots are always excluded from results but still routable.
    `pivot_slots`/`pivot_vecs` switch seeding from greedy descent to the
    pivot scan with `n_seeds` seeds per query (`scored_pivot_seeds`;
    `pivot_norms`, the pivots' squared norms, spares their reduction a
    batch). `rerank_tape` rescores the ef-wide result pool exactly from a
    full-precision side tape (`rerank_pool`).
    with_stats=True also returns {"iterations", "distance_evals"}.
    """
    dev = graph.device
    q = torch.as_tensor(q, dtype=torch.float32, device=dev)
    if ef is None:
        ef = config.ef_search
    ef = max(ef, k)
    n_seeds = min(n_seeds, ef)
    allow = graph.valid
    if filter_mask is not None:
        allow = allow & filter_mask.to(dev)
    # single-pool fast path: every reachable node admissible
    dual_pool = not (assume_all_valid and filter_mask is None)
    metric = Metric.parse(config.metric)
    with span("vss.search.seed"):
        q_norms = (q * q).sum(-1) if metric in (Metric.L2SQ, Metric.COSINE) else None
        if pivot_slots is not None:
            seeds, seed_d = scored_pivot_seeds(graph, config, q, pivot_slots, pivot_vecs,
                                               n_seeds, q_norms, pivot_norms)
        else:
            seeds, seed_d = greedy_descent(graph, config, q, q_norms=q_norms)
    with span("vss.search.beam"):
        res_d, res_i, _, (iters, evals) = beam_search_base(
            graph, config, q, seeds, seed_d, ef, allow, expand, max_iters,
            q_norms=q_norms, dual_pool=dual_pool, use_history=use_history,
        )
    with span("vss.search.rerank"):
        if rerank_tape is not None:
            # exact rescoring of the ef-wide pool against the side tape
            out_d, out_i = rerank_pool(q, res_i, rerank_tape, metric, k, graph.entry, q_norms)
        else:
            empty = graph.entry < 0
            out_d = torch.where(empty, _INF, res_d[:, :k])
            out_i = torch.where(empty, -1, res_i[:, :k])
    if with_stats:
        return out_d, out_i, {"iterations": int(iters), "distance_evals": int(evals)}
    return out_d, out_i
