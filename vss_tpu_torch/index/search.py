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

Every distance the search computes goes through kernel K1
(`ops/gather.gather_distances`), and every whole-row gather (adjacency
rows, the rerank tape's rows) through kernel K5
(`ops/gather.gather_rows`): on CUDA the hand-written kernels, on the CPU
their plain versions. The JAX package's
`lax.while_loop` is a Python loop here; it checks the done latch on the
host every `_SYNC_EVERY` iterations. Iterations after every query is
done change nothing, so the result equals a check every iteration.
"""
from __future__ import annotations

from typing import Optional

import torch

from vss_tpu_torch.index.graph import HNSWConfig, HNSWGraph
from vss_tpu_torch.ops.distance import Metric, _epilogue, gathered_distances
from vss_tpu_torch.ops.gather import gather_distances, gather_rows
from vss_tpu_torch.ops.topk import _select_min_k

__all__ = ["hnsw_search", "greedy_descent", "pivot_seeds", "beam_search_base"]

_INF = float("inf")

# host syncs of the beam's done latch: one per this many iterations
_SYNC_EVERY = 4


def _descent_step(graph: HNSWGraph, config: HNSWConfig, q, state, q_norms):
    """One step of batched greedy descent over the upper levels."""
    lvl, cur, cur_d = state
    # upper_row column for level `lvl` is lvl-1; only meaningful when lvl >= 1
    col = (lvl - 1).clamp(min=0)
    row = graph.upper_row[cur.long()].gather(1, col[:, None].long())[:, 0]
    active = (lvl > 0) & (row >= 0)
    neigh = gather_rows(graph.upper_adj, row)  # [B, M]
    neigh = torch.where(active[:, None], neigh, -1)
    nd = gather_distances(graph.vectors, neigh, q, config.metric, q_norms)
    j = torch.argmin(nd, dim=1, keepdim=True)
    best_d = nd.gather(1, j)[:, 0]
    best_i = neigh.gather(1, j)[:, 0]
    improved = active & (best_d < cur_d)
    cur = torch.where(improved, best_i, cur)
    cur_d = torch.where(improved, best_d, cur_d)
    # no improvement (or no row at this level) -> drop a level
    lvl = torch.where(improved, lvl, (lvl - 1).clamp(min=0))
    return lvl, cur, cur_d


def greedy_descent(
    graph: HNSWGraph,
    config: HNSWConfig,
    q: torch.Tensor,
    stop_level=0,
    max_iters: int = 0,
    q_norms: Optional[torch.Tensor] = None,
):
    """Descend from the entry point to `stop_level` (per-query or scalar).

    Returns (cur [B] i32, cur_d [B] f32): the beam-search seed."""
    B = q.shape[0]
    dev = q.device
    cur = graph.entry.clamp(min=0).expand(B).clone()
    cur_d = gather_distances(graph.vectors, cur[:, None], q, config.metric, q_norms)[:, 0]
    start = graph.max_level.clamp(min=0)
    stop = torch.as_tensor(stop_level, dtype=torch.int32, device=dev).expand(B)
    lvl = torch.maximum(start.expand(B), stop)
    if max_iters <= 0:
        # levels drop only on non-improving steps; improving steps are
        # bounded by path length
        max_iters = 8 * config.max_levels + 32
    for _ in range(max_iters):
        if not bool((lvl > stop).any()):
            break
        nlvl, ncur, ncur_d = _descent_step(graph, config, q, (lvl, cur, cur_d), q_norms)
        # freeze queries that already reached their stop level
        frozen = lvl <= stop
        lvl = torch.where(frozen, lvl, nlvl)
        cur = torch.where(frozen, cur, ncur)
        cur_d = torch.where(frozen, cur_d, ncur_d)
    return cur, cur_d


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
    """
    B = q.shape[0]
    dev = q.device
    m0 = config.m0 if level == 0 else config.m
    E = expand
    if max_iters <= 0:
        max_iters = 4 + (2 * ef) // E
    hist_len = max_iters * E if use_history else 1

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
    expanded = torch.zeros((B, ef), dtype=torch.bool, device=dev)
    seed_ok = allow[seeds.clamp(min=0).long()] & (seeds >= 0)
    res_d = torch.full((B, ef), _INF, device=dev)
    res_d[:, :S] = torch.where(seed_ok, seed_d, _INF)
    res_i = torch.full((B, ef), -1, dtype=torch.int32, device=dev)
    res_i[:, :S] = torch.where(seed_ok, seeds, -1)
    if S > 1:
        # pools are kept sorted ascending (the merge relies on it)
        cand_d, cand_i = _sort_by(cand_d, cand_i)
        res_d, res_i = _sort_by(res_d, res_i)
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
    dots = q @ pv.T
    qn = (q * q).sum(-1, keepdim=True) if q_norms is None else q_norms[:, None]
    pn = (pv * pv).sum(-1)[None, :]
    d_qp = _epilogue(dots, qn, pn, Metric.parse(config.metric))
    d_qp = torch.where((pivot_slots >= 0)[None, :], d_qp, _INF)
    # exact smallest-n_seeds, ties to the lower pivot (as lax.top_k)
    sd, sp = _select_min_k(d_qp, min(n_seeds, pivot_slots.shape[0]))
    seeds = torch.where(torch.isfinite(sd), pivot_slots[sp.long()], -1)
    return seeds, sd


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
):
    """k-NN search over the graph for a batch of queries.

    q: [B, d]. Returns (dists [B, k] ascending f32, slots [B, k] i32, -1
    past the end). `ef` defaults to max(config.ef_search, k).
    `filter_mask` is an optional bool [cap] row predicate; tombstoned
    slots are always excluded from results but still routable.
    `pivot_slots`/`pivot_vecs` switch seeding from greedy descent to the
    pivot scan with `n_seeds` seeds per query. `rerank_tape` rescores the
    ef-wide result pool exactly from a full-precision side tape.
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
    q_norms = (q * q).sum(-1) if metric in (Metric.L2SQ, Metric.COSINE) else None
    if pivot_slots is not None:
        seeds, _ = pivot_seeds(graph, config, q, pivot_slots, pivot_vecs, n_seeds, q_norms)
        # re-score the seeds the way the beam scores every node
        seed_d = gather_distances(graph.vectors, seeds, q, metric, q_norms)
    else:
        seeds, seed_d = greedy_descent(graph, config, q, q_norms=q_norms)
    res_d, res_i, _, (iters, evals) = beam_search_base(
        graph, config, q, seeds, seed_d, ef, allow, expand, max_iters,
        q_norms=q_norms, dual_pool=dual_pool, use_history=use_history,
    )
    if rerank_tape is not None:
        # exact rescoring of the ef-wide pool against the side tape
        rv = gather_rows(rerank_tape, res_i).float()
        if metric == Metric.L2SQ:
            # direct difference form: the dot-product identity loses
            # digits to cancellation at byte magnitudes
            diff = q[:, None, :] - rv
            rd = (diff * diff).sum(-1)
        else:
            rd = gathered_distances(q, rv, metric, None, q_norms)
        rd = torch.where(res_i >= 0, rd, _INF)
        res_d, res_i = _sort_by(rd, res_i)
    empty = graph.entry < 0
    out_d = torch.where(empty, _INF, res_d[:, :k])
    out_i = torch.where(empty, -1, res_i[:, :k])
    if with_stats:
        return out_d, out_i, {"iterations": int(iters), "distance_evals": int(evals)}
    return out_d, out_i
