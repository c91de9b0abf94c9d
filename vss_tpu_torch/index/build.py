"""Batched wave-based HNSW construction.

Reproduces `vss_tpu/index/build.py:57-418`. A wave of W nodes is inserted
at once by batched tensor updates:

  1. write the wave's vectors/levels/metadata into the slot tape,
  2. batched greedy descent seeds every wave node at its target level,
  3. per level (top -> base): a batched beam search over the pre-wave
     graph collects ef_construction candidates; intra-wave candidates
     (one W x W distance tile) stand in for the not-yet-linked
     wave-mates; the batched select-neighbors heuristic picks M links,
  4. back-links are applied as one sort/segment pass: edges grouped by
     target, appended when there is room, re-selected with the heuristic
     on overflow,
  5. entry point / max level / live count update.

Within a wave all nodes see the same pre-wave graph, so the result is
deterministic given (seed, wave size).

What differs from the JAX package, which traces one wave into one XLA
program: the code runs eagerly, so the wave's levels are read on the host
(they come from the host anyway) and a level with no active node is
skipped without asking the device; a build is a Python loop over waves
(no `_build_segment`, no `waves_per_dispatch`); and no norm tape is made
per wave (kernel K1 computes row norms in its pass). `_insert_wave_core`
updates the graph's tensors IN PLACE; `insert_wave` clones the graph
first and is pure, like the JAX function. Every distance of the beams
goes through kernel K1, every whole-row gather through kernel K5.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from vss_tpu_torch.index.graph import (
    HNSWConfig,
    HNSWGraph,
    cast_to_tape,
    empty_graph,
    sample_levels,
)
from vss_tpu_torch.index.search import (
    _dedupe_keep_first,
    beam_search_base,
    greedy_descent,
    scored_pivot_seeds,
)
from vss_tpu_torch.index.select import select_neighbors
from vss_tpu_torch.ops.distance import gathered_distances, pairwise
from vss_tpu_torch.ops.gather import gather_rows
from vss_tpu_torch.ops.topk import _sort_min_k
from vss_tpu_torch.utils import cdiv, resolve_device, round_up

__all__ = ["build_graph_batched", "insert_wave", "plan_wave_rows"]

_INF = float("inf")
_IMAX = 2**31 - 1
_INCOMING_CAP = 16  # back-link fan-in accepted per target per wave


def _apply_backlinks_level(
    graph: HNSWGraph,
    config: HNSWConfig,
    slots: torch.Tensor,
    chosen: torch.Tensor,
    lev: int,
    active: torch.Tensor,
) -> None:
    """Merge wave->target edges back into the targets' adjacency at `lev`
    (0: `adj0`; >= 1: `upper_adj`), in place."""
    W, m = chosen.shape
    E = W * m
    dev = chosen.device
    base = lev == 0
    cap = config.m0 if base else config.m
    dummy_slot = graph.capacity - 1
    dummy_row = graph.upper_capacity - 1

    src = slots.repeat_interleave(m)
    tgt = chosen.reshape(-1)
    ok_e = (tgt >= 0) & active.repeat_interleave(m)
    tgt_s = torch.where(ok_e, tgt, _IMAX)
    iota = torch.arange(E, dtype=torch.int32, device=dev)
    # stable: the rank of an edge within its target follows wave order
    sorted_t, perm = torch.sort(tgt_s, stable=True)
    src_sorted = src[perm]
    seg_start = torch.ones(E, dtype=torch.bool, device=dev)
    seg_start[1:] = sorted_t[1:] != sorted_t[:-1]
    first_idx = torch.cummax(torch.where(seg_start, iota, 0), 0).values
    rank = iota - first_idx
    ok = (sorted_t != _IMAX) & (rank < _INCOMING_CAP)
    incoming = torch.full((E + 1, _INCOMING_CAP), -1, dtype=torch.int32, device=dev)
    # edges past the cap all land on the dropped row E
    incoming[torch.where(ok, first_idx, E).long(), torch.where(ok, rank, 0).long()] = (
        torch.where(ok, src_sorted, -1))
    incoming = incoming[:E]

    leader = seg_start & (sorted_t != _IMAX)
    t_slot = torch.where(leader, sorted_t, -1)
    t_clamp = t_slot.clamp(min=0)
    if base:
        exist = gather_rows(graph.adj0, t_clamp)
    else:
        trow = graph.upper_row[:, lev - 1][t_clamp.long()]
        leader = leader & (trow >= 0)
        exist = gather_rows(graph.upper_adj, trow)
    tv = gather_rows(graph.vectors, t_clamp)

    cand_i = _dedupe_keep_first(torch.cat([exist, incoming], 1))  # [E, cap + P]
    cand_d = gathered_distances(tv, gather_rows(graph.vectors, cand_i), config.metric)
    cand_d = torch.where(cand_i >= 0, cand_d, _INF)

    overflow = (cand_i >= 0).sum(1) > cap
    # heuristic re-selection (only meaningful on overflow rows)
    chosen_h = select_neighbors(
        tv, cand_i, cand_d, graph.vectors, cap, config.metric, active=leader & overflow
    )
    # plain append path == all candidates sorted ascending, truncated to
    # cap (ties to the lower position, as lax.top_k)
    top, pos = _sort_min_k(cand_d, cap)
    chosen_s = cand_i.gather(1, pos.long())
    chosen_s = torch.where(torch.isfinite(top), chosen_s, -1)
    rows = torch.where(overflow[:, None], chosen_h, chosen_s)

    # non-leader rows all write the sink row, which nothing reads
    if base:
        graph.adj0[torch.where(leader, t_slot, dummy_slot).long()] = rows
    else:
        graph.upper_adj[torch.where(leader, trow.clamp(min=0), dummy_row).long()] = rows


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _insert_wave_core(
    g: HNSWGraph, config: HNSWConfig, wave_vecs, slots, wave_levels,
    wave_upper_rows, wave_rowids, wave_valid, efc: int, expand: int = 4,
    intra_k: int = 16, pivots=None,
) -> HNSWGraph:
    """Insert one wave into `g`, whose tensors are updated in place.
    Returns the graph object to use afterwards (the same tensors, new
    entry / max_level / count). The wave's slots, levels, upper rows,
    rowids and valid flags are read on the host: pass numpy arrays to
    spare the device round trip.

    `pivots` (pivot_slots, pivot_vecs[, pivot_norms]) of the graph (as
    `dense.pivot_rows` gives them, or without the norms), when given,
    seed the nodes that stop at level 0 or 1 from their nearest pivot (a
    level >= 1 node) where it is nearer than the greedy descent's end:
    the descent runs from one entry through upper levels that, on the
    bulk builder's graphs, join no clusters. The JAX package has no such
    seeding; the default (None) is its algorithm."""
    dev = g.device
    slots_h = _host(slots).astype(np.int64)
    levels_h = _host(wave_levels).astype(np.int32)
    urows_h = _host(wave_upper_rows).astype(np.int32)
    valid_h = _host(wave_valid).astype(bool)
    rowids_h = _host(wave_rowids).astype(np.int32)
    W = slots_h.shape[0]

    def dev_t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    wave_vecs = torch.as_tensor(wave_vecs).to(dev, torch.float32)
    slots = dev_t(slots_h.astype(np.int32))
    slots_l = slots.long()
    wave_levels = dev_t(levels_h)
    wave_upper_rows = dev_t(urows_h)
    wave_valid = dev_t(valid_h)
    old_entry = g.entry
    old_max = g.max_level
    dummy_slot = g.capacity - 1
    dummy_row = g.upper_capacity - 1

    # ---- 1. write node data into the tapes (int8 tapes get scaled-unit
    # inputs from the caller; cast_to_tape rounds and clips)
    g.vectors[slots_l] = cast_to_tape(wave_vecs, config)
    g.levels[slots_l] = dev_t(np.where(valid_h, levels_h, 0).astype(np.int32))
    g.upper_row[slots_l] = dev_t(np.where(valid_h[:, None], urows_h, -1).astype(np.int32))
    g.valid[slots_l] = wave_valid
    g.slot_to_rowid[slots_l] = dev_t(np.where(valid_h, rowids_h, -1).astype(np.int32))
    occupied = g.slot_to_rowid >= 0
    q_norms = (wave_vecs * wave_vecs).sum(-1)

    # ---- 2. descend to each node's insertion level
    seeds, seed_d = greedy_descent(
        g, config, wave_vecs, stop_level=wave_levels, q_norms=q_norms)
    has_entry = old_entry >= 0
    seeds = torch.where(has_entry, seeds, -1)
    seed_d = torch.where(has_entry, seed_d, _INF)
    if pivots is not None and pivots[0] is not None:
        # the nearest pivot, scored the way the beam scores every node
        p_seed, p_d = scored_pivot_seeds(g, config, wave_vecs, pivots[0], pivots[1], 1, q_norms,
                                         *pivots[2:])
        p_seed, p_d = p_seed[:, 0], p_d[:, 0]
        nearer = (wave_levels <= 1) & (p_seed >= 0) & (p_d < seed_d) & has_entry
        seeds = torch.where(nearer, p_seed, seeds)
        seed_d = torch.where(nearer, p_d, seed_d)

    # ---- intra-wave candidates: one W x W distance tile
    d_ww = pairwise(wave_vecs, wave_vecs, config.metric)
    eye = torch.eye(W, dtype=torch.bool, device=dev)
    d_ww = torch.where(eye | ~wave_valid[None, :] | ~wave_valid[:, None], _INF, d_ww)

    # ---- 3. per level: beam + select + write + backlink (top -> base),
    # each level seeing the adjacency the level above wrote. Levels with
    # no active node are skipped (the most: few waves reach high levels).
    for lev in range(config.max_levels, -1, -1):
        if lev > 0 and not (valid_h & (levels_h >= lev)).any():
            continue
        active = wave_valid & (wave_levels >= lev)
        s = torch.where(active, seeds, -1)
        sd = torch.where(active & (seeds >= 0), seed_d, _INF)
        # construction admits every reachable node (tombstones included)
        # -> single-pool beam
        res_d, res_i, _, _ = beam_search_base(
            g, config, wave_vecs, s, sd, efc, occupied,
            expand=expand, level=lev, q_norms=q_norms, dual_pool=False,
        )
        # intra-wave mates present at this level
        d_lev = torch.where((wave_levels >= lev)[None, :], d_ww, _INF)
        intra_d, pos = _sort_min_k(d_lev, intra_k)
        intra_i = torch.where(torch.isfinite(intra_d), slots[pos.long()], -1)
        cand_i = torch.cat([res_i, intra_i], 1)
        cand_d = torch.cat([res_d, intra_d], 1)
        chosen = select_neighbors(
            wave_vecs, cand_i, cand_d, g.vectors, config.m, config.metric, active)
        # write primary adjacency rows (inactive rows write the sink)
        if lev == 0:
            rows0 = torch.cat(
                [chosen, chosen.new_full((W, config.m0 - config.m), -1)], 1)
            g.adj0[torch.where(active, slots, dummy_slot).long()] = rows0
        else:
            urow = wave_upper_rows[:, lev - 1]
            ok_row = active & (urow >= 0)
            g.upper_adj[torch.where(ok_row, urow.clamp(min=0), dummy_row).long()] = chosen
        _apply_backlinks_level(g, config, slots, chosen, lev, active)
        # best graph node found at this level seeds the next one down
        upd = active & (res_i[:, 0] >= 0)
        seeds = torch.where(upd, res_i[:, 0], seeds)
        seed_d = torch.where(upd, res_d[:, 0], seed_d)

    # ---- 4. entry / max level / count
    eff_lv = np.where(valid_h, levels_h, -1)
    wave_max = int(eff_lv.max())
    wave_slot = int(slots_h[int(np.argmax(eff_lv))])
    promote = old_max < wave_max
    return dataclasses.replace(
        g,
        entry=torch.where(promote, wave_slot, old_entry).to(torch.int32),
        max_level=old_max.clamp(min=wave_max).to(torch.int32),
        count=(g.count + int(valid_h.sum())).to(torch.int32),
    )


def insert_wave(
    graph: HNSWGraph,
    config: HNSWConfig,
    wave_vecs,  # [W, d]
    slots,  # [W] i32, unique, none == capacity-1 (the sink)
    wave_levels,  # [W] i32
    wave_upper_rows,  # [W, Lmax] i32 (-1 = none)
    wave_rowids,  # [W] i32
    wave_valid,  # [W] bool (padding rows False)
    efc: int,
    expand: int = 4,
    intra_k: int = 16,
) -> HNSWGraph:
    """Insert one wave of nodes. Pure: the input graph is left as it was
    (its tensors are cloned first). Arguments are tensors or numpy
    arrays."""
    return _insert_wave_core(
        graph.clone(), config, wave_vecs, slots, wave_levels,
        wave_upper_rows, wave_rowids, wave_valid, efc, expand, intra_k,
    )


def plan_wave_rows(
    wave_levels: np.ndarray, next_row: int, max_levels: int
) -> tuple[np.ndarray, int]:
    """Assign compact upper_adj row ids for a wave's nodes (host side)."""
    lv = wave_levels.astype(np.int64)
    prefix = np.concatenate([[0], np.cumsum(lv)])[: len(lv)]
    col = np.arange(max_levels)[None, :]
    vals = next_row + prefix[:, None] + col
    rows = np.where(col < lv[:, None], vals, -1).astype(np.int32)
    return rows, next_row + int(lv.sum())


def build_graph_batched(
    vectors,
    config: HNSWConfig,
    *,
    seed: int = 0,
    wave_size: int = 1024,
    rowids: Optional[np.ndarray] = None,
    capacity: Optional[int] = None,
    efc: Optional[int] = None,
    expand: int = 4,
    intra_k: Optional[int] = None,
    progress: Optional[Callable[[int, int], None]] = None,
    device=None,
) -> tuple[HNSWGraph, int]:
    """Build a graph over `vectors` [n, d] with fixed-size insert waves on
    `device` (CUDA unless "cpu" is passed); the vectors are uploaded once.

    Returns (graph, upper_rows_used). Deterministic given `seed`.
    The last slot of the allocated capacity is reserved as a scatter sink
    and is never assigned to data. `progress(done, n)` is called after
    every wave.
    """
    dev = resolve_device(device)
    if isinstance(vectors, torch.Tensor):
        vectors = vectors.detach().cpu().numpy()
    vectors = np.asarray(vectors, np.float32)
    n, d = vectors.shape
    if d != config.dims:
        raise ValueError(f"vectors have {d} columns, config.dims is {config.dims}")
    W = max(1, min(wave_size, n))
    efc = efc or config.ef_construction
    intra_k = intra_k or min(config.m, W)
    levels = sample_levels(n, config, seed)
    capacity = max(capacity or 0, round_up(n, W) + 8)
    upper_cap = int(levels.sum()) + 64 + 1
    graph = empty_graph(config, capacity, upper_cap, device=dev)
    if rowids is None:
        rowids = np.arange(n, dtype=np.int32)

    n_waves = cdiv(n, W)
    n_pad = n_waves * W
    vecs_pad = torch.zeros((n_pad, d), dtype=torch.float32, device=dev)
    vecs_pad[:n] = torch.from_numpy(vectors).to(dev)
    levels_pad = np.zeros(n_pad, np.int32)
    levels_pad[:n] = levels
    urows_pad, next_row = plan_wave_rows(levels_pad, 0, config.max_levels)
    rowids_pad = np.full(n_pad, -1, np.int32)
    rowids_pad[:n] = np.asarray(rowids, np.int64).astype(np.int32)
    valid_pad = np.arange(n_pad) < n

    for w in range(n_waves):
        s0 = w * W
        sl = slice(s0, s0 + W)
        graph = _insert_wave_core(
            graph, config, vecs_pad[sl], np.arange(s0, s0 + W), levels_pad[sl],
            urows_pad[sl], rowids_pad[sl], valid_pad[sl], efc, expand, intra_k,
        )
        if progress is not None:
            progress(min(s0 + W, n), n)
    return graph, next_row
