"""Sharded bulk build: the exact builder's passes, once per shard.

Reproduces `vss_tpu/parallel/sharded_build.py:116-359`. Every shard builds
an independent graph from its own rows of a round-robin partition (no
cross-shard edges: searches merge per-shard lists), so the passes need no
collective. Per shard, on its slot's device:

  1. candidates: exact top-C neighbours over the shard's rows
     (`exact_build._knn_all`), on the scaled f32 vectors;
  2. refine + back-links: `_refine_forward`, `_group_incoming_local`,
     `_merge_backlinks` (kernel K5), on the stored tape in f32;
  3. upper levels: `_upper_level_pass` per level;
  4. connectivity repair: `index/repair.repair_connectivity` (K3).

Level sampling (seed + shard), slot assignment and the common shapes are
decided on the host, as in the JAX package: every shard gets capacity
max-shard-rows + 8, the same upper capacity, and C and the tile widths of
the largest shard. With several processes each rank builds its own
shards; the host bookkeeping is the same on every rank.

What differs from the JAX package: each pass runs shard after shard
instead of as one SPMD program over all of them, and on each shard's own
rows rather than on rows padded to the largest shard (padding rows were
masked out and change nothing). `approx = use_pallas()` and `dist_bf16 =
use_pallas()` become what `index/exact_build.py` made of them: always an
exact top-k; bf16-rounded products and a bf16 distance buffer on the
card, f32 on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from vss_tpu_torch.index.build import plan_wave_rows
from vss_tpu_torch.index.exact_build import (
    _INCOMING_CAP,
    _backlink_pass,
    _knn_all,
    _refine_forward,
    _rows_per_chunk,
    _upper_level_pass,
)
from vss_tpu_torch.index.graph import HNSWConfig, HNSWGraph, cast_to_tape, empty_graph, sample_levels
from vss_tpu_torch.index.repair import repair_connectivity
from vss_tpu_torch.ops.distance import Metric
from vss_tpu_torch.parallel.mesh import on_device
from vss_tpu_torch.utils import round_up

__all__ = ["build_exact_sharded"]


def _build_shard(xv: torch.Tensor, rowids: np.ndarray, levels: np.ndarray, urows: np.ndarray,
                 cap: int, upper_cap: int, C: int, tile: int, block: int,
                 config: HNSWConfig) -> HNSWGraph:
    """One shard's graph from its scaled f32 rows `xv` [n_s, d] (on the
    slot's device); levels / urows are [cap] / [cap, Lmax], zero / -1 past
    n_s."""
    dev = xv.device
    ns, d = xv.shape
    graph = empty_graph(config, cap, upper_cap, device=dev)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    graph.vectors[:ns] = cast_to_tape(xv, config)
    graph.levels[:] = t(levels)
    graph.upper_row[:] = t(urows)
    graph.valid[:ns] = True
    graph.slot_to_rowid[:ns] = t(rowids.astype(np.int32))
    graph = dataclasses.replace(
        graph,
        entry=torch.tensor(int(np.argmax(levels[:ns])) if ns else -1, dtype=torch.int32,
                           device=dev),
        max_level=torch.tensor(int(levels[:ns].max()) if ns else 0, dtype=torch.int32,
                               device=dev),
        count=torch.tensor(ns, dtype=torch.int32, device=dev),
    )
    if ns == 0:
        return graph
    fast = dev.type == "cuda"
    slots = torch.arange(ns, dtype=torch.int32, device=dev)
    # ---- candidates: exact kNN over the shard's rows
    cand_d, cand_i = _knn_all(xv, slots, xv, C, Metric.parse(config.metric), tile, block, fast,
                              fast)
    # ---- base layer refine + back-links
    tape_f32 = graph.vectors.float()
    _refine_forward(graph.adj0, tape_f32, cand_d, cand_i, slots, config, config.m0)
    del cand_d, cand_i
    _backlink_pass(graph, config, slots, slots, graph.adj0[:ns].clone(), tape_f32, 0,
                   _rows_per_chunk(config.m0 + _INCOMING_CAP, d))
    # ---- upper levels (a level with at most one member changes nothing)
    urows_t = t(urows)
    for lev in range(1, int(levels[:ns].max()) + 1):
        member = np.nonzero(levels[:ns] >= lev)[0]
        if member.size <= 1:
            break
        mslots = t(member.astype(np.int32))
        _upper_level_pass(tape_f32, mslots, urows_t[mslots.long(), lev - 1], graph.upper_adj,
                          config, tile, block, _rows_per_chunk(2 * config.m, d))
    del tape_f32
    # ---- connectivity repair
    graph, _ = repair_connectivity(graph, config)
    return graph


def build_exact_sharded(
    index,  # ShardedHNSWIndex (host bookkeeping filled here)
    vectors: np.ndarray,  # [n, d] f32, already in scaled units
    rowids: np.ndarray,
    *,
    seed: int = 0,
    block: int = 2048,
    tile: int = 65536,
    progress: Optional[Callable[[int, int], None]] = None,
) -> None:
    """Fill `index.graphs` with one exact-built graph per local shard of a
    round-robin row partition, and the index's host bookkeeping."""
    S = index.n_shards
    config: HNSWConfig = index.config
    n = vectors.shape[0]
    parts = [np.arange(s, n, S) for s in range(S)]
    n_s = [len(p) for p in parts]
    Pmax = max(n_s) if n else 1
    cap = Pmax + 8

    # per-shard level samples + upper-row plans (host; capacities common)
    levels = np.zeros((S, cap), np.int32)
    urows = np.full((S, cap, config.max_levels), -1, np.int32)
    next_rows = [0] * S
    for s in range(S):
        levels[s, : n_s[s]] = sample_levels(n_s[s], config, seed + s)
        urows[s], next_rows[s] = plan_wave_rows(levels[s], 0, config.max_levels)
    upper_cap = max(next_rows) + 64 + 1
    # candidate width and tiles from the largest shard, as one SPMD program
    # over all shards would take them
    C = min(max(2 * config.m0, config.m0 + 8), max(Pmax - 1, 1))
    tile_s = min(tile, round_up(Pmax, 512))
    block_s = min(block, round_up(Pmax, 256))

    graphs = [None] * S
    done = 0
    for s in index._local:
        dev = index.mesh.devices[s]
        with on_device(dev):
            xv = torch.from_numpy(np.ascontiguousarray(vectors[parts[s]])).to(dev)
            graphs[s] = _build_shard(xv, rowids[parts[s]], levels[s], urows[s], cap, upper_cap,
                                     C, tile_s, block_s, config)
            del xv
        done += 2 * n_s[s]
        if progress is not None:
            progress(done, 2 * n)
    index.graphs = tuple(graphs)

    # host bookkeeping (mirrors ShardedHNSWIndex's wave build)
    index.count = n
    index.dirty = True
    index.next_slot = list(n_s)
    index.upper_used = list(next_rows)
    index._set_locs(parts, rowids)
    index._insert_seed = n
    index._insert_counter = n
