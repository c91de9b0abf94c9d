"""Sharded HNSW: row-partitioned per-slot graphs with a merge of per-shard lists.

Reproduces `vss_tpu/parallel/sharded.py`. The base table is partitioned
round-robin into one independent HNSW shard per mesh slot. A search sends
the query batch to every shard, each shard runs its own beam search (or
exact scan), and the per-shard top-k lists are merged into the global
top-k. No shard touches another shard's memory. The host bookkeeping (the
rowid -> (shard, slot) map, free slots, upper-row use) mirrors the JAX
package's field for field.

What differs from the JAX package:
  * layout: the JAX package stacks every shard into one [S, ...] pytree,
    which `shard_map` needs. Slots on different devices cannot share a
    tensor, so `graphs` is a tuple of one `HNSWGraph` per shard, and
    `rerank_tapes` one side tape per shard, each on its slot's device
    (None at the slots another rank holds). Every shard keeps the same
    capacities, so `slot_rowid_array()` and `filter_mask` are still the
    [S, cap] views the query layer builds masks on;
  * the merge: the JAX package runs an `all_gather` and `merge_topk`
    inside `shard_map`. Here each shard runs `index/search.hnsw_search`
    (or `ops/scan.scan_topk`), its [B, k] lists move to the first local
    slot's device (`index.device`) and are concatenated in shard order
    into [B, S*k]; `ops/topk.merge_topk`, a stable sort, lets the earlier
    shard win ties, as `lax.top_k` does. With several processes the
    concatenation is a `dist.all_gather` over ranks (`multihost.py`);
  * each shard's beam is seeded from that shard's pivots (its level >= 1
    nodes), as `HNSWIndex.search` seeds it in both packages, where the
    JAX package's sharded search (`vss_tpu/parallel/sharded.py:274-279`)
    runs greedy descent from the entry; and an insert wave seeds its
    nodes from the shard's pivots where they are nearer than the
    descent's end (`index/build._insert_wave_core(pivots=...)`), where
    the JAX package descends only. The bulk builder's upper levels join
    no clusters, so on its graphs the descent lands in the wrong cluster:
    on the 1,000,000-row SIFT-like flagship on the H100 (`chip_smoke.py`
    phase 8), recall@10 at ef 64 was 0.71 with the descent against 0.986
    with the pivots, and 20% of 32,768 inserted rows (one wave of 8,192 a
    shard) missed themselves at k=1 with the descent, none with the
    pivots;
  * the pivots and the norm tape of the exact scan are cached per shard
    on a weakref of the shard's graph: a superseded graph is not kept
    alive by them;
  * extracting a shard as an `HNSWIndex` (compaction, checkpoints, stats)
    shares its tensors on the device instead of copying them to the host:
    `HNSWIndex` publishes new tensors and never writes into published
    ones.

The kernels are the single index's: per shard, `beam_search` (K1, K5)
and K1 / K5 around it in the graph search and the insert waves, K2 in the
scan, K5 in compaction and the rebalance's row gather, and the bulk
builder's (`parallel/sharded_build.py`).
"""
from __future__ import annotations

import collections
import dataclasses
import json
import os
import weakref
from typing import Optional

import numpy as np
import torch

from vss_tpu_torch.index.build import _insert_wave_core, plan_wave_rows
from vss_tpu_torch.index.dense import HNSWIndex, graph_pivots, pivot_rows, rescale_distances
from vss_tpu_torch.index.graph import (
    HNSWConfig,
    HNSWGraph,
    check_rowids_int32,
    empty_graph,
    grow_graph,
    sample_levels,
)
from vss_tpu_torch.index.search import hnsw_search
from vss_tpu_torch.ops.gather import gather_rows
from vss_tpu_torch.ops.scan import scan_topk
from vss_tpu_torch.ops.topk import merge_topk
from vss_tpu_torch.parallel.mesh import Mesh, make_mesh, on_device
from vss_tpu_torch.parallel.multihost import (
    gather_ranks,
    is_multiprocess,
    local_shard_indices,
)
from vss_tpu_torch.utils import cdiv, next_pow2, round_up

__all__ = ["ShardedHNSWIndex"]

_INF = float("inf")


def _sq_norms(g: HNSWGraph) -> torch.Tensor:
    xv = g.vectors.float()
    return (xv * xv).sum(-1)


class ShardedHNSWIndex:
    """Row-partitioned HNSW over the shard slots of a `Mesh` (default: one
    slot per visible CUDA card, or one CPU slot with `device="cpu"`)."""

    supports_filter_pushdown = True

    def __init__(self, config: HNSWConfig, mesh: Optional[Mesh] = None, device=None):
        self.config = config
        self.mesh = mesh or make_mesh(device=device)
        self.n_shards = self.mesh.size
        S = self.n_shards
        self._local = local_shard_indices(self.mesh)
        if not self._local:
            raise ValueError("this process holds no slot of the mesh")
        self._multi = is_multiprocess(self.mesh)
        self.graphs: Optional[tuple] = None  # one HNSWGraph per shard
        self.count = 0
        # host-side bookkeeping, per shard (mirrors HNSWIndex's)
        self.next_slot = [0] * S
        self.upper_used = [0] * S
        self.free_slots: list[list[int]] = [[] for _ in range(S)]
        self.shard_deleted = [0] * S
        self.rowid_to_loc: dict[int, tuple[int, int]] = {}  # rowid -> (shard, slot)
        self.deleted_count = 0
        self._insert_seed = 0
        self._insert_counter = 0
        self.dirty = False
        # int8 tapes: one global symmetric quantization scale for all shards
        self.vector_scale = 1.0
        # full-precision rescore side tape per shard, [cap, d] in SCALED units
        self.rerank_tapes: Optional[tuple] = None
        # per-shard pivots and squared-norm tapes, each keyed on a weakref
        # of the shard's graph
        self._pivot_cache: list = [None] * S
        self._norms_cache: list = [None] * S

    @property
    def device(self) -> torch.device:
        """Where merged results land: the first slot this process holds."""
        return self.mesh.devices[self._local[0]]

    def _graph(self, s: int) -> HNSWGraph:
        g = self.graphs[s]
        if g is None:
            raise ValueError(f"shard {s} is held by another process")
        return g

    def slot_rowid_array(self) -> np.ndarray:
        """slot -> rowid tapes, host copy: [n_shards, cap]. The uniform
        surface filtered search masks are built against."""
        return np.stack([self._graph(s).slot_to_rowid.cpu().numpy()
                         for s in range(self.n_shards)])

    def _set_locs(self, parts, rowids) -> None:
        for s, part in enumerate(parts):
            self.rowid_to_loc.update(zip(rowids[part].tolist(),
                                         ((s, slot) for slot in range(len(part)))))

    def _init_rerank_tapes(self, vectors: np.ndarray, parts) -> None:
        """The per-shard side tapes from the scaled f32 vectors: shard s
        holds rows parts[s] in slots 0.. (both build paths)."""
        rr = self.config.rerank_dtype
        if rr is None or self.graphs is None:
            self.rerank_tapes = None
            return
        tapes = []
        for s, g in enumerate(self.graphs):
            if g is None:
                tapes.append(None)
                continue
            t = torch.zeros((g.capacity, self.config.dims), dtype=rr, device=g.device)
            if len(parts[s]):
                t[: len(parts[s])] = torch.from_numpy(vectors[parts[s]]).to(g.device, rr)
            tapes.append(t)
        self.rerank_tapes = tuple(tapes)

    # ------------------------------------------------------------ build
    @classmethod
    def build(
        cls,
        vectors,
        config: HNSWConfig,
        mesh: Optional[Mesh] = None,
        *,
        rowids: Optional[np.ndarray] = None,
        seed: int = 0,
        wave_size: int = 1024,
        efc: Optional[int] = None,
        expand: int = 4,
        method: str = "auto",
        progress=None,
        device=None,
    ) -> "ShardedHNSWIndex":
        """Round-robin row partition, then per-shard construction.

        method: 'exact' (the bulk builder per shard,
        `parallel/sharded_build.py`); 'wave' (lock-step wave insertion,
        the path `insert()` takes); 'auto': exact when every shard gets
        at least 4 rows."""
        self = cls(config, mesh, device=device)
        S = self.n_shards
        if isinstance(vectors, torch.Tensor):
            vectors = vectors.detach().cpu().numpy()
        vectors = np.asarray(vectors, np.float32)
        if config.storage_dtype == "int8":
            self.vector_scale = float(np.abs(vectors).max()) / 127.0 or 1.0
            vectors = vectors / self.vector_scale
        n = vectors.shape[0]
        if rowids is None:
            rowids = np.arange(n, dtype=np.int64)
        rowids = np.asarray(rowids)
        check_rowids_int32(rowids)
        if method == "auto":
            method = "exact" if n >= 4 * S else "wave"
        if method not in ("exact", "wave"):
            raise ValueError(f"unknown build method '{method}'")
        # round-robin partition (balanced for any input order)
        parts = [np.arange(s, n, S) for s in range(S)]
        if method == "exact":
            from vss_tpu_torch.parallel.sharded_build import build_exact_sharded

            build_exact_sharded(self, vectors, rowids, seed=seed, progress=progress)
        else:
            self._build_waves(vectors, rowids, parts, seed, wave_size,
                              efc or config.ef_construction, expand, progress)
        self._init_rerank_tapes(vectors, parts)
        return self

    def _build_waves(self, vectors, rowids, parts, seed, wave_size, efc, expand, progress):
        """Lock-step wave insertion: wave w inserts rows w*W.. of every
        shard's part, each shard on its own slot."""
        config = self.config
        S = self.n_shards
        n, d = vectors.shape
        per = max(len(p) for p in parts) if n else 0
        W = max(1, min(wave_size, per))
        cap = round_up(max(per, 1), W) + 8
        levels = sample_levels(n, config, seed)
        upper_cap = max(64, int(levels.sum()) + S * 64 + 1)
        graphs = [empty_graph(config, cap, upper_cap, device=self.mesh.devices[s])
                  if s in self._local else None for s in range(S)]
        next_rows = [0] * S
        n_waves = cdiv(per, W) if per else 0
        for w in range(n_waves):
            lo = w * W
            for s in range(S):
                part = parts[s]
                cnt = max(min(lo + W, len(part)) - lo, 0)
                wv = np.zeros((W, d), np.float32)
                lv = np.zeros(W, np.int32)
                rid = np.full(W, -1, np.int32)
                va = np.zeros(W, bool)
                if cnt > 0:
                    rows = part[lo:lo + cnt]
                    wv[:cnt] = vectors[rows]
                    lv[:cnt] = levels[rows]
                    rid[:cnt] = rowids[rows].astype(np.int32)
                    va[:cnt] = True
                ur, next_rows[s] = plan_wave_rows(lv, next_rows[s], config.max_levels)
                if graphs[s] is not None:
                    with on_device(graphs[s].device):
                        graphs[s] = _insert_wave_core(
                            graphs[s], config, wv, np.arange(lo, lo + W), lv, ur, rid, va,
                            efc, expand, min(config.m, W))
            if progress is not None:
                progress(min((w + 1) * W * S, n), n)
        self.graphs = tuple(graphs)
        self.count = n
        self.dirty = True
        self.next_slot = [len(p) for p in parts]
        self.upper_used = list(next_rows)
        self._set_locs(parts, rowids)
        self._insert_seed = n
        self._insert_counter = n

    # ------------------------------------------------------------ search
    def shard_ef(self, ef: int, k: int, margin: Optional[int] = None) -> int:
        """Per-shard beam width for a round-robin row partition.

        Each shard holds a uniform 1/S sample of the corpus, so a shard
        only has to surface ITS members of the global top-k (~k/S of them,
        its locally nearest rows), not a full-quality local top-k: ef/S
        plus a margin (at least 8) holds global recall close to the full
        beam's while each shard's distance evaluations shrink."""
        S = self.n_shards
        if S <= 1:
            return max(ef, k)
        if margin is None:
            margin = max(8, ef // (4 * S))
        return max(k, cdiv(ef, S) + margin)

    def _queries(self, queries) -> torch.Tensor:
        if isinstance(queries, torch.Tensor):
            q = queries.detach().to(self.device, torch.float32)
        else:
            q = torch.from_numpy(np.ascontiguousarray(queries, np.float32)).to(self.device)
        if q.dim() == 1:
            q = q[None]
        if self.config.storage_dtype == "int8":
            q = q / self.vector_scale
        return q

    def _split_mask(self, filter_mask, graphs) -> dict:
        """The [S, cap] per-slot predicate (numpy or a tensor on any
        device) as one bool row per local shard, on its slot's device."""
        if filter_mask is None:
            return {}
        m = filter_mask if isinstance(filter_mask, torch.Tensor) else torch.from_numpy(
            np.asarray(filter_mask, bool))
        if m.dim() != 2 or m.shape[0] != self.n_shards:
            raise ValueError(f"filter_mask must be [{self.n_shards}, cap], got {tuple(m.shape)}")
        return {s: m[s].to(graphs[s].device, torch.bool) for s in self._local}

    def _merge(self, outs: dict, k: int):
        """Per-shard (dists [B, k], rowids [B, k]) -> the global top-k, on
        `self.device`: concatenated in shard order, then a stable merge."""
        dev = self.device
        d = torch.cat([outs[s][0].to(dev) for s in self._local], 1)
        r = torch.cat([outs[s][1].to(dev) for s in self._local], 1)
        if self._multi:
            d = self._gather_shards(d, k, _INF)
            r = self._gather_shards(r, k, -1)
        return merge_topk(d, r, k)

    def _gather_shards(self, block: torch.Tensor, width: int, fill) -> torch.Tensor:
        """This rank's [B, n_local*width] block -> every shard's [B,
        S*width], in shard order, on every rank. Blocks are padded to the
        most slots any rank holds for the all_gather."""
        per_rank = collections.Counter(self.mesh.owners)
        most = max(per_rank.values()) * width
        if block.shape[1] < most:
            block = torch.cat([block, block.new_full((block.shape[0], most - block.shape[1]),
                                                     fill)], 1)
        blocks = gather_ranks(block)
        return torch.cat([b[:, : per_rank.get(r, 0) * width] for r, b in enumerate(blocks)], 1)

    def search(self, queries, k: int, ef: Optional[int] = None, expand: int = 1,
               filter_mask=None, scale_ef: bool = True, with_stats: bool = False):
        """Batched search over every shard; returns (dists [B, k], rowids
        [B, k]) on `self.device`.

        `filter_mask`: optional bool [n_shards, cap] per-slot predicate
        (rows allowed into results). `scale_ef`: shrink the per-shard beam
        to `shard_ef(ef, k)` (`ef` keeps its global meaning; False runs
        the full beam on every shard). `with_stats=True` also returns
        {"per_shard_evals": [S] int64, "ef_shard": int}: each shard's
        distance evaluations, from the beam's counters."""
        graphs = self.graphs  # snapshot: DML publishes a new tuple
        if graphs is None:
            raise ValueError("index is empty — call build() first")
        tapes = self.rerank_tapes
        q = self._queries(queries)
        ef = max(ef or self.config.ef_search, k)
        ef_shard = self.shard_ef(ef, k) if scale_ef else ef
        masks = self._split_mask(filter_mask, graphs)
        all_valid = self.deleted_count == 0 and filter_mask is None
        outs, evals = {}, []
        for s in self._local:
            g = graphs[s]
            with on_device(g.device):
                pivot_slots, pivot_vecs, pivot_norms = self._pivots(s, g)
                res = hnsw_search(
                    g, self.config, q.to(g.device), k, ef=ef_shard, filter_mask=masks.get(s),
                    expand=expand, assume_all_valid=all_valid, pivot_slots=pivot_slots,
                    pivot_vecs=pivot_vecs, pivot_norms=pivot_norms,
                    rerank_tape=None if tapes is None else tapes[s], with_stats=with_stats)
                slots = res[1]
                rows = torch.where(slots >= 0, g.slot_to_rowid[slots.clamp(min=0).long()], -1)
            outs[s] = (res[0], rows)
            if with_stats:
                evals.append(res[2]["distance_evals"])
        d, rows = self._merge(outs, k)
        if self.config.storage_dtype == "int8":
            d = rescale_distances(d, self.vector_scale, self.config.metric)
        if with_stats:
            ev = torch.tensor(evals, dtype=torch.int64)[None]
            if self._multi:
                ev = self._gather_shards(ev, 1, 0)
            return d, rows, {"per_shard_evals": ev[0].numpy(), "ef_shard": ef_shard}
        return d, rows

    def _pivots(self, s: int, g: HNSWGraph):
        """Shard s's (pivot_slots, f32 rows, squared norms) (`pivot_rows`),
        cached on its graph."""
        return self._cached(self._pivot_cache, s, g, lambda graph: pivot_rows(*graph_pivots(graph)))

    @staticmethod
    def _cached(cache: list, s: int, g: HNSWGraph, compute):
        """compute(g) for shard s, cached on a weakref of its graph (a new
        graph recomputes it)."""
        c = cache[s]
        if c is None or c[0]() is not g:
            c = cache[s] = (weakref.ref(g), compute(g))
        return c[1]

    # ------------------------------------------------------ exact scan
    def scan_search(self, queries, k: int, filter_mask=None, with_stats: bool = False):
        """Sharded exact-scan serving path: `scan_topk` over each shard's
        own tape (keep = 2k), then the merge. Returns (dists [B, k],
        rowids [B, k]) like `search()`; distances exact with respect to the
        rerank tape when one exists. `with_stats=True` adds
        {"per_shard_bytes": int}, the bytes each shard streams per query
        batch (its tape)."""
        graphs = self.graphs
        if graphs is None:
            raise ValueError("index is empty — call build() first")
        tapes = self.rerank_tapes
        q = self._queries(queries)
        masks = self._split_mask(filter_mask, graphs)
        outs = {}
        for s in self._local:
            g = graphs[s]
            allow = g.valid if s not in masks else g.valid & masks[s]
            with on_device(g.device):
                d, slots = scan_topk(
                    q.to(g.device), g.vectors, k, self.config.metric, valid_mask=allow,
                    x_norms=self._cached(self._norms_cache, s, g, _sq_norms),
                    rerank_tape=None if tapes is None else tapes[s], keep=2 * k,
                    device=g.device)
                rows = torch.where(slots >= 0, g.slot_to_rowid[slots.clamp(min=0).long()], -1)
            outs[s] = (d, rows)
        d, rows = self._merge(outs, k)
        if self.config.storage_dtype == "int8":
            d = rescale_distances(d, self.vector_scale, self.config.metric)
        if with_stats:
            g = graphs[self._local[0]]
            return d, rows, {"per_shard_bytes": g.capacity * self.config.dims
                             * g.vectors.element_size()}
        return d, rows

    # ------------------------------------------------------------ CRUD
    def insert(self, vectors, rowids):
        """Insert rows, balancing across shards; recycles tombstoned slots
        first. One wave per shard, W the next power of two of the most
        rows any shard takes, its nodes seeded from the shard's pivots
        where they are nearer than the greedy descent's end."""
        if self.graphs is None:
            raise ValueError("index is empty — call build() first")
        if isinstance(vectors, torch.Tensor):
            vectors = vectors.detach().cpu().numpy()
        vectors = np.asarray(vectors, np.float32)
        if vectors.ndim == 1:
            vectors = vectors[None]
        if self.config.storage_dtype == "int8":
            vectors = vectors / self.vector_scale  # out-of-range clips in-wave
        rowids = np.asarray(rowids, np.int64).reshape(-1)
        check_rowids_int32(rowids)
        n = vectors.shape[0]
        if n == 0:
            return
        S = self.n_shards
        d = self.config.dims
        for r in rowids:
            if int(r) in self.rowid_to_loc:
                raise ValueError(f"duplicate rowid {int(r)}")
        levels = sample_levels(n, self.config, seed=self._insert_seed)
        self._insert_seed += n
        # fill tombstoned slots first (whatever shard they are on), then
        # round-robin the rest to keep shards balanced
        assign: list[int] = []
        for s in range(S):
            take = min(len(self.free_slots[s]), n - len(assign))
            assign.extend([s] * take)
            if len(assign) == n:
                break
        while len(assign) < n:
            assign.append(self._insert_counter % S)
            self._insert_counter += 1
        shard_of = np.asarray(assign, np.int64)
        per_new = [int((shard_of == s).sum()) for s in range(S)]
        need_cap = max(self.next_slot[s] - len(self.free_slots[s]) + per_new[s] + 8
                       for s in range(S))
        need_upper = max(self.upper_used[s] + int(levels[shard_of == s].sum()) + 1
                         for s in range(S))
        self._ensure_capacity(need_cap, need_upper)
        cap = self.graphs[self._local[0]].capacity
        W = next_pow2(max(per_new))
        graphs = list(self.graphs)
        tapes = None if self.rerank_tapes is None else list(self.rerank_tapes)
        for s in range(S):
            rows = np.flatnonzero(shard_of == s)
            cnt = len(rows)
            slots = []
            for _ in range(min(cnt, len(self.free_slots[s]))):
                slots.append(self.free_slots[s].pop())
                self.shard_deleted[s] -= 1
                self.deleted_count -= 1
            fresh = cnt - len(slots)
            if fresh > 0:
                slots.extend(range(self.next_slot[s], self.next_slot[s] + fresh))
                self.next_slot[s] += fresh
            wv = np.zeros((W, d), np.float32)
            sl = np.zeros(W, np.int32)
            lv = np.zeros(W, np.int32)
            rid = np.full(W, -1, np.int32)
            va = np.zeros(W, bool)
            if cnt:
                wv[:cnt] = vectors[rows]
                sl[:cnt] = slots
                lv[:cnt] = levels[rows]
                rid[:cnt] = rowids[rows].astype(np.int32)
                va[:cnt] = True
                self.rowid_to_loc.update(zip(rowids[rows].tolist(), ((s, int(x)) for x in slots)))
            # padding rows scatter into the reserved tail
            if cnt < W:
                sl[cnt:] = cap - 8 + (np.arange(W - cnt) % 7)
            ur, self.upper_used[s] = plan_wave_rows(lv, self.upper_used[s],
                                                    self.config.max_levels)
            g = graphs[s]
            if g is None:
                continue
            with on_device(g.device):
                pivots = self._pivots(s, g)
                graphs[s] = _insert_wave_core(
                    g.clone(), self.config, wv, sl, lv, ur, rid, va,
                    self.config.ef_construction, 4, min(self.config.m, W), pivots=pivots)
                if tapes is not None and cnt:
                    # the scaled f32 rows at the slots the wave wrote
                    t = tapes[s].clone()
                    t[torch.from_numpy(sl[:cnt].astype(np.int64)).to(t.device)] = (
                        torch.from_numpy(wv[:cnt]).to(t.device, t.dtype))
                    tapes[s] = t
        self.graphs = tuple(graphs)
        if tapes is not None:
            self.rerank_tapes = tuple(tapes)
        self.count += n
        self.dirty = True

    def delete(self, rowids) -> int:
        """Tombstone rows (graph untouched; results exclude them)."""
        locs = []
        for r in rowids:
            loc = self.rowid_to_loc.pop(int(r), None)
            if loc is not None:
                locs.append(loc)
        if not locs:
            return 0
        by_shard = collections.defaultdict(list)
        for s, slot in locs:
            by_shard[s].append(slot)
        graphs = list(self.graphs)
        for s, slots in by_shard.items():
            g = graphs[s]
            if g is None:
                continue
            valid = g.valid.clone()
            valid[torch.as_tensor(slots, dtype=torch.long, device=g.device)] = False
            graphs[s] = dataclasses.replace(g, valid=valid, count=g.count - len(slots))
        self.graphs = tuple(graphs)
        for s, slot in locs:
            self.free_slots[s].append(slot)
            self.shard_deleted[s] += 1
        self.deleted_count += len(locs)
        self.count -= len(locs)
        self.dirty = True
        return len(locs)

    def _ensure_capacity(self, need_cap: int, need_upper: int):
        """Grow every shard together (caps stay uniform: the [S, cap]
        views)."""
        g0 = self.graphs[self._local[0]]
        cap, ucap = g0.capacity, g0.upper_capacity
        new_cap, new_ucap = cap, ucap
        while new_cap < need_cap:
            new_cap *= 2
        while new_ucap < need_upper:
            new_ucap *= 2
        if (new_cap, new_ucap) == (cap, ucap):
            return
        self.graphs = tuple(None if g is None else grow_graph(g, self.config, new_cap, new_ucap)
                            for g in self.graphs)
        if self.rerank_tapes is not None:
            self.rerank_tapes = tuple(
                None if t is None else torch.cat([t, t.new_zeros((new_cap - cap, t.shape[1]))])
                for t in self.rerank_tapes)

    # ------------------------------------------------ compact / persist
    def _shard_maps(self) -> list[dict]:
        """rowid -> slot, one dict per shard."""
        maps: list[dict] = [{} for _ in range(self.n_shards)]
        for r, (s, slot) in self.rowid_to_loc.items():
            maps[s][r] = slot
        return maps

    def _extract_shard(self, s: int, rowid_to_slot: Optional[dict] = None) -> HNSWIndex:
        """Shard s as a standalone HNSWIndex sharing its tensors."""
        g = self._graph(s)
        idx = HNSWIndex(self.config, capacity=64, device=g.device)
        idx.graph = g
        idx.next_slot = self.next_slot[s]
        idx.upper_used = self.upper_used[s]
        idx.free_slots = list(self.free_slots[s])
        idx.deleted_count = self.shard_deleted[s]
        idx.rowid_to_slot = dict(rowid_to_slot if rowid_to_slot is not None
                                 else self._shard_maps()[s])
        idx._insert_seed = self._insert_seed
        idx.vector_scale = self.vector_scale
        idx.rerank_tape = None if self.rerank_tapes is None else self.rerank_tapes[s]
        return idx

    def _restack(self, locals_) -> None:
        """Adopt per-shard HNSWIndexes (all shards, in order), grown to
        common capacities and moved to their slots; shards of other ranks
        keep only their bookkeeping."""
        cap = max(l.graph.capacity for l in locals_)
        ucap = max(l.graph.upper_capacity for l in locals_)
        local = set(self._local)
        graphs, tapes = [], []
        for s, l in enumerate(locals_):
            if s not in local:
                graphs.append(None)
                tapes.append(None)
                continue
            dev = self.mesh.devices[s]
            graphs.append(grow_graph(l.graph, self.config, cap, ucap).to(dev))
            rt = l.rerank_tape
            if rt is not None:
                rt = (torch.cat([rt, rt.new_zeros((cap - rt.shape[0], rt.shape[1]))])
                      if rt.shape[0] < cap else rt[:cap]).to(dev)
            tapes.append(rt)
        self.graphs = tuple(graphs)
        have_rr = all(l.rerank_tape is not None for l in locals_)
        self.rerank_tapes = tuple(tapes) if have_rr else None
        self.next_slot = [l.next_slot for l in locals_]
        self.upper_used = [l.upper_used for l in locals_]
        self.free_slots = [list(l.free_slots) for l in locals_]
        self.shard_deleted = [l.deleted_count for l in locals_]
        self.deleted_count = sum(self.shard_deleted)
        self.rowid_to_loc = {
            int(r): (s, int(slot))
            for s, l in enumerate(locals_)
            for r, slot in l.rowid_to_slot.items()
        }
        self.count = sum(l.count for l in locals_)
        self.vector_scale = max((l.vector_scale for l in locals_), default=1.0)

    def compact(self):
        """Compaction (PRAGMA hnsw_compact_index): when tombstones have
        skewed the shards, repartition globally (`rebalance`); otherwise
        compact each shard in place."""
        if self.deleted_count == 0:
            return
        if self.rebalance():
            return
        maps = self._shard_maps()
        locals_ = [self._extract_shard(s, maps[s]) for s in range(self.n_shards)]
        for l in locals_:
            with on_device(l.device):
                l.compact()
        self._restack(locals_)
        self.dirty = True

    def _live_counts(self) -> np.ndarray:
        return np.bincount([s for s, _ in self.rowid_to_loc.values()],
                           minlength=self.n_shards).astype(np.int64)

    def rebalance(self, max_imbalance: float = 0.25, wave_size: int = 1024) -> bool:
        """Skew-aware repartitioning: when live row counts diverge across
        shards by more than `max_imbalance` of the mean, pull every live
        row back and rebuild with a balanced round-robin partition.
        Returns True if a rebuild happened. The rows come from the
        full-precision side tape when there is one (requantizing from the
        int8 tape would quantize twice), through kernel K5."""
        if self.graphs is None:
            return False
        counts = self._live_counts()
        total = int(counts.sum())
        if total == 0:
            return False
        mean = total / self.n_shards
        if counts.max() - counts.min() <= max_imbalance * max(mean, 1.0):
            return False
        vecs, rids = [], []
        for s in range(self.n_shards):
            g = self._graph(s)
            live = np.flatnonzero(g.valid.cpu().numpy())
            src = g.vectors if self.rerank_tapes is None else self.rerank_tapes[s]
            with on_device(g.device):
                v = gather_rows(src, torch.from_numpy(live.astype(np.int32)).to(g.device))
            v = v.float().cpu().numpy()
            if self.config.storage_dtype == "int8":
                v = v * self.vector_scale
            vecs.append(v)
            rids.append(g.slot_to_rowid.cpu().numpy()[live])
        vectors = np.concatenate(vecs)
        rowids = np.concatenate(rids).astype(np.int64)
        fresh = ShardedHNSWIndex.build(vectors, self.config, self.mesh, rowids=rowids,
                                       wave_size=wave_size, seed=self._insert_seed)
        self.__dict__.update(fresh.__dict__)
        self.dirty = True
        return True

    def save(self, path: str):
        """Checkpoint: one stream per shard + catalog json (directory), the
        JAX package's layout."""
        from vss_tpu_torch.storage.serialize import save_index

        os.makedirs(path, exist_ok=True)
        maps = self._shard_maps()
        for s in range(self.n_shards):
            save_index(self._extract_shard(s, maps[s]), os.path.join(path, f"shard_{s}.vss"))
        with open(os.path.join(path, "sharded.json"), "w") as f:
            json.dump({"n_shards": self.n_shards,
                       "config": dataclasses.asdict(self.config)}, f)
        self.dirty = False

    @classmethod
    def load(cls, path: str, mesh: Optional[Mesh] = None, device=None) -> "ShardedHNSWIndex":
        """Open a directory checkpoint (written by either package) on
        `mesh`, by default `make_mesh(n_shards, device)`."""
        from vss_tpu_torch.storage.serialize import load_index

        with open(os.path.join(path, "sharded.json")) as f:
            meta = json.load(f)
        n_shards = int(meta["n_shards"])
        self = cls.from_shards(
            HNSWConfig(**meta["config"]), n_shards, mesh, device,
            lambda s, dev: load_index(os.path.join(path, f"shard_{s}.vss"), device=dev))
        return self

    @classmethod
    def from_shards(cls, config: HNSWConfig, n_shards: int, mesh: Optional[Mesh], device,
                    open_shard) -> "ShardedHNSWIndex":
        """An index from per-shard HNSWIndexes: `open_shard(s, device)`
        returns shard s on `device` (the slot's, or the CPU for the shards
        of other ranks, whose bookkeeping alone is kept)."""
        mesh = mesh or make_mesh(n_shards, device=device)
        if mesh.size != n_shards:
            raise ValueError(f"checkpoint has {n_shards} shards; mesh has {mesh.size} slots")
        self = cls(config, mesh)
        local = set(self._local)
        locals_ = [open_shard(s, mesh.devices[s] if s in local else "cpu")
                   for s in range(n_shards)]
        self._restack(locals_)
        self._insert_seed = max((l._insert_seed for l in locals_), default=0)
        self._insert_counter = self.count
        return self

    def vacuum(self):
        """No-op, like HNSWIndex.vacuum."""

    def merge(self, other):
        raise NotImplementedError("HNSWIndex::MergeIndexes() not implemented")

    # ------------------------------------------------------------ stats
    def stats(self) -> dict:
        """Aggregated per-level stats across shards (pragma info)."""
        maps = self._shard_maps()
        per_shard = [self._extract_shard(s, maps[s]).stats() for s in range(self.n_shards)]
        agg = {
            "metric": self.config.metric,
            "dimensions": self.config.dims,
            "count": self.count,
            "deleted": self.deleted_count,
            "capacity": sum(p["capacity"] for p in per_shard),
            "connectivity": self.config.m,
            "connectivity_base": self.config.m0,
            "ef_construction": self.config.ef_construction,
            "ef_search": self.config.ef_search,
            "approx_memory_bytes": sum(p["approx_memory_bytes"] for p in per_shard),
            "num_levels": max((p["num_levels"] for p in per_shard), default=0),
            "n_shards": self.n_shards,
            "levels": [],
        }
        for lvl in range(agg["num_levels"]):
            nodes = edges = max_edges = alloc = 0
            for p in per_shard:
                if lvl < len(p["levels"]):
                    nodes += p["levels"][lvl]["nodes"]
                    edges += p["levels"][lvl]["edges"]
                    max_edges += p["levels"][lvl]["max_edges"]
                    alloc += p["levels"][lvl].get("allocated_bytes", 0)
            agg["levels"].append({"level": lvl, "nodes": nodes, "edges": edges,
                                  "max_edges": max_edges, "allocated_bytes": alloc})
        return agg
