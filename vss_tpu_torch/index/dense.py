"""HNSWIndex: the user-facing index object (CRUD + search + stats).

Reproduces `vss_tpu/index/dense.py`: owns the graph tensors plus the
host-side bookkeeping (rowid <-> slot maps, the free-slot ring recycled
by inserts, upper-row allocation, the dirty flag). Construction goes
through the bulk builder (`index/exact_build.py`), the native builder or
the wave builder; serving through the graph search and the exact scan,
with the per-graph-version pivot and norm caches.

Deletion is a tombstone: the slot's `valid` bit clears, results exclude
it, the graph keeps routing through it, and the slot is recycled by the
next insert. `compact()` rewrites the tensors without tombstones.

Every method publishes a NEW `HNSWGraph` object and leaves the tensors
of the old one as they were, so a search that took its snapshot of
`self.graph` is not disturbed and the caches, keyed on the graph's
identity, stay exact. `insert` clones the graph once, updates that copy
in place wave by wave and publishes it at its end. Whole-row gathers
(compaction's permutation of the tapes, the pivot sample, the layout's
cluster assignment) go through kernel K5 (`ops/gather.gather_rows`).

While the torch profiler runs, `search` and `scan_search` record the
spans `vss.search` and `vss.scan` with their phases inside
(`utils/trace.py`): the queries' intake (the copy to the device and the
int8 scale), then `vss.search.pivots` and the phases of `hnsw_search`,
or those of `scan_topk`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from vss_tpu_torch.index.build import (
    _insert_wave_core,
    build_graph_batched,
    plan_wave_rows,
)
from vss_tpu_torch.index.graph import (
    HNSWConfig,
    HNSWGraph,
    check_rowids_int32,
    empty_graph,
    grow_graph,
    sample_levels,
)
from vss_tpu_torch.index.native import build_graph_native, native_available
from vss_tpu_torch.index.search import hnsw_search
from vss_tpu_torch.ops.distance import Metric
from vss_tpu_torch.ops.gather import gather_rows
from vss_tpu_torch.ops.scan import scan_topk
from vss_tpu_torch.ops.topk import bruteforce_topk
from vss_tpu_torch.utils import next_pow2, resolve_device
from vss_tpu_torch.utils.trace import span

__all__ = ["HNSWIndex", "graph_pivots", "pivot_rows", "rescale_distances"]

_RESERVE = 8  # tail slots reserved (scatter sink + padding headroom)


def rescale_distances(d, scale: float, metric):
    """Map scaled-unit index distances back to real units (int8 tape).
    l2sq scales by s^2; cosine is scale-invariant; the internal ip form
    1 - dot maps via dot_real = (1 - d) * s^2."""
    m = Metric.parse(metric)
    s = scale
    if m == Metric.L2SQ:
        return d * (s * s)
    if m == Metric.IP:
        return 1.0 - (1.0 - d) * (s * s)
    return d


class HNSWIndex:
    """A single-shard HNSW index over fixed-dimension float vectors, on
    one device (CUDA unless `device="cpu"` is passed)."""

    supports_filter_pushdown = True

    def __init__(self, config: HNSWConfig, capacity: int = 1024, device=None):
        self.config = config
        self.device = resolve_device(device)
        capacity = max(capacity, 64)
        self.graph: HNSWGraph = empty_graph(config, capacity, device=self.device)
        self.upper_used = 0
        self.next_slot = 0  # high-water mark of ever-assigned slots
        self.free_slots: list[int] = []
        self.rowid_to_slot: dict[int, int] = {}
        self.deleted_count = 0
        self.dirty = False
        self._insert_seed = 0
        # int8 tape: global symmetric quantization scale (tape holds x/scale)
        self.vector_scale = 1.0
        # scale-drift guard: the scale is frozen at build time, so inserts
        # from a shifted distribution would silently saturate at +-127.
        # Track the max |value| ever seen (real units) and count
        # out-of-range insert rows; compact() requantizes from the f32
        # rerank side tape when drift was flagged (see stats()["quantization"])
        self.scale_max_abs = 0.0
        self.scale_overflow = 0
        # optional full-precision side tape [cap, d] (scaled units)
        rr = config.rerank_dtype
        self.rerank_tape: Optional[torch.Tensor] = (
            None if rr is None
            else torch.zeros((capacity, config.dims), dtype=rr, device=self.device)
        )
        # per-graph-version caches; the first element is the graph they
        # were computed from
        self._pivot_cache: Optional[tuple] = None
        self._norms_cache: Optional[tuple] = None
        # what the exact builder reports: its candidate mode, and in
        # 'hybrid' the sampled list recall and whether the scan pass ran
        self.build_stats: dict = {}

    # ------------------------------------------------------------- build
    @classmethod
    def build(
        cls,
        vectors,
        config: HNSWConfig,
        rowids: Optional[np.ndarray] = None,
        *,
        seed: int = 0,
        wave_size: int = 1024,
        efc: Optional[int] = None,
        expand: int = 4,
        method: str = "auto",
        progress=None,
        device=None,
    ) -> "HNSWIndex":
        """Bulk-build over a full vector set (the CREATE INDEX path).

        method: 'exact' (bulk construction from kNN candidate lists on the
        device, `index/exact_build.py`), 'wave' (batched incremental
        construction on the device, `index/build.py`), 'native'
        (multithreaded C++ host builder, all cores, nondeterministic
        interleaving) or 'auto': the native builder on one thread
        (deterministic) for n <= 8192 where it builds and loads, 'exact'
        otherwise. `vectors` may be a
        tensor: the exact builder keeps it on its device.
        """
        on_device = isinstance(vectors, torch.Tensor)
        if not on_device:
            vectors = np.asarray(vectors, np.float32)
        n = vectors.shape[0]
        idx = cls(config, capacity=64, device=device)
        if n == 0:
            return idx
        if rowids is None:
            rowids = np.arange(n, dtype=np.int64)
        rowids = np.asarray(rowids)
        check_rowids_int32(rowids)
        native_threads = 0
        if method == "auto":
            if n <= 8192 and native_available():
                method, native_threads = "native", 1  # deterministic
            else:
                method = "exact"
        if method not in ("native", "wave", "exact"):
            raise ValueError(f"unknown build method '{method}'")
        scale = 1.0
        if config.storage_dtype == "int8":
            # graph-internal values live in scaled units; the scale maps
            # them back for user-visible distances
            idx.scale_max_abs = float(
                vectors.abs().max() if on_device else np.abs(vectors).max())
            idx.vector_scale = idx.scale_max_abs / 127.0 or 1.0
            scale = idx.vector_scale
        if method == "exact":
            from vss_tpu_torch.index.exact_build import build_graph_exact

            # the vectors go unscaled: the divide happens in the tape cast,
            # and the side tape comes from the builder's own device copy
            graph, upper_used, rtape = build_graph_exact(
                vectors, config, seed=seed, rowids=rowids.astype(np.int32),
                progress=progress, want_rerank=True, prescale=scale, device=idx.device,
                stats=idx.build_stats,
            )
            idx.rerank_tape = rtape
        else:
            if on_device:
                vectors = vectors.detach().cpu().numpy().astype(np.float32)
            if scale != 1.0:
                vectors = vectors / scale
            if method == "native":
                graph, upper_used = build_graph_native(
                    vectors, config, seed=seed, rowids=rowids,
                    n_threads=native_threads, device=idx.device,
                )
            else:
                graph, upper_used = build_graph_batched(
                    vectors, config, seed=seed, wave_size=wave_size,
                    rowids=rowids.astype(np.int32), efc=efc, expand=expand,
                    progress=progress, device=idx.device,
                )
            rr = config.rerank_dtype
            if rr is not None:
                tape = torch.zeros((graph.capacity, config.dims), dtype=rr, device=idx.device)
                tape[:n] = torch.from_numpy(vectors).to(idx.device, rr)
                idx.rerank_tape = tape
        idx.graph = graph
        idx.upper_used = upper_used
        idx.next_slot = n
        idx.rowid_to_slot = {int(r): i for i, r in enumerate(rowids)}
        idx._insert_seed = n
        idx.dirty = True
        return idx

    # ------------------------------------------------------------- props
    @property
    def count(self) -> int:
        return len(self.rowid_to_slot)

    @property
    def capacity(self) -> int:
        return self.graph.capacity

    @property
    def usable_capacity(self) -> int:
        return self.graph.capacity - _RESERVE

    @property
    def dims(self) -> int:
        return self.config.dims

    @property
    def metric(self) -> Metric:
        return Metric.parse(self.config.metric)

    def _queries(self, queries) -> torch.Tensor:
        q = torch.as_tensor(np.asarray(queries, np.float32)) if not isinstance(
            queries, torch.Tensor) else queries
        q = q.to(self.device, torch.float32)
        return q[None, :] if q.dim() == 1 else q

    def _scaled_queries(self, queries) -> torch.Tensor:
        """The queries on the index's device in the tape's units (divided
        by the int8 scale)."""
        q = self._queries(queries)
        return q / self.vector_scale if self.config.storage_dtype == "int8" else q

    def _rowids(self, g: HNSWGraph, slots: torch.Tensor) -> torch.Tensor:
        return torch.where(slots >= 0, g.slot_to_rowid[slots.clamp(min=0).long()], -1)

    # ------------------------------------------------------------- search
    def search(
        self,
        queries,
        k: int,
        ef: Optional[int] = None,
        filter_mask: Optional[torch.Tensor] = None,
        expand: int = 1,
    ):
        """k-NN search. Returns (dists [B, k] f32 ascending, rowids [B, k]
        int32, -1 past the end), on the index's device."""
        with span("vss.search"):
            with span("vss.search.intake"):
                q = self._scaled_queries(queries)
            # one graph snapshot for the whole call
            g = self.graph
            with span("vss.search.pivots"):
                pivot_slots, pivot_vecs, pivot_norms = self._pivot_sample()
            d, slots = hnsw_search(
                g, self.config, q, k, ef=ef, filter_mask=filter_mask,
                expand=expand, assume_all_valid=self.deleted_count == 0,
                pivot_slots=pivot_slots, pivot_vecs=pivot_vecs, pivot_norms=pivot_norms,
                rerank_tape=self.rerank_tape,
            )
            if self.config.storage_dtype == "int8":
                d = rescale_distances(d, self.vector_scale, self.config.metric)
            return d, self._rowids(g, slots)

    def pivots(self, min_pivots: int = 8):
        """(pivot_slots [P] i32, pivot_vecs [P, d] f32, pivot_norms [P]) for
        pivot seeding: the level >= 1 nodes, a geometric ~count/M sample of
        the corpus, their rows and squared norms. The rows are the f32 copy,
        made on each call, of those the cache keeps in the tape's dtype
        (`_pivot_sample`, which the search reads); (None, None, None) for
        graphs too small to sample."""
        slots, rows, norms = self._pivot_sample(min_pivots)
        return slots, None if rows is None else rows.float(), norms

    def _pivot_sample(self, min_pivots: int = 8):
        """The pivots as the search seeds from them (`pivot_rows`: slots,
        rows in the tape's dtype, squared norms), cached per graph
        version. Each new sample records
        its pivot count, real and padded to a power of two, in
        `build_stats["pivots"]`."""
        g = self.graph
        if self._pivot_cache is None or self._pivot_cache[0] is not g:
            slots, rows = graph_pivots(g, min_pivots)
            self._pivot_cache = (g, *pivot_rows(slots, rows))
            if slots is not None:
                self.build_stats["pivots"] = {"real": int((slots >= 0).sum()),
                                              "padded": int(slots.shape[0])}
        return self._pivot_cache[1:]

    def norms(self):
        """Squared-norm tape [cap] f32 of the stored values, cached per
        graph version; None for ip."""
        g = self.graph
        if self._norms_cache is not None and self._norms_cache[0] is g:
            return self._norms_cache[1]
        n = None
        if self.metric != Metric.IP:
            xv = g.vectors.float()
            n = (xv * xv).sum(-1)
        self._norms_cache = (g, n)
        return n

    def scan_search(
        self,
        queries,
        k: int,
        filter_mask: Optional[torch.Tensor] = None,
    ):
        """Exact-scan serving path (`ops/scan.scan_topk`): one storage-
        native pass over the tape and an exact f32 rerank (distances exact
        with respect to the rerank tape when one exists). Returns (dists
        [B, k] f32, rowids [B, k], -1 pad) like search(). keep = 2k: the
        wider winnow margin of the exact-scan operator."""
        with span("vss.scan"):
            with span("vss.scan.intake"):
                q = self._scaled_queries(queries)
            g = self.graph
            allow = g.valid
            if filter_mask is not None:
                allow = allow & filter_mask.to(self.device)
            d, slots = scan_topk(
                q, g.vectors, k, self.config.metric, valid_mask=allow,
                x_norms=self.norms(), rerank_tape=self.rerank_tape, keep=2 * k,
                device=self.device,
            )
            if self.config.storage_dtype == "int8":
                d = rescale_distances(d, self.vector_scale, self.config.metric)
            return d, self._rowids(g, slots)

    def slot_rowid_array(self) -> np.ndarray:
        """slot -> rowid tape, host copy (filtered-search mask surface)."""
        return self.graph.slot_to_rowid.cpu().numpy()

    # ------------------------------------------------------------- insert
    def _ensure_capacity(self, extra_slots: int, extra_upper: int):
        need = self.next_slot - len(self.free_slots) + extra_slots + _RESERVE
        new_cap = self.graph.capacity
        while new_cap < need:
            new_cap *= 2
        need_upper = self.upper_used + extra_upper + 1
        new_upper = self.graph.upper_capacity
        while new_upper < need_upper:
            new_upper *= 2
        if new_cap != self.graph.capacity or new_upper != self.graph.upper_capacity:
            self.graph = grow_graph(self.graph, self.config, new_cap, new_upper)
            if self.rerank_tape is not None:
                pad = new_cap - self.rerank_tape.shape[0]
                if pad > 0:
                    self.rerank_tape = torch.cat([
                        self.rerank_tape,
                        self.rerank_tape.new_zeros((pad, self.config.dims)),
                    ])

    def insert(self, vectors, rowids: Sequence[int]):
        """Insert vectors with user row ids (the INSERT/Append path).
        Tombstoned slots are recycled before new slots are claimed. The
        graph is cloned once, the waves update that copy in place, and it
        is published as `self.graph` when the last wave is in."""
        if isinstance(vectors, torch.Tensor):
            vectors = vectors.detach().cpu().numpy()
        vectors = np.asarray(vectors, np.float32)
        if vectors.ndim == 1:
            vectors = vectors[None, :]
        if self.config.storage_dtype == "int8":
            # out-of-range values clip in-wave; record the drift so
            # stats() can surface it and compact() can requantize
            if vectors.size:
                mx_rows = np.abs(vectors).max(axis=1)
                self.scale_max_abs = max(self.scale_max_abs, float(mx_rows.max()))
                self.scale_overflow += int((mx_rows > self.vector_scale * 127.0).sum())
            vectors = vectors / self.vector_scale
        rowids = np.asarray(rowids, np.int64)
        check_rowids_int32(rowids)
        n = vectors.shape[0]
        if n == 0:
            return
        for r in rowids:
            if int(r) in self.rowid_to_slot:
                raise ValueError(f"duplicate rowid {int(r)}")
        levels = sample_levels(n, self.config, seed=self._insert_seed)
        self._insert_seed += n
        self._ensure_capacity(n, int(levels.sum()))
        # assign slots: recycle tombstones first (free ring), then extend
        slots = np.empty(n, np.int64)
        reuse = min(len(self.free_slots), n)
        for i in range(reuse):
            slots[i] = self.free_slots.pop()
        if reuse < n:
            fresh = n - reuse
            slots[reuse:] = np.arange(self.next_slot, self.next_slot + fresh)
            self.next_slot += fresh
        # recycled slots stop being tombstones
        self.deleted_count -= reuse
        if self.rerank_tape is not None:
            tape = self.rerank_tape.clone()
            tape[torch.from_numpy(slots).to(self.device)] = (
                torch.from_numpy(vectors).to(self.device, tape.dtype))
            self.rerank_tape = tape
        g = self.graph.clone()
        # waves (bucketed shapes, as the JAX package cuts them)
        pos = 0
        while pos < n:
            W = next_pow2(n - pos, cap=1024)
            cnt = min(W, n - pos)
            wv = np.zeros((W, self.config.dims), np.float32)
            wv[:cnt] = vectors[pos : pos + cnt]
            sl = np.zeros(W, np.int32)
            sl[:cnt] = slots[pos : pos + cnt]
            # padding rows must scatter to unused slots: point them at
            # reserved tail slots (never searched, never linked)
            if cnt < W:
                sl[cnt:] = g.capacity - _RESERVE + (np.arange(W - cnt) % (_RESERVE - 1))
            lv = np.zeros(W, np.int32)
            lv[:cnt] = levels[pos : pos + cnt]
            urows, self.upper_used = plan_wave_rows(lv, self.upper_used, self.config.max_levels)
            rid = np.full(W, -1, np.int32)
            rid[:cnt] = rowids[pos : pos + cnt].astype(np.int32)
            g = _insert_wave_core(
                g, self.config, wv, sl, lv, urows, rid, np.arange(W) < cnt,
                self.config.ef_construction, 4, min(self.config.m, W),
            )
            for i in range(cnt):
                self.rowid_to_slot[int(rowids[pos + i])] = int(sl[i])
            pos += cnt
        self.graph = g
        self.dirty = True

    # ------------------------------------------------------------- delete
    def delete(self, rowids: Sequence[int]) -> int:
        """Tombstone rows. Returns the number actually deleted."""
        slots = []
        for r in rowids:
            s = self.rowid_to_slot.pop(int(r), None)
            if s is not None:
                slots.append(s)
        if not slots:
            return 0
        valid = self.graph.valid.clone()
        valid[torch.as_tensor(slots, dtype=torch.long, device=self.device)] = False
        self.graph = dataclasses.replace(
            self.graph, valid=valid, count=self.graph.count - len(slots)
        )
        self.free_slots.extend(slots)
        self.deleted_count += len(slots)
        self.dirty = True
        return len(slots)

    # ------------------------------------------------------------- compact
    def compact(self):
        """Rewrite the graph without tombstones.

        Host-side permutation of the int adjacency arrays; the (large)
        vector tapes are permuted on the device (kernel K5). Edges into
        removed slots are dropped."""
        requantized = self._requantize_if_drifted()
        if self.deleted_count == 0 and not self.free_slots:
            if requantized:
                self.dirty = True
            return
        kept = np.flatnonzero(self.graph.valid.cpu().numpy())
        self._apply_slot_permutation(kept)

    def _requantize_if_drifted(self) -> bool:
        """Requantize the int8 tape from the f32 rerank side tape when
        inserts overflowed the build-time scale (scale-drift guard).
        Lossless for all stored values: the rerank tape holds the
        unclipped scaled f32 vectors."""
        if (
            self.config.storage_dtype != "int8"
            or self.scale_overflow == 0
            or self.rerank_tape is None
        ):
            return False
        new_scale = self.scale_max_abs / 127.0
        if new_scale <= self.vector_scale:
            self.scale_overflow = 0
            return False
        ratio = self.vector_scale / new_scale
        rt = (self.rerank_tape * ratio).to(self.rerank_tape.dtype)
        q = torch.clamp(torch.round(rt), -127, 127).to(torch.int8)
        self.graph = dataclasses.replace(self.graph, vectors=q)
        self.rerank_tape = rt
        self.vector_scale = new_scale
        self.scale_overflow = 0
        self.dirty = True
        return True

    def optimize_layout(self, n_clusters: int = 1024, seed: int = 0):
        """Reorder slots so near neighbors sit adjacently in memory.
        Assigns every live vector to its nearest of `n_clusters` sampled
        vectors and permutes slots into cluster order. Improves gather
        locality for large graphs."""
        live = np.flatnonzero(self.graph.valid.cpu().numpy())
        if live.size == 0:
            return
        rng = np.random.default_rng(seed)
        n_clusters = int(min(n_clusters, live.size))
        centers_idx = rng.choice(live, n_clusters, replace=False)

        def rows(slots):
            ids = torch.from_numpy(slots.astype(np.int32)).to(self.device)
            return gather_rows(self.graph.vectors, ids).float()

        centers = rows(centers_idx)
        assign = np.empty(live.size, np.int32)
        CH = 8192
        for s in range(0, live.size, CH):
            _, ids = bruteforce_topk(
                rows(live[s : s + CH]), centers, 1, self.config.metric, device=self.device)
            assign[s : s + CH] = ids[:, 0].cpu().numpy()
        order = np.argsort(assign, kind="stable")
        self._apply_slot_permutation(live[order])

    def _apply_slot_permutation(self, kept_in_order: np.ndarray):
        """Rebuild the graph with slots laid out as `kept_in_order` (old
        slot ids in their new order); everything not listed is dropped."""
        cfg = self.config
        dev = self.device
        levels = self.graph.levels.cpu().numpy()
        rowids = self.graph.slot_to_rowid.cpu().numpy()
        adj0 = self.graph.adj0.cpu().numpy()
        upper_adj = self.graph.upper_adj.cpu().numpy()
        upper_row = self.graph.upper_row.cpu().numpy()

        kept = np.asarray(kept_in_order, np.int64)
        n_new = kept.size
        cap = self.graph.capacity
        slot_map = np.full(cap, -1, np.int64)
        slot_map[kept] = np.arange(n_new)

        def remap(a):
            out = np.where(a >= 0, slot_map[np.maximum(a, 0)], -1)
            return out.astype(np.int32)

        new_adj0 = np.full((cap, cfg.m0), -1, np.int32)
        new_adj0[:n_new] = _compact_rows(remap(adj0[kept]))
        # upper rows: reassign compactly in kept order
        kept_levels = levels[kept]
        new_upper_cap = self.graph.upper_capacity
        new_upper_adj = np.full((new_upper_cap, cfg.m), -1, np.int32)
        new_upper_row = np.full((cap, cfg.max_levels), -1, np.int32)
        next_row = 0
        uppers = np.flatnonzero(kept_levels > 0)
        for i_new in uppers:
            old = kept[i_new]
            for l in range(1, int(levels[old]) + 1):
                src = upper_row[old, l - 1]
                if src >= 0:
                    new_upper_adj[next_row] = _compact_rows(
                        remap(upper_adj[src][None, :])
                    )[0]
                new_upper_row[i_new, l - 1] = next_row
                next_row += 1

        new_levels = np.zeros(cap, np.int32)
        new_levels[:n_new] = kept_levels
        new_valid = np.zeros(cap, bool)
        new_valid[:n_new] = True
        new_rowids = np.full(cap, -1, np.int32)
        new_rowids[:n_new] = rowids[kept]
        # entry: highest-level kept node (first in kept order on ties)
        if n_new:
            lv_max = int(kept_levels.max())
            entry = int(np.flatnonzero(kept_levels == lv_max)[0])
        else:
            lv_max, entry = -1, -1
        perm = torch.from_numpy(
            np.concatenate([kept, np.zeros(cap - n_new, np.int64)]).astype(np.int32)
        ).to(dev)
        # the gathered tapes are new tensors: zero their tail by assignment
        # (a `where` against 0.0 would promote an int8 tape)
        new_vectors = gather_rows(self.graph.vectors, perm)
        new_vectors[n_new:] = 0
        if self.rerank_tape is not None:
            rt = gather_rows(self.rerank_tape, perm)
            rt[n_new:] = 0
            self.rerank_tape = rt

        def t(a):
            return torch.from_numpy(a).to(dev)

        def i32(v):
            return torch.tensor(v, dtype=torch.int32, device=dev)

        self.graph = HNSWGraph(
            vectors=new_vectors,
            adj0=t(new_adj0),
            upper_adj=t(new_upper_adj),
            upper_row=t(new_upper_row),
            levels=t(new_levels),
            valid=t(new_valid),
            slot_to_rowid=t(new_rowids),
            entry=i32(entry),
            max_level=i32(lv_max),
            count=i32(n_new),
        )
        self.upper_used = next_row
        self.next_slot = n_new
        self.free_slots = []
        self.deleted_count = 0
        self.rowid_to_slot = {int(r): i for i, r in enumerate(rowids[kept])}
        self.dirty = True

    # ------------------------------------------------------------- misc
    def rename(self, old_rowid: int, new_rowid: int) -> bool:
        """Re-key a row."""
        slot = self.rowid_to_slot.pop(int(old_rowid), None)
        if slot is None:
            return False
        if int(new_rowid) in self.rowid_to_slot:
            self.rowid_to_slot[int(old_rowid)] = slot
            raise ValueError(f"rowid {int(new_rowid)} already exists")
        self.rowid_to_slot[int(new_rowid)] = slot
        slot_to_rowid = self.graph.slot_to_rowid.clone()
        slot_to_rowid[slot] = int(np.int32(new_rowid))
        self.graph = dataclasses.replace(self.graph, slot_to_rowid=slot_to_rowid)
        self.dirty = True
        return True

    def vacuum(self):
        """No-op: space reclamation happens via compact()."""

    def merge(self, other: "HNSWIndex"):
        """Unimplemented, as in the JAX package."""
        raise NotImplementedError("HNSWIndex::MergeIndexes() not implemented")

    def clone(self) -> "HNSWIndex":
        """Cheap copy. The tensors are shared: every method of the index
        publishes new tensors and never writes into published ones. The
        host bookkeeping is deep-copied."""
        other = HNSWIndex(self.config, capacity=64, device=self.device)
        other.graph = self.graph
        other.rerank_tape = self.rerank_tape
        other.vector_scale = self.vector_scale
        other.scale_max_abs = self.scale_max_abs
        other.scale_overflow = self.scale_overflow
        other.upper_used = self.upper_used
        other.next_slot = self.next_slot
        other.free_slots = list(self.free_slots)
        other.rowid_to_slot = dict(self.rowid_to_slot)
        other.deleted_count = self.deleted_count
        other.dirty = self.dirty
        other._insert_seed = self._insert_seed
        return other

    # ------------------------------------------------------------- stats
    def stats(self) -> dict:
        """Per-level stats of the index."""
        valid = self.graph.valid.cpu().numpy()
        levels = self.graph.levels.cpu().numpy()
        adj0 = self.graph.adj0.cpu().numpy()
        upper_row = self.graph.upper_row.cpu().numpy()
        upper_adj = self.graph.upper_adj.cpu().numpy()
        n_levels = int(levels[valid].max()) + 1 if valid.any() else 0
        per_level = []
        row_bytes = self.config.dims * self.graph.vectors.element_size()
        for l in range(n_levels):
            members = np.flatnonzero(valid & (levels >= l))
            if l == 0:
                edges = int((adj0[members] >= 0).sum())
                max_edges = members.size * self.config.m0
                # per-node footprint at the base layer: adjacency row +
                # vector row + per-slot bookkeeping (valid/levels/rowid/
                # upper_row)
                alloc = int(members.size) * (
                    self.config.m0 * 4 + row_bytes + 1 + 4 + 4
                    + 4 * self.config.max_levels
                )
            else:
                rows = upper_row[members, l - 1]
                rows = rows[rows >= 0]
                edges = int((upper_adj[rows] >= 0).sum())
                max_edges = members.size * self.config.m
                alloc = int(rows.size) * self.config.m * 4
            per_level.append(
                {"level": l, "nodes": int(members.size), "edges": edges,
                 "max_edges": max_edges, "allocated_bytes": alloc}
            )
        bytes_graph = sum(
            t.numel() * t.element_size()
            for t in (getattr(self.graph, f.name) for f in dataclasses.fields(self.graph))
        )
        return {
            "metric": self.metric.value,
            "dimensions": self.config.dims,
            "count": self.count,
            "deleted": self.deleted_count,
            "capacity": self.usable_capacity,
            "connectivity": self.config.m,
            "connectivity_base": self.config.m0,
            "ef_construction": self.config.ef_construction,
            "ef_search": self.config.ef_search,
            "approx_memory_bytes": bytes_graph,
            "num_levels": n_levels,
            "levels": per_level,
            "quantization": {
                "scale": self.vector_scale,
                "max_abs_seen": self.scale_max_abs,
                "out_of_range_inserts": self.scale_overflow,
                "scale_drift": self.scale_overflow > 0,
            },
        }


def graph_pivots(g: HNSWGraph, min_pivots: int = 8):
    """(pivot_slots [P] i32, pivot_vecs [P, d]) of a graph: its level >= 1
    nodes, padded with -1 to a power of two, and their rows (kernel K5);
    (None, None) when it has fewer than `min_pivots`."""
    mask = ((g.levels >= 1) & (g.slot_to_rowid >= 0)).cpu().numpy()
    idx = np.nonzero(mask)[0]
    if idx.size < min_pivots:
        return None, None
    slots = np.full(next_pow2(idx.size), -1, np.int32)
    slots[: idx.size] = idx
    slots_t = torch.from_numpy(slots).to(g.device)
    return slots_t, gather_rows(g.vectors, slots_t)


def pivot_rows(pivot_slots, pivot_vecs):
    """The pivots as the search seeds from them: (pivot_slots, their rows
    as given, the tape's in its dtype, which the `pivot_product` kernel
    reads, and their squared norms in f32), the norms computed once per
    pivot sample with the ops `pivot_seeds` runs on every batch, so the
    bits are the same; (None, None, None) without pivots."""
    if pivot_slots is None:
        return None, None, None
    pv = pivot_vecs.float()
    return pivot_slots, pivot_vecs, (pv * pv).sum(-1)


def _compact_rows(rows: np.ndarray) -> np.ndarray:
    """Shift -1 holes in adjacency rows to the tail (keep order otherwise)."""
    order = np.argsort(rows < 0, axis=1, kind="stable")
    return np.take_along_axis(rows, order, axis=1)
