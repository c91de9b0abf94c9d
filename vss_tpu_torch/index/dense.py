"""HNSWIndex: the user-facing index object (serving subset).

Reproduces `vss_tpu/index/dense.py`: construction through the native
builder, graph search, the exact-scan serving path, tombstone delete,
and the per-graph-version pivot and norm caches. Deletion clears the
slot's `valid` bit: results exclude it and the graph keeps routing
through it. `insert`, `compact`, `optimize_layout`, `rename`, `clone`
and `stats` are not ported yet (ROADMAP.md, queue A).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from vss_tpu_torch.index.graph import (
    HNSWConfig,
    HNSWGraph,
    check_rowids_int32,
    empty_graph,
)
from vss_tpu_torch.index.native import build_graph_native
from vss_tpu_torch.index.search import hnsw_search
from vss_tpu_torch.ops.distance import Metric
from vss_tpu_torch.ops.scan import scan_topk
from vss_tpu_torch.utils import next_pow2, resolve_device

__all__ = ["HNSWIndex", "rescale_distances"]

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
        # int8 tape: global symmetric quantization scale (tape holds x/scale)
        self.vector_scale = 1.0
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

    # ------------------------------------------------------------- build
    @classmethod
    def build(
        cls,
        vectors,
        config: HNSWConfig,
        rowids: Optional[np.ndarray] = None,
        *,
        seed: int = 0,
        method: str = "auto",
        device=None,
    ) -> "HNSWIndex":
        """Bulk-build over a full vector set (the CREATE INDEX path).

        method: 'native' (multithreaded C++ host builder, all cores,
        nondeterministic interleaving) or 'auto' (the native builder on
        one thread, deterministic, for n <= 8192). The device builders
        'exact' and 'wave' are not ported yet.
        """
        if isinstance(vectors, torch.Tensor):
            vectors = vectors.detach().cpu().numpy()
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
            if n <= 8192:
                method, native_threads = "native", 1  # deterministic
            else:
                method = "exact"
        if method in ("exact", "wave"):
            raise NotImplementedError(
                f"build method '{method}' is not ported yet "
                "(ROADMAP.md queue A items 8-9); use method='native'"
            )
        if method != "native":
            raise ValueError(f"unknown build method '{method}'")
        if config.storage_dtype == "int8":
            # graph-internal values live in scaled units; the scale maps
            # them back for user-visible distances
            idx.vector_scale = float(np.abs(vectors).max()) / 127.0 or 1.0
            vectors = vectors / idx.vector_scale
        graph, upper_used = build_graph_native(
            vectors, config, seed=seed, rowids=rowids,
            n_threads=native_threads, device=idx.device,
        )
        idx.graph = graph
        idx.upper_used = upper_used
        idx.next_slot = n
        idx.rowid_to_slot = {int(r): i for i, r in enumerate(rowids)}
        rr = config.rerank_dtype
        if rr is not None:
            tape = torch.zeros((graph.capacity, config.dims), dtype=rr, device=idx.device)
            tape[:n] = torch.from_numpy(vectors).to(idx.device, rr)
            idx.rerank_tape = tape
        return idx

    # ------------------------------------------------------------- props
    @property
    def count(self) -> int:
        return len(self.rowid_to_slot)

    @property
    def capacity(self) -> int:
        return self.graph.capacity

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
        q = self._queries(queries)
        if self.config.storage_dtype == "int8":
            q = q / self.vector_scale
        # one graph snapshot for the whole call
        g = self.graph
        pivot_slots, pivot_vecs = self.pivots()
        d, slots = hnsw_search(
            g, self.config, q, k, ef=ef, filter_mask=filter_mask,
            expand=expand, assume_all_valid=self.deleted_count == 0,
            pivot_slots=pivot_slots, pivot_vecs=pivot_vecs,
            rerank_tape=self.rerank_tape,
        )
        if self.config.storage_dtype == "int8":
            d = rescale_distances(d, self.vector_scale, self.config.metric)
        return d, self._rowids(g, slots)

    def pivots(self, min_pivots: int = 8):
        """(pivot_slots [P] i32, pivot_vecs [P, d]) for pivot seeding: the
        level >= 1 nodes, a geometric ~count/M sample of the corpus.
        Cached per graph version; (None, None) for graphs too small to
        sample."""
        g = self.graph
        if self._pivot_cache is not None and self._pivot_cache[0] is g:
            return self._pivot_cache[1], self._pivot_cache[2]
        mask = ((g.levels >= 1) & (g.slot_to_rowid >= 0)).cpu().numpy()
        idx = np.nonzero(mask)[0]
        if idx.size < min_pivots:
            self._pivot_cache = (g, None, None)
            return None, None
        slots = np.full(next_pow2(idx.size), -1, np.int32)
        slots[: idx.size] = idx
        slots_t = torch.from_numpy(slots).to(self.device)
        vecs = g.vectors[slots_t.clamp(min=0).long()]
        self._pivot_cache = (g, slots_t, vecs)
        return slots_t, vecs

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
        q = self._queries(queries)
        if self.config.storage_dtype == "int8":
            q = q / self.vector_scale
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
        return len(slots)
