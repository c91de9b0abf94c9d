"""Host-side sequential HNSW construction (NumPy).

Reproduces `vss_tpu/index/host_build.py:34-229`: an independent
implementation of the classic HNSW insertion algorithm (Malkov &
Yashunin 2016): greedy descent, ef_construction beam per level, the
select-neighbors heuristic, and back-link pruning. It is (a) the trusted
small-scale builder that the batched wave builder is validated against,
and (b) a build path for tiny tables. The builder is the same NumPy code
as the JAX package's; `host_graph_to_device` packs its result into the
port's `HNSWGraph` on an explicit device.

Pure NumPy + heapq; O(n * ef * log) on host. Use the batched wave builder
(`vss_tpu_torch.index.build`) for anything big.
"""
from __future__ import annotations

import heapq
from typing import Optional

import numpy as np
import torch

from vss_tpu_torch.index.graph import (
    HNSWConfig,
    HNSWGraph,
    cast_to_tape,
    sample_levels,
)
from vss_tpu_torch.ops.distance import Metric
from vss_tpu_torch.utils import resolve_device

__all__ = ["HostGraph", "build_host_graph", "host_graph_to_device"]


def _dist_many(metric: Metric, q: np.ndarray, xs: np.ndarray) -> np.ndarray:
    q = q.astype(np.float32)
    xs = xs.astype(np.float32)
    dots = xs @ q
    if metric == Metric.L2SQ:
        return np.maximum((xs * xs).sum(-1) + (q * q).sum() - 2 * dots, 0.0)
    if metric == Metric.COSINE:
        qn = np.sqrt((q * q).sum())
        xn = np.sqrt((xs * xs).sum(-1))
        denom = qn * xn
        with np.errstate(invalid="ignore", divide="ignore"):
            cos = np.where(denom > 0, dots / np.where(denom > 0, denom, 1.0), 0.0)
        d = 1.0 - cos
        return np.where((qn == 0) & (xn == 0), 0.0, d)
    if metric == Metric.IP:
        return 1.0 - dots
    raise ValueError(metric)


class HostGraph:
    """Adjacency lists on host; mirrors HNSWGraph's logical content."""

    def __init__(self, config: HNSWConfig, capacity: int):
        self.config = config
        self.vectors = np.zeros((capacity, config.dims), np.float32)
        self.levels = np.zeros(capacity, np.int32)
        # neighbors[level][slot] -> list of slots; level 0 capped at m0.
        self.neighbors: list[dict[int, list[int]]] = [
            {} for _ in range(config.max_levels + 1)
        ]
        self.entry = -1
        self.max_level = -1
        self.n = 0
        self.metric = Metric.parse(config.metric)

    def _search_layer(self, q: np.ndarray, entry: int, ef: int, level: int):
        """Beam search on one layer; returns [(dist, slot)] ascending."""
        d0 = float(_dist_many(self.metric, q, self.vectors[entry : entry + 1])[0])
        visited = {entry}
        cand = [(d0, entry)]  # min-heap
        best = [(-d0, entry)]  # max-heap of up to ef results
        while cand:
            d, u = heapq.heappop(cand)
            if d > -best[0][0] and len(best) >= ef:
                break
            neigh = [v for v in self.neighbors[level].get(u, []) if v not in visited]
            if not neigh:
                continue
            visited.update(neigh)
            nd = _dist_many(self.metric, q, self.vectors[neigh])
            for dv, v in zip(nd, neigh):
                dv = float(dv)
                if len(best) < ef or dv < -best[0][0]:
                    heapq.heappush(cand, (dv, v))
                    heapq.heappush(best, (-dv, v))
                    if len(best) > ef:
                        heapq.heappop(best)
        out = sorted((-nd, v) for nd, v in best)
        return out

    def _select_heuristic(self, q: np.ndarray, cand: list, m: int):
        """Select-neighbors heuristic: keep c iff c is closer to q than to
        any already-kept neighbor; fill remaining slots from pruned."""
        cand = sorted(cand)
        kept: list[tuple[float, int]] = []
        pruned: list[tuple[float, int]] = []
        for d, c in cand:
            if len(kept) >= m:
                break
            ok = True
            if kept:
                kept_ids = [k for _, k in kept]
                dck = _dist_many(self.metric, self.vectors[c], self.vectors[kept_ids])
                ok = bool(np.all(d < dck))
            (kept if ok else pruned).append((d, c))
        for p in pruned:
            if len(kept) >= m:
                break
            kept.append(p)
        return [c for _, c in sorted(kept)]

    def insert(self, slot: int, vec: np.ndarray, level: int):
        self.vectors[slot] = vec
        self.levels[slot] = level
        cfg = self.config
        for lv in range(level + 1):
            self.neighbors[lv][slot] = []
        if self.entry < 0:
            self.entry = slot
            self.max_level = level
            self.n += 1
            return
        # greedy descent to level+1
        cur = self.entry
        cur_d = float(_dist_many(self.metric, vec, self.vectors[cur : cur + 1])[0])
        for lv in range(self.max_level, level, -1):
            improved = True
            while improved:
                improved = False
                neigh = self.neighbors[lv].get(cur, [])
                if neigh:
                    nd = _dist_many(self.metric, vec, self.vectors[neigh])
                    j = int(np.argmin(nd))
                    if nd[j] < cur_d:
                        cur, cur_d = neigh[j], float(nd[j])
                        improved = True
        # per-level beam + connect
        ep = cur
        for lv in range(min(level, self.max_level), -1, -1):
            cand = self._search_layer(vec, ep, cfg.ef_construction, lv)
            m = cfg.m0 if lv == 0 else cfg.m
            chosen = self._select_heuristic(vec, cand, cfg.m)
            self.neighbors[lv][slot] = list(chosen)
            for v in chosen:
                lst = self.neighbors[lv].setdefault(v, [])
                lst.append(slot)
                if len(lst) > m:
                    dvs = _dist_many(self.metric, self.vectors[v], self.vectors[lst])
                    self.neighbors[lv][v] = self._select_heuristic(
                        self.vectors[v], list(zip(dvs.tolist(), lst)), m
                    )
            ep = cand[0][1] if cand else ep
        if level > self.max_level:
            self.max_level = level
            self.entry = slot
        self.n += 1


def build_host_graph(
    vectors: np.ndarray,
    config: HNSWConfig,
    seed: int = 0,
    levels: Optional[np.ndarray] = None,
) -> HostGraph:
    n = vectors.shape[0]
    if levels is None:
        levels = sample_levels(n, config, seed)
    g = HostGraph(config, n)
    for i in range(n):
        g.insert(i, vectors[i].astype(np.float32), int(levels[i]))
    return g


def host_graph_to_device(
    g: HostGraph,
    rowids: Optional[np.ndarray] = None,
    capacity: Optional[int] = None,
    device=None,
) -> HNSWGraph:
    """Pack a HostGraph into the flat tensors, on `device` (CUDA unless
    "cpu" is passed)."""
    dev = resolve_device(device)
    cfg = g.config
    n = g.vectors.shape[0]
    cap = capacity or n
    n_upper_rows = int(sum(int(lv) for lv in g.levels[:n]))
    upper_cap = max(64, n_upper_rows)
    adj0 = np.full((cap, cfg.m0), -1, np.int32)
    upper_adj = np.full((upper_cap, cfg.m), -1, np.int32)
    upper_row = np.full((cap, cfg.max_levels), -1, np.int32)
    next_row = 0
    for slot in range(n):
        lst = g.neighbors[0].get(slot, [])[: cfg.m0]
        adj0[slot, : len(lst)] = lst
        for lv in range(1, int(g.levels[slot]) + 1):
            upper_row[slot, lv - 1] = next_row
            lst = g.neighbors[lv].get(slot, [])[: cfg.m]
            upper_adj[next_row, : len(lst)] = lst
            next_row += 1
    if rowids is None:
        rowids = np.arange(n, dtype=np.int32)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    return HNSWGraph(
        vectors=cast_to_tape(
            t(np.concatenate([g.vectors[:n], np.zeros((cap - n, cfg.dims), np.float32)])),
            cfg,
        ),
        adj0=t(adj0),
        upper_adj=t(upper_adj),
        upper_row=t(upper_row),
        levels=t(np.concatenate([g.levels[:n], np.zeros(cap - n, np.int32)])),
        valid=t(np.concatenate([np.ones(n, bool), np.zeros(cap - n, bool)])),
        slot_to_rowid=t(
            np.concatenate([np.asarray(rowids).astype(np.int32), np.full(cap - n, -1, np.int32)])
        ),
        entry=i32(g.entry),
        max_level=i32(max(g.max_level, 0) if g.entry >= 0 else -1),
        count=i32(g.n),
    )
