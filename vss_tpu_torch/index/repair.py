"""Graph connectivity audit and repair.

Reproduces `vss_tpu/index/repair.py`. A kNN-derived graph can leave whole
clusters unreachable from the entry point: every edge is local, so a
component with no inbound edge from the entry's component is invisible to
beam search whatever ef is. Two passes:

  1. `reachable_mask`: fixpoint propagation of reachability over the
     base-layer adjacency, one full edge sweep per step;
  2. `repair_connectivity`: for every unreachable node, find its nearest
     reachable anchor by brute force (`bruteforce_topk`, kernel K3 on the
     card) and splice a bridge edge into the last adjacency slots of both
     endpoints, where the row does not list the other end already (the
     JAX package writes it whatever the row holds, and so can list an id
     twice in a row). Reachability runs as gather sweeps over a capped reverse
     adjacency, which can only under-report reach (erring toward harmless
     extra bridges).

The sweeps are Python loops that stop at their fixpoint. Where several
bridges write one adjacency cell, the last of them in the bridge order
stays, explicitly (the JAX package leaves that order to the scatter).
Used by the bulk builder (`index/exact_build.py`).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from vss_tpu_torch.index.graph import HNSWConfig, HNSWGraph
from vss_tpu_torch.ops.gather import gather_rows
from vss_tpu_torch.ops.topk import bruteforce_topk

__all__ = ["reachable_mask", "repair_connectivity"]


def _reachable_impl(adj0, entry: int, occupied, max_sweeps: int):
    cap = adj0.shape[0]
    reached = torch.zeros((cap,), dtype=torch.bool, device=adj0.device)
    if entry >= 0:
        reached[entry] = True
    for _ in range(max_sweeps):
        tgt = torch.where(reached[:, None], adj0, -1).reshape(-1)
        nxt = reached.clone()
        nxt[tgt[tgt >= 0].long()] = True
        if torch.equal(nxt, reached):
            break
        reached = nxt
    return reached & occupied


def reachable_mask(graph: HNSWGraph, max_sweeps: int = 64) -> torch.Tensor:
    """bool [cap]: occupied slots reachable from the entry point via
    base-layer edges. Each sweep extends reachability by one hop, so
    `max_sweeps` bounds the detectable graph diameter."""
    occupied = graph.slot_to_rowid >= 0
    return _reachable_impl(graph.adj0, int(graph.entry), occupied, max_sweeps)


_MAX_ANCHORS = 65536
_REV_CAP = 32  # incoming edges kept per node for the reachability sweeps


def _sweep_reachable_rev(rev, reached, occupied, max_sweeps: int):
    """Fixpoint reachability by gather sweeps over a capped reverse
    adjacency: node i becomes reached when one of its recorded incoming
    sources is reached. The cap makes it conservative."""
    for _ in range(max_sweeps):
        src_ok = reached[rev.clamp(min=0).long()] & (rev >= 0)
        nr = reached | (src_ok.any(1) & occupied)
        if torch.equal(nr, reached):
            break
        reached = nr
    return reached


def _last_of_each(keys: np.ndarray) -> np.ndarray:
    """Positions of the last occurrence of every distinct key, ascending."""
    _, first_rev = np.unique(keys[::-1], return_index=True)
    return np.sort(keys.size - 1 - first_rev)


def repair_connectivity(
    graph: HNSWGraph,
    config: HNSWConfig,
    max_rounds: int = 8,
    max_bridges_per_round: int = 16384,
    query_chunk: int = 4096,
) -> tuple[HNSWGraph, int]:
    """Bridge unreachable nodes into the entry component.

    Returns (graph, n_bridged); the input graph is left as it was (a graph
    with bridges gets its own adjacency). A capped reverse adjacency is
    built once and reachability runs as gather sweeps over it. Each round
    picks up to `max_bridges_per_round` unreachable nodes (an evenly
    strided sample when there are more: one bridge per component suffices,
    intra-component edges spread reachability), finds each one's nearest
    anchor among a strided sample (at most 65,536) of the reached set, and
    writes a bidirectional bridge into the tail adjacency slots of both
    endpoints, each half where its row does not list the other end
    already, so no row lists an id twice. Sweeps resume from the bridged
    nodes."""
    entry = int(graph.entry)
    if entry < 0:
        return graph, 0
    dev = graph.device
    cap = graph.adj0.shape[0]
    adj = graph.adj0
    occupied_d = graph.slot_to_rowid >= 0
    # a bijective stride permutation of the rows makes the kept incoming
    # edges a pseudo-random sample of each target's sources (edge order
    # alone would keep the lowest slots and let the reach stall)
    stride = 2654435761 % cap
    while math.gcd(stride, cap) != 1:
        stride += 1
    perm = torch.from_numpy((np.arange(cap, dtype=np.int64) * stride % cap).astype(np.int32)).to(dev)
    from vss_tpu_torch.index.exact_build import _group_incoming

    rev = _group_incoming(perm, adj[perm.long()], cap, _REV_CAP)
    reached_d = torch.zeros((cap,), dtype=torch.bool, device=dev)
    reached_d[entry] = True
    reached_d = _sweep_reachable_rev(rev, reached_d, occupied_d, 64)
    occupied = occupied_d.cpu().numpy()
    total = 0
    tape = graph.vectors
    last = config.m0 - 1
    spread = min(4, config.m0)
    for _ in range(max_rounds):
        reached = reached_d.cpu().numpy() & occupied
        idx = np.nonzero(occupied & ~reached)[0]
        if idx.size == 0 or not reached.any():
            break
        if idx.size > max_bridges_per_round:
            step = idx.size / max_bridges_per_round
            idx = idx[(np.arange(max_bridges_per_round) * step).astype(np.int64)]
        ridx = np.nonzero(reached)[0]
        if ridx.size > _MAX_ANCHORS:
            astride = ridx.size / _MAX_ANCHORS
            ridx = ridx[(np.arange(_MAX_ANCHORS) * astride).astype(np.int64)]
        anchor_vecs = gather_rows(tape, torch.from_numpy(ridx.astype(np.int32)).to(dev)).float()
        near_parts = []
        for s in range(0, idx.size, query_chunk):
            u_vecs = gather_rows(
                tape, torch.from_numpy(idx[s:s + query_chunk].astype(np.int32)).to(dev)).float()
            # 'default' precision: a bridge only needs a NEAR anchor
            _, near_c = bruteforce_topk(u_vecs, anchor_vecs, 1, config.metric,
                                        precision="default", device=dev)
            near_parts.append(near_c[:, 0].cpu().numpy())
        local = np.concatenate(near_parts)
        r = np.where(local >= 0, ridx[np.maximum(local, 0)], -1)
        live = r >= 0
        u, r = idx[live], r[live]
        if u.size == 0:
            break
        if adj is graph.adj0:
            adj = adj.clone()
        ut = torch.from_numpy(u.astype(np.int64)).to(dev)
        rt = torch.from_numpy(r.astype(np.int64)).to(dev)
        # a bridge is written only where its row does not list the other
        # end yet (u's row often lists its nearest anchor already): a row
        # lists an id at most once, which the search's pools rely on
        new = ~(adj[ut] == rt[:, None]).any(1)
        adj[ut[new], last] = rt[new].to(torch.int32)
        # reverse bridges spread over the last few slots (many dark nodes
        # often share one nearest anchor)
        col = last - (u % spread)
        keep = torch.from_numpy(_last_of_each(r * config.m0 + col)).to(dev)
        rk, uk, ck = rt[keep], ut[keep], torch.from_numpy(col).to(dev)[keep]
        new = ~(adj[rk] == uk[:, None]).any(1)
        adj[rk[new], ck[new]] = uk[new].to(torch.int32)
        # the reverse bridge r -> u makes every u reachable: mark them and
        # resume the sweeps
        reached_d = reached_d.clone()
        reached_d[ut] = True
        reached_d = _sweep_reachable_rev(rev, reached_d, occupied_d, 64)
        total += int(u.size)
    if total:
        graph = dataclasses.replace(graph, adj0=adj)
    return graph, total
