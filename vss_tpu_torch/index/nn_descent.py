"""NN-descent refinement of bulk candidate lists.

Reproduces `vss_tpu/index/nn_descent.py`. The IVF-window candidate pass
(`index/ivf_candidates.py`) depends on locality: on flat (i.i.d.-like)
corpora its probed pool is near-random and the graph built from it
collapses. NN-descent (Dong et al., WWW'11: "a neighbour of a neighbour is
likely a neighbour") repairs the lists with batched gathers and batched
matrix-vector products:

  one round, for every node u with current candidate list B[u] (top-S):
    R[u] = reverse edges (who lists u: one stable sort of n*S edges)
    U[u] = B[u] + R[u]
    pool = U[u] + B[U[u]]
    score d(u, pool) on gathered vectors, merge into the running top-C.

Rounds are adaptive: a sampled oracle (`sampled_list_recall`) measures
the lists' recall@10, so clustered corpora pay no round. The lists keep
the `exact_knn` contract: dists [n, C] ascending f32, ids [n, C] i32, -1
padded, self excluded.

On the card (the JAX package's TPU branch) the gather tape is bf16; on
the CPU it stays f32. The recall sample is the JAX package's numpy draw.
The blocks are Python loops over row chunks, with no pad rows.
"""
from __future__ import annotations

import numpy as np
import torch

from vss_tpu_torch.ops.distance import Metric

__all__ = ["nn_descent_refine", "sampled_list_recall"]

_INF = float("inf")


def _reverse_union(cand_i, S: int):
    """B = top-S of each list, R = up to S reverse edges; returns
    (B [n, S], U = B + R [n, 2S])."""
    from vss_tpu_torch.index.exact_build import _group_incoming

    n = cand_i.shape[0]
    B = cand_i[:, :S].contiguous()
    slots = torch.arange(n, dtype=torch.int32, device=cand_i.device)
    R = _group_incoming(slots, B, n, S)
    return B, torch.cat([B, R], 1)


def _nnd_block(tape, B, U, cand_d_blk, cand_i_blk, r0: int, C: int, metric: Metric):
    """One chunk of rows [r0, r0 + len) through one round: expand ->
    score -> merge. Returns the chunk's new (dists, ids)."""
    from vss_tpu_torch.index.search import _dedupe_keep_first
    from vss_tpu_torch.ops.distance import gathered_distances
    from vss_tpu_torch.ops.topk import _sort_min_k

    rows = cand_i_blk.shape[0]
    u = U[r0:r0 + rows]                                     # [rows, 2S]
    p = B[u.clamp(min=0).long()]                            # [rows, 2S, S]
    p = torch.where((u >= 0)[:, :, None], p, -1)
    pool = torch.cat([u, p.reshape(rows, -1)], 1)
    self_ids = r0 + torch.arange(rows, dtype=torch.int32, device=tape.device)
    pool = torch.where(pool == self_ids[:, None], -1, pool)
    pv = tape[pool.clamp(min=0).long()]                     # [rows, W, d]
    qv = tape[r0:r0 + rows].float()
    d = gathered_distances(qv, pv, metric)
    d = torch.where(pool < 0, _INF, d)
    # duplicates (the pool overlaps the running list and itself) would take
    # top-C slots; the first occurrence stays, so running entries win
    all_i = _dedupe_keep_first(torch.cat([cand_i_blk, pool], 1))
    all_d = torch.where(all_i < 0, _INF, torch.cat([cand_d_blk, d], 1))
    nd, pos = _sort_min_k(all_d, C)
    ni = all_i.gather(1, pos.long())
    return nd, torch.where(torch.isfinite(nd), ni, -1)


def sampled_list_recall(
    xv: torch.Tensor,
    cand_i: torch.Tensor,
    metric,
    *,
    n_sample: int = 1024,
    k: int = 10,
    seed: int = 0,
    use_scan: bool = False,
) -> tuple[float, np.ndarray, np.ndarray]:
    """recall@k of the candidate LISTS on a node sample, against an exact
    oracle over all rows. Returns (recall, sample_ids, oracle_ids) so that
    later rounds are checked against the same oracle.

    The oracle is `bruteforce_topk` (kernel K3 on the card) over `xv` f32,
    or with `use_scan` the storage-native scan (`scan_topk`, kernel K2)
    over `xv` as stored (a quantized tape: exact with respect to the same
    values the lists were scored on)."""
    from vss_tpu_torch.ops.topk import bruteforce_topk

    n = xv.shape[0]
    dev = xv.device
    n_sample = min(n_sample, n)
    rng = np.random.default_rng(seed)
    sample = np.sort(rng.choice(n, n_sample, replace=False)).astype(np.int32)
    sample_t = torch.from_numpy(sample.astype(np.int64)).to(dev)
    q = xv[sample_t]
    # k+1 then drop self: the oracle scores every row, the query's too
    if use_scan:
        from vss_tpu_torch.ops.scan import scan_topk

        xn = (xv.float() ** 2).sum(1)
        _, ids = scan_topk(q.float(), xv, k + 1, metric, x_norms=xn, device=dev)
    else:
        _, ids = bruteforce_topk(q, xv, k + 1, metric, device=dev)
    ids = ids.cpu().numpy()
    oracle = np.empty((n_sample, k), np.int32)
    for j, s in enumerate(sample):
        oracle[j] = ids[j][ids[j] != s][:k]
    return _recall_against(cand_i, sample, oracle), sample, oracle


def _recall_against(cand_i, sample, oracle) -> float:
    got = cand_i[torch.from_numpy(sample.astype(np.int64)).to(cand_i.device)].cpu().numpy()
    k = oracle.shape[1]
    hits = sum(
        len(set(oracle[j].tolist()) & set(got[j][got[j] >= 0].tolist()))
        for j in range(len(sample))
    )
    return hits / (len(sample) * k)


def nn_descent_refine(
    xv: torch.Tensor,
    cand_d: torch.Tensor,
    cand_i: torch.Tensor,
    metric,
    *,
    S: int = 16,
    max_rounds: int = 6,
    target_recall: float = 0.95,
    chunk: int = 4096,
    seed: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Adaptively refine candidate lists.

    xv [n, d] f32; cand_d / cand_i [n, C] per the exact_knn contract with
    ids positional (id == row index, as `build_graph_exact` passes them).
    Measures the sampled list recall@10 first and runs rounds only while
    it is below `target_recall`, stopping early on convergence (< 0.5 pt
    gain) or after `max_rounds`. Inputs of at most `chunk` rows, and lists
    already at the target, come back as the same tensors. Rows go through
    a round `chunk` at a time."""
    metric = Metric.parse(metric)
    n = xv.shape[0]
    C = cand_i.shape[1]
    if n <= chunk:  # tiny inputs: the exact pass upstream already covers them
        return cand_d, cand_i
    rec, sample, oracle = sampled_list_recall(xv, cand_i, metric, seed=seed)
    if rec >= target_recall:
        return cand_d, cand_i
    from vss_tpu_torch.index.exact_build import _fast

    tape = xv.to(torch.bfloat16) if _fast(xv) else xv
    for _ in range(max_rounds):
        B, U = _reverse_union(cand_i, S)
        parts_d, parts_i = [], []
        for s in range(0, n, chunk):
            bd, bi = _nnd_block(tape, B, U, cand_d[s:s + chunk], cand_i[s:s + chunk], s, C,
                                metric)
            parts_d.append(bd)
            parts_i.append(bi)
        cand_d = torch.cat(parts_d)
        cand_i = torch.cat(parts_i)
        new_rec = _recall_against(cand_i, sample, oracle)
        done = new_rec >= target_recall or new_rec - rec < 0.005
        rec = new_rec
        if done:
            break
    return cand_d, cand_i
