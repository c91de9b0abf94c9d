"""The comparison that decides `correct`.

Once the window has closed and the program's state is freed, every kept
answer (the searches of the recall steps, the reservoir drawn from the
seed, and in a cell that writes, the read-back of acknowledged inserts)
is judged against the plain reference on the rows the benchmark
generated:

- `bad_answers`: answer rows with an id that is -1, outside the live
  range at that moment (deleted, or never inserted), repeated, or with
  distances that are not finite or not ascending. Exact: limit 0.
- `dist_err`: the largest relative gap between a reported distance and
  the reference's direct distance from the query to the row reported.
- `knn_missed`: the share of the recall steps' answer slots that do not
  hold one of the query's exact k nearest live rows, where a row as near
  as the k-th (within a millionth of its distance, float32's rounding of
  a distance) counts as one of them. It catches an answer that is true
  row by row but not the nearest: a scan that skips part of the tape, a
  graph search that explores less.
- `inserts_missed`: in a cell that writes, the share of sampled
  acknowledged inserts that a search for their own vector at k=1 does
  not return.
- `failed_ops`: requests that raised. Exact: limit 0.

`recall` is the mean recall@k of the recall steps' answers against the
reference's exact k nearest over the rows live at that step, ids
compared as they are (no ties).
"""
from __future__ import annotations

import numpy as np
import torch

from vssbench import reference


def _queries(ans, pool_ext: torch.Tensor) -> torch.Tensor:
    if ans.q is not None:
        return torch.as_tensor(ans.q, device=pool_ext.device)
    return pool_ext[ans.pool_start:ans.pool_start + ans.ids.shape[0]]


def bad_rows(ans) -> int:
    ids, d = ans.ids, ans.dists
    bad = (ids < 0).any(1) | (ids < ans.lo).any(1) | (ids >= ans.hi).any(1)
    bad |= ~np.isfinite(d).all(1)
    if ids.shape[1] > 1:
        s = np.sort(ids, axis=1)
        bad |= (s[:, 1:] == s[:, :-1]).any(1)
        bad |= (d[:, 1:] < d[:, :-1]).any(1)
    return int(bad.sum())


def dist_errors(answers, pool_ext, corpus, base, chunks, metric) -> float:
    """Largest relative gap over every answer's valid entries."""
    gaps, refs = [], []
    for ans in answers:
        q = _queries(ans, pool_ext)
        ids = torch.as_tensor(ans.ids, device=base.device)
        ok = (ids >= ans.lo) & (ids < ans.hi)
        rows = corpus.rows_of(ids.clamp(min=0).reshape(-1), base, chunks)
        ref = reference.distances(q, rows.reshape(*ids.shape, -1), metric)
        got = torch.as_tensor(ans.dists, device=base.device).double()
        gaps.append(torch.where(ok, (got - ref).abs(), 0.0).reshape(-1))
        refs.append(torch.where(ok, ref, float("nan")).reshape(-1))
    if not gaps:
        return float("nan")
    gap, ref = torch.cat(gaps), torch.cat(refs)
    # a distance of about 0 (a row found by its own vector) is judged
    # against a thousandth of the median distance instead
    floor = 1e-3 * float(torch.nanmedian(ref[ref > 0])) if bool((ref > 0).any()) else 1.0
    rel = gap / torch.nan_to_num(ref, nan=1.0).clamp_min(floor)
    return float(rel.max())


def live_rows(corpus, base, chunks, lo: int, hi: int) -> torch.Tensor:
    """Rows of the live ids [lo, hi), in id order."""
    parts = []
    if lo < corpus.rows:
        parts.append(base[lo:min(hi, corpus.rows)])
    if hi > corpus.rows:
        start = max(lo, corpus.rows) - corpus.rows
        ids = torch.arange(start, hi - corpus.rows, device=base.device) + corpus.rows
        parts.append(corpus.rows_of(ids, base, chunks))
    return torch.cat(parts) if len(parts) > 1 else parts[0]


TIE = 1e-6      # a row within this share of the k-th distance is a tie
_MARGIN = 16    # candidates past k, so the exact k-th is among them


def recall_of(answers, pool_ext, corpus, base, chunks, metric, precision="f32"):
    """(mean recall@k of `answers` against the exact k nearest, the share
    of their slots not filled by one of the k nearest up to ties)."""
    by_range: dict = {}
    for ans in answers:
        by_range.setdefault((ans.lo, ans.hi), []).append(ans)
    total, missed, count = 0.0, 0.0, 0
    for (lo, hi), group in sorted(by_range.items()):
        rows = live_rows(corpus, base, chunks, lo, hi)
        ids = torch.arange(lo, hi, device=base.device)
        for ans in group:
            q = _queries(ans, pool_ext)
            k = ans.k
            _, cand = reference.knn(q, rows, k + _MARGIN, ids=ids, precision=precision,
                                    metric=metric)
            found = torch.as_tensor(ans.ids, device=base.device)
            r = reference.recall(found, cand[:, :k])
            total += float(r.sum())
            count += r.numel()
            # the k-th distance exactly: the candidates' direct distances
            dc = reference.distances(q, rows[cand - lo], metric)
            kth = dc.sort(1).values[:, k - 1:k]
            live = (found >= lo) & (found < hi)
            df = reference.distances(q, rows[found.clamp(lo, hi - 1) - lo], metric)
            hit = live & (df <= kth + TIE * kth.abs())
            missed += float((k - hit.sum(1)).clamp_min(0).sum()) / k
            del dc, df
        del rows
    if not count:
        return float("nan"), float("nan")
    return total / count, missed / count


def judge(outcome, extra, pool_ext, corpus, base, metric, limits, found_share=None):
    """The compared numbers, each with its limit, and the recall.
    `extra` are answers kept besides the loop's (the read-back)."""
    chunks: dict = {}
    kept = {id(a) for a in outcome.answers}
    checked = outcome.answers + [a for a in outcome.sampled if id(a) not in kept] + list(extra)
    numbers = {
        "failed_ops": (float(outcome.failed), 0.0),
        "bad_answers": (float(sum(bad_rows(a) for a in checked)), 0.0),
        "dist_err": (dist_errors(checked, pool_ext, corpus, base, chunks, metric),
                     float(limits["dist_err"])),
    }
    if found_share is not None:
        numbers["inserts_missed"] = (1.0 - found_share, float(limits["inserts_missed"]))
    rec, missed = recall_of(outcome.answers, pool_ext, corpus, base, chunks, metric)
    numbers["knn_missed"] = (missed, float(limits["knn_missed"]))
    return numbers, rec


def passed(numbers: dict) -> bool:
    return all(np.isfinite(v) and v <= lim for v, lim in numbers.values())
