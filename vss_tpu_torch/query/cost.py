"""Cost-based plan choice between the HNSW graph and the exact scan.

Reproduces `vss_tpu/query/cost.py` with the same model, the same entry
points (`prefer_exact`, `serving_path`, `exact_cost_s`, `graph_cost_s`)
and rates of its own. The reference has no such component: on a CPU the
graph is the only viable operator, so its optimizers rewrite
unconditionally (`hnsw_optimize_scan.cpp`, `hnsw_optimize_join.cpp`).

The model scores both operators by bytes over an effective rate:

  exact   ~ ceil(B / QBATCH) * N * d * itemsize / STREAM_BW (or TAPE_BW)
  graph   ~ B * ITERS(ef, expand) * expand * M0 * row_fetch / RANDOM_BW

Every rate is effective: the whole operator call, host work and kernel
launches included, timed over a batch of QBATCH queries and divided into
the bytes the model charges it. RANDOM_BW is therefore the rate of the
graph search itself (`HNSWIndex.search` at ef 64), not of a raw gather;
the JAX package scaled a raw gather by a factor fit on its chip and
charged a per-query loop latency, and neither figure carries over.

Disabled by default (`SET hnsw_cost_model = true` to enable) so the
default plan shapes stay reference-parity.

The shipped rates below are what `calibrate()` measured on an NVIDIA
H100 80GB HBM3 at its 700 W power limit; on other hardware run
`calibrate()` once (or `python -m vss_tpu_torch calibrate`): it measures
the rates on the database's device and persists them per device name to
`~/.cache/vss_tpu_torch/cost_<device>.json`, loaded afterwards.
"""
from __future__ import annotations

import json
import os
import re
import time
from typing import Optional

import torch

from vss_tpu_torch.utils import resolve_device

# Effective rates (bytes/s) measured by `calibrate()` (n_rows = 2**18,
# d = 128, 512 queries, k = 10) in phase 7 of `python3 chip_smoke.py` on
# an NVIDIA H100 80GB HBM3, 700.00 W. The calls are host-bound, so the
# rates move with the host: two other runs measured 1.0-3.8x these (the
# graph search's rate moved most), with the same decisions.
# f32 table stream of `bruteforce_topk` (K3 winnow + rescore).
STREAM_BW = 53.63e9
# storage-native scan `scan_topk` over the index tape, by itemsize (K2
# winnow, selections, exact rerank); f32 tapes take the f32 stream.
TAPE_BW = {1: 7.42e9, 2: 18.00e9, 4: STREAM_BW}
# graph search (`HNSWIndex.search`, ef 64, int8 tape), over the bytes the
# model charges it: beam_iters(ef, 1) * m0 * row per query.
RANDOM_BW = 61.36e9
# Query rows one exact pass is priced for (the batch calibrate() times).
QBATCH = 512
# Minimum bytes a random row fetch occupies: the H100's 32-byte DRAM
# sector.
MIN_FETCH = 32.0

_LOADED: Optional[dict] = None


def _device_key(device=None) -> str:
    dev = resolve_device(device) if device is not None else torch.device(
        "cuda" if torch.cuda.is_available() else "cpu")
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return re.sub(r"[^A-Za-z0-9_.-]+", "_", name)


def _cache_path(device=None) -> Optional[str]:
    root = os.environ.get(
        "VSS_COST_CACHE_DIR",
        os.path.join(os.path.expanduser("~"), ".cache", "vss_tpu_torch"),
    )
    return os.path.join(root, f"cost_{_device_key(device)}.json")


def _rates() -> dict:
    """Active rate set: shipped rates, overlaid by a persisted
    calibration for this machine's device when one exists."""
    global _LOADED
    if _LOADED is None:
        _LOADED = {
            "stream_bw": STREAM_BW,
            "random_bw": RANDOM_BW,
            "tape_bw": dict(TAPE_BW),
        }
        p = _cache_path()
        if p and os.path.exists(p):
            try:
                with open(p) as f:
                    d = json.load(f)
                _LOADED["stream_bw"] = float(d.get("stream_bw", STREAM_BW))
                _LOADED["random_bw"] = float(d.get("random_bw", RANDOM_BW))
                _LOADED["tape_bw"].update(
                    {int(k): float(v) for k, v in d.get("tape_bw", {}).items()}
                )
            except (OSError, ValueError):
                pass
    return _LOADED


def _per_call_s(fn, dev: torch.device) -> float:
    """Seconds per call of `fn`, as the smallest slope between `lo` and
    `hi` back-to-back calls over a few trials (fixed costs outside the
    calls cancel): CUDA events on the card, the host clock on the CPU
    (fewer calls there, where a probe is a test of the machinery)."""
    cuda = dev.type == "cuda"
    lo, hi, trials = (2, 8, 3) if cuda else (1, 3, 2)

    def run(n: int) -> float:
        if cuda:
            torch.cuda.synchronize(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return time.perf_counter() - t0

    run(1)  # warm: builds and first-use costs
    deltas = [run(hi) - run(lo) for _ in range(trials)]
    pos = [x for x in deltas if x > 0] or [max(max(deltas), 1e-7)]
    return min(pos) / (hi - lo)


def calibrate(persist: bool = True, n_rows: int = 1 << 18, device=None) -> dict:
    """Measure the rates of the port's own operators on `device` (CUDA
    unless "cpu" is passed) over an n_rows x 128 corpus (N(0, 40^2),
    seed 0) and min(QBATCH, n_rows / 64) queries at k = 10 (QBATCH from
    2**15 rows up; fewer keep a small probe on the CPU short):
      - `tape_bw[1]`, `tape_bw[2]`: `scan_topk` (K2) over the int8 and
        bf16 tapes of the corpus;
      - `stream_bw` (= `tape_bw[4]`): `bruteforce_topk` (K3) over f32;
      - `gather_bw`: `gather_rows` (K5) of 2**16 random 128-byte rows
        (reported; the model charges the graph search's own rate);
      - `random_bw`: `HNSWIndex.search` at ef 64 over an int8 index of
        the corpus, charged beam_iters(64, 1) * m0 * row bytes a query.
    Persists to `~/.cache/vss_tpu_torch/` (or VSS_COST_CACHE_DIR) and
    becomes the active rate set. Returns the measured dict."""
    from vss_tpu_torch.index.dense import HNSWIndex
    from vss_tpu_torch.index.graph import HNSWConfig
    from vss_tpu_torch.ops.gather import gather_rows
    from vss_tpu_torch.ops.scan import scan_topk
    from vss_tpu_torch.ops.topk import bruteforce_topk

    dev = resolve_device(device)
    D, K, EF = 128, 10, 64
    gen = torch.Generator(device="cpu").manual_seed(0)
    xf = (torch.randn((n_rows, D), generator=gen) * 40.0).to(dev)
    q = xf[: min(QBATCH, max(1, n_rows // 64))] + 1.0
    out: dict = {"tape_bw": {}, "device": _device_key(dev)}

    for itemsize, tape in ((1, torch.clamp(torch.round(xf), -127, 127).to(torch.int8)),
                           (2, xf.to(torch.bfloat16))):
        tf = tape.float()
        xn = (tf * tf).sum(-1)
        per = _per_call_s(lambda: scan_topk(q, tape, K, "l2sq", x_norms=xn, device=dev), dev)
        out["tape_bw"][itemsize] = n_rows * D * itemsize / per

    per = _per_call_s(lambda: bruteforce_topk(q, xf, K, "l2sq", device=dev), dev)
    out["stream_bw"] = n_rows * D * 4 / per
    out["tape_bw"][4] = out["stream_bw"]

    tape8 = torch.clamp(torch.round(xf), -127, 127).to(torch.int8)
    ids = torch.randint(0, n_rows, (1 << 16,), generator=gen, dtype=torch.int32).to(dev)
    per = _per_call_s(lambda: gather_rows(tape8, ids), dev)
    out["gather_bw"] = ids.numel() * max(D, MIN_FETCH) / per

    cfg = HNSWConfig(dims=D, storage_dtype="int8")
    idx = HNSWIndex.build(xf, cfg, device=dev)
    per = _per_call_s(lambda: idx.search(q, K, ef=EF), dev)
    charged = q.shape[0] * beam_iters(EF, 1) * cfg.m0 * max(D, MIN_FETCH)
    out["random_bw"] = charged / per
    del idx

    active = _rates()
    active["stream_bw"] = out["stream_bw"]
    active["random_bw"] = out["random_bw"]
    active["tape_bw"].update(out["tape_bw"])
    if persist:
        p = _cache_path(dev)
        try:
            os.makedirs(os.path.dirname(p), exist_ok=True)
            with open(p, "w") as f:
                json.dump({k: out[k] for k in ("stream_bw", "random_bw", "tape_bw")}, f)
        except OSError:
            pass
    out["path"] = p if persist else None
    return out


def beam_iters(ef: int, expand: int) -> float:
    """Fixed-bound iteration count of the batched beam
    (index/search.py: max_iters = 4 + 2*ef/expand)."""
    return 4 + (2 * ef) / max(expand, 1)


def exact_cost_s(
    n_rows: int, dims: int, itemsize: int, n_queries: int,
    tape_scan: bool = False,
) -> float:
    """Wall-clock estimate of one exact pass over the whole table.

    tape_scan=False prices the f32 table-column scan (BRUTE_FORCE_TOPK);
    tape_scan=True prices the storage-native scan over the index tape at
    `itemsize` (EXACT_SCAN_TOPK)."""
    passes = max(1, -(-n_queries // QBATCH))
    r = _rates()
    bw = (
        r["tape_bw"].get(itemsize, r["stream_bw"]) if tape_scan
        else r["stream_bw"]
    )
    return passes * (n_rows * dims * itemsize) / bw


def graph_cost_s(
    n_queries: int,
    dims: int,
    itemsize: int,
    ef: int,
    m0: int,
    expand: int = 2,
) -> float:
    """Wall-clock estimate of `n_queries` beam searches."""
    row = max(dims * itemsize, MIN_FETCH)
    fetched = beam_iters(ef, expand) * expand * m0 * row
    return n_queries * fetched / _rates()["random_bw"]


def prefer_exact(
    n_rows: int,
    dims: int,
    itemsize: int,
    n_queries: int,
    ef: int,
    m0: int,
    expand: int = 2,
    tape_scan: bool = False,
) -> bool:
    """True when the exact scan is estimated cheaper than the graph for
    this (corpus, batch): the hybrid planner's decision. `tape_scan`
    selects the storage-native tape-scan pricing (see exact_cost_s);
    pass the TAPE itemsize with it."""
    return exact_cost_s(
        n_rows, dims, itemsize, n_queries, tape_scan=tape_scan
    ) < graph_cost_s(n_queries, dims, itemsize, ef, m0, expand)


def serving_path(
    n_rows: int,
    dims: int,
    tape_itemsize: int,
    n_queries: int,
    ef: int,
    m0: int,
    expand: int = 2,
) -> str:
    """'scan' or 'graph': the serving decision for a batched workload
    over an index with a native-scannable tape."""
    return (
        "scan"
        if prefer_exact(
            n_rows, dims, tape_itemsize, n_queries, ef, m0, expand,
            tape_scan=True,
        )
        else "graph"
    )
