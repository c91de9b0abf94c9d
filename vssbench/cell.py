"""One run of one cell: set-up, the measured window, the check, the
metrics. `run.py` is the command; tests drive `run_cell` directly."""
from __future__ import annotations

import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from vssbench import check
from vssbench.data import Corpus, subseed
from vssbench.loop import Answer, Loop, load_traffic
from vssbench.trace import Tracer

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_benchmark(root: str = ROOT) -> dict:
    return load_json(root, "BENCHMARK.json")


def find_cell(bench: dict, name: str):
    """(workload entry, configuration entry) of cell `name`."""
    for w in bench["workloads"]:
        if w["name"] == name:
            for c in bench["configs"]:
                if c["name"] == w["config"]:
                    return w, c
            raise KeyError(f"cell {name}: no configuration {w['config']!r}")
    raise KeyError(f"no cell {name!r} in BENCHMARK.json")


def load_json(root: str, rel: str) -> dict:
    with open(os.path.join(root, rel)) as f:
        return json.load(f)


def metric_entries(bench: dict, cell: str, kind: str) -> list:
    """The metrics of `kind` ('end_to_end' or 'per_layer') that cell
    `cell` reports."""
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or cell in m["workloads"]]
    if kind == "end_to_end":
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in moved)]


def reader(name: str, bench_dir: str = HERE):
    """The reader of metric `name`: `metrics/<name>.py`, its `read(ctx)`."""
    path = os.path.join(bench_dir, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "vssbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclass
class Context:
    """What a metric reader reads."""
    outcome: object
    trace: object           # the full trace: spans, host operators, device
    device_trace: object    # the device alone
    cell: dict
    config: dict
    traffic: dict
    setup_s: float
    recall: float


def digest(rows: torch.Tensor) -> float:
    """A float64 sum of the rows, block by block (temporaries stay small)."""
    return float(sum(rows[s:s + 65_536].double().sum() for s in range(0, rows.shape[0], 65_536)))


def log(msg: str):
    print(msg, file=sys.stderr, flush=True)


def port_system(config: dict, device):
    from vssbench.system import PortSystem

    return PortSystem(config["index"], config["corpus"]["dims"], device)


def _card(device: torch.device) -> dict:
    if device.type != "cuda":
        return {"platform": device.type, "kind": device.type, "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1}


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def read_back(loop: Loop, outcome, system, spec: dict, seed: int):
    """Searches for sampled acknowledged inserts (still live) by their own
    vectors: (answers, share found at rank 1)."""
    n0 = loop.corpus.rows
    first = max(outcome.lo, n0)
    if outcome.hi <= first:
        return [], None
    rng = np.random.default_rng(subseed(seed, "read-back"))
    ids = np.sort(rng.choice(np.arange(first, outcome.hi), size=min(spec["rows"], outcome.hi - first),
                             replace=False))
    q = loop.stream.take(ids - n0).astype(np.float32)
    d, got = system.search(q, spec["k"], spec.get("ef"))
    ans = Answer(-1, 0, spec["k"], outcome.lo, outcome.hi, np.asarray(d, np.float32),
                 np.asarray(got, np.int64), q=q)
    found = float((ans.ids[:, 0] == ids).mean())
    return [ans], found


def run_cell(name: str, seed: int, seconds: float, trace: bool, device, t_start: float,
             root: str = ROOT, make_system=port_system) -> dict:
    device = torch.device(device)
    bench = load_benchmark(root)
    cell, centry = find_cell(bench, name)
    config = load_json(root, centry["file"])
    traffic = load_traffic(cell["traffic"], os.path.join(root, "vssbench"))
    limits = load_json(root, os.path.join("vssbench", "limits", f"{name}.json"))["limits"]
    metric = config["index"]["metric"]

    # ------------------------------------------------------------ set-up
    corpus = Corpus(config["corpus"], seed, device)
    base = corpus.base()
    made = digest(base)
    pool = corpus.queries(int(config["queries"]["pool"]))
    pool_host = pool.cpu().numpy()
    system = make_system(config, device)
    compiled = system.prepare()
    t = time.perf_counter()
    system.build(base)
    build_s = time.perf_counter() - t
    del base
    tracer = Tracer(device) if trace else None
    loop = Loop(traffic, system, pool_host, corpus, seed, tracer)
    loop.prepare()
    if tracer is not None:
        tracer.warm()
    loop.warmup()
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s (kernels compiled {compiled:.3f} s, build {build_s:.3f} s, "
        f"{json.dumps(system.stats())})")

    # ------------------------------------------------------------ window
    loop.window(seconds)
    outcome = loop.finish()
    peak = int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0
    extra, found = [], None
    if "read_back" in traffic:
        extra, found = read_back(loop, outcome, system, traffic["read_back"], seed)
    system.close()
    del system
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    log(f"window {outcome.window_s:.3f} s, {outcome.steps} steps, {len(outcome.ops)} requests, "
        f"{outcome.failed} failed; {_power_limit() if device.type == 'cuda' else 'cpu'}")
    for e in outcome.errors[:5]:
        log(f"error: {e}")

    # ------------------------------------------------------------ check
    base = corpus.base()
    same = digest(base) == made
    pool_ext = torch.as_tensor(loop.pool, device=device)
    numbers, rec = check.judge(outcome, extra, pool_ext, corpus, base, metric, limits, found)
    numbers["rows_remade"] = (0.0 if same else 1.0, 0.0)
    del base
    ctx = Context(outcome, tracer.trace if tracer else None,
                  tracer.device_trace if tracer else None, cell, config, traffic, setup_s, rec)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in metric_entries(bench, name, kind):
        v = reader(m["name"], os.path.join(root, "vssbench"))(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = _card(device)
    dev["memory_peak_bytes"] = peak
    result = {
        "correct": check.passed(numbers),
        "attempted": len(outcome.window_ops(("search", "scan_search", "insert", "delete"))),
        "failed": outcome.failed,
        "metrics": metrics,
        "device": dev,
    }
    if trace and ctx.device_trace is not None:
        dev["busy_s"] = ctx.device_trace.busy_us() * 1e-6
        dev["window_s"] = ctx.device_trace.window_us * 1e-6
    if trace and ctx.trace is not None:
        result["breakdown"] = {"device_ops": ctx.device_trace.top_device_ops()
                               if ctx.device_trace is not None else ctx.trace.top_device_ops(),
                               "idle_gaps": ctx.trace.idle_gaps()}
    result["check"] = {k: {"value": v, "limit": lim} for k, (v, lim) in numbers.items()}
    return result
