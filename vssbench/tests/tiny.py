"""A tiny copy of the benchmark's tree for CPU tests: the same cells,
with those of `left_out.json`, configurations and traffic at a few
thousand rows and batches of 64."""
from __future__ import annotations

import json
import os
import shutil

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)


def make_root(path) -> str:
    """Writes the tiny tree under `path` and returns it."""
    path = str(path)
    os.makedirs(os.path.join(path, "vssbench", "configs"), exist_ok=True)
    for sub in ("traffic", "metrics", "limits"):
        shutil.copytree(os.path.join(BENCH, sub), os.path.join(path, "vssbench", sub),
                        dirs_exist_ok=True)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    # the cells left out of the benchmark run here all the same
    with open(os.path.join(BENCH, "left_out.json")) as f:
        left_out = json.load(f)
    for key in ("workloads", "end_to_end", "per_layer"):
        bench[key] += left_out[key]
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        cfg["corpus"].update(rows=3000, centres=64, chunk_rows=1000,
                             dims=min(cfg["corpus"]["dims"], 96))
        cfg["queries"]["pool"] = 300
        with open(os.path.join(path, c["file"]), "w") as f:
            json.dump(cfg, f)
    with open(os.path.join(path, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    tdir = os.path.join(path, "vssbench", "traffic")
    for name in os.listdir(tdir):
        p = os.path.join(tdir, name)
        with open(p) as f:
            t = json.load(f)
        for op in t["ops"]:
            for key in ("batch", "rows"):
                if key in op:
                    op[key] = 64
        writes = any(op["op"] == "insert" for op in t["ops"])
        t["recall_steps"] = [3, 5] if writes else [3, 4, 5]
        t["prepare_steps"] = 16 if writes else 0
        t["trace_steps"] = 2
        if "read_back" in t:
            t["read_back"]["rows"] = 32
        with open(p, "w") as f:
            json.dump(t, f)
    return path
