"""Discovery by name, the import rules, BENCHMARK.json's shape, and the
command's refusal to run without a card."""
import ast
import json
import os
import subprocess
import sys

from vssbench import cell, run
from vssbench.loop import load_traffic

from .tiny import BENCH, ROOT, make_root

FORBIDDEN = {"jax", "jaxlib", "flax", "vss_tpu"}


def sources():
    for d, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def imported(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    for path in sources():
        bad = set(imported(path)) & FORBIDDEN
        assert not bad, f"{path} imports {bad}"


def test_only_the_system_module_imports_the_port():
    users = {os.path.relpath(p, BENCH) for p in sources() if "vss_tpu_torch" in imported(p)}
    assert users == {"system.py"}
    ref = set(imported(os.path.join(BENCH, "reference.py")))
    assert ref <= {"__future__", "contextlib", "torch"}


def test_forbidden_names_are_compared_whole():
    assert run.forbidden_modules(["vss_tpu_torch", "vss_tpu_torch.ops", "numpy"]) == []
    assert run.forbidden_modules(["vss_tpu.ops", "jax._src", "jaxlib"]) == ["jax", "jaxlib",
                                                                          "vss_tpu"]


def test_every_name_in_the_benchmark_has_its_file():
    bench = cell.load_benchmark()
    for c in bench["configs"]:
        cfg = cell.load_json(ROOT, c["file"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    for w in bench["workloads"]:
        cell.find_cell(bench, w["name"])
        load_traffic(w["traffic"])
        limits = cell.load_json(BENCH, os.path.join("limits", w["name"] + ".json"))["limits"]
        assert {"dist_err", "knn_missed"} <= set(limits)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(cell.reader(m["name"]))
    for w in bench["workloads"]:
        e2e = [m["name"] for m in cell.metric_entries(bench, w["name"], "end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.metric_entries(bench, w["name"], "per_layer")


def test_the_contract_shape():
    bench = cell.load_benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "vssbench/run.py"] and bench["paths"] == ["vssbench"]
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    assert all(0.01 <= m["bound"] <= 0.25 for m in bench["end_to_end"])
    assert all(w["chips"] == 1 for w in bench["workloads"])
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert all(m["moves"] in e2e for m in bench["per_layer"])


def test_the_left_out_cells_keep_their_files_and_no_name_of_the_benchmark():
    bench = cell.load_benchmark()
    left = cell.load_json(BENCH, "left_out.json")
    names = {e["name"] for key in ("workloads", "end_to_end", "per_layer") for e in bench[key]}
    configs = {c["name"] for c in bench["configs"]}
    for w in left["workloads"]:
        assert w["name"] not in names and w["config"] in configs
        load_traffic(w["traffic"])
        assert cell.load_json(BENCH, os.path.join("limits", w["name"] + ".json"))["limits"]
    for m in left["end_to_end"] + left["per_layer"]:
        assert m["name"] not in names and callable(cell.reader(m["name"]))


def test_a_new_config_traffic_and_metric_are_found_by_name(tmp_path):
    root = make_root(tmp_path)
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    cfg = json.load(open(os.path.join(root, "vssbench/configs/sift1m.json")))
    cfg["name"] = "sift-small"
    json.dump(cfg, open(os.path.join(root, "vssbench/configs/sift-small.json"), "w"))
    t = json.load(open(os.path.join(root, "vssbench/traffic/graph-k10.json")))
    t["ops"][0]["k"] = 3
    json.dump(t, open(os.path.join(root, "vssbench/traffic/graph-k3.json"), "w"))
    json.dump({"limits": {"dist_err": 1e-4, "knn_missed": 0.2}},
              open(os.path.join(root, "vssbench/limits/sift-small.graph-k3.json"), "w"))
    with open(os.path.join(root, "vssbench/metrics/calls.graph.py"), "w") as f:
        f.write("def read(ctx):\n    return float(len(ctx.outcome.window_ops(('search',))))\n")
    bench["configs"].append({"name": "sift-small", "source": "x",
                             "file": "vssbench/configs/sift-small.json", "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "sift-small.graph-k3", "config": "sift-small",
                               "traffic": "graph-k3", "chips": 1, "why": "x"})
    bench["end_to_end"].append({"name": "calls.graph", "unit": "count", "better": "higher",
                                "bound": 0.1, "source": "host_clock",
                                "workloads": ["sift-small.graph-k3"]})
    json.dump(bench, open(os.path.join(root, "BENCHMARK.json"), "w"))
    import time

    r = cell.run_cell("sift-small.graph-k3", 3, 0.2, False, "cpu", time.perf_counter(), root=root)
    assert r["correct"], r["check"]
    assert r["metrics"]["calls.graph"]["value"] >= 1
    # `qps` lists its cells; the others hold for every cell
    assert set(r["metrics"]) == {"p95_ms", "recall", "setup_s", "calls.graph"}


def test_the_command_refuses_to_run_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"), "--workload",
                        "sift1m.scan-k100", "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_the_command_fails_in_a_tree_without_the_port(tmp_path):
    import shutil

    shutil.copytree(BENCH, tmp_path / "vssbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    p = subprocess.run([sys.executable, "vssbench/run.py", "--workload", "sift1m.scan-k100",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""
