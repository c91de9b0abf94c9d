"""The text-embedding configuration (`openai1m`) and the single-query
traffic (`graph-q1`): the `openai_like` generator (unit-norm rows around
a common direction, seeded, separable by stream), the cells
`openai1m.graph-k10` and `sift1m.graph-q1` through `tiny.py`'s tiny tree
on the CPU (a sound run is correct; the control, a repeated row and a
search that leaves out a quarter of the slots are not), and the two
pivot-product readers' arithmetic. `sift1m.graph-q1` is not in
`BENCHMARK.json` (its runs spread past half the `qps` bound): its
traffic and limits wait in the tree, and the tiny tree here adds its
entry as the benchmark would, with the read metrics that apply to it."""
import json
import math
import os
import time
import types

import numpy as np
import pytest
import torch

from vssbench import cell
from vssbench.control import ControlSystem
from vssbench.data import Corpus

from .test_vssbench_check import QuarterSkipped, Repeated, factory, numbers
from .tiny import BENCH, ROOT, make_root

OPENAI = {"generator": "openai_like", "rows": 6000, "dims": 1536, "centres": 40,
          "mean_share": 0.7, "centre_share": 0.15, "noise_share": 0.15, "chunk_rows": 1000}
CELLS = ["openai1m.graph-k10", "sift1m.graph-q1"]
Q1 = {"name": "sift1m.graph-q1", "config": "sift1m", "traffic": "graph-q1", "chips": 1,
      "why": "one ORDER BY array_distance(vec, ?) LIMIT 10 a request: batch 1, k=10, ef=64"}
# the metrics whose readers apply at one query a call
Q1_METRICS = ["qps", "idle_share.read", "client_idle_ms.read", "intake_ms.read",
              "busy_ms.graph", "kernels.graph", "beam_ms.graph", "port_idle_ms.graph"]


def test_the_generator_is_unit_norm_and_seeded():
    a, b, c = Corpus(OPENAI, 7, "cpu"), Corpus(OPENAI, 7, "cpu"), Corpus(OPENAI, 8, "cpu")
    x = a.base()
    assert x.shape == (6000, 1536) and x.dtype == torch.float32
    assert float((x.norm(dim=1) - 1).abs().max()) < 1e-5
    assert torch.equal(x, b.base()) and torch.equal(a.queries(50), b.queries(50))
    assert torch.equal(a.chunk(2), b.chunk(2))
    assert not torch.equal(x, c.base())
    assert not torch.equal(a.queries(50), x[:50])


def test_the_generator_is_anisotropic_with_topics():
    """Pairs of rows of different topics have a cosine near mean_share,
    of one topic near mean_share + centre_share; the mean of the rows
    points along the common direction."""
    c = Corpus(OPENAI, 3, "cpu")
    x = c.base()[:3000].double()
    topic = (x @ c.centres[1:].double().T).argmax(1)
    cos = x @ x.T
    same = topic[:, None] == topic[None, :]
    off = ~torch.eye(3000, dtype=torch.bool)
    assert abs(float(cos[~same].median()) - 0.7) < 0.02
    assert abs(float(cos[same & off].median()) - 0.85) < 0.02
    mean = x.mean(0)
    assert float(mean @ c.centres[0].double() / mean.norm()) > 0.99


def test_the_configuration_states_its_shape():
    cfg = cell.load_json(ROOT, "vssbench/configs/openai1m.json")
    assert cfg["corpus"]["rows"] == 990_000 and cfg["corpus"]["dims"] == 1536
    assert cfg["index"]["metric"] == "cosine" and cfg["queries"]["pool"] == 10_000
    shares = [cfg["corpus"][k] for k in ("mean_share", "centre_share", "noise_share")]
    assert math.isclose(sum(shares), 1.0)
    assert cfg["reduced"] == []


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The tiny tree with `sift1m.graph-q1`'s entry, and `graph-q1`'s
    warm-up cut to two steps: the tree puts every read cell's recall
    steps at 3-5, inside its 64."""
    torch.set_num_threads(2)
    path = make_root(tmp_path_factory.mktemp("tiny"))
    bench_file = os.path.join(path, "BENCHMARK.json")
    with open(bench_file) as f:
        bench = json.load(f)
    assert Q1["name"] not in [w["name"] for w in bench["workloads"]]
    bench["workloads"].append(Q1)
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in Q1_METRICS:
            m["workloads"].append(Q1["name"])
    with open(bench_file, "w") as f:
        json.dump(bench, f)
    q1 = os.path.join(path, "vssbench", "traffic", "graph-q1.json")
    with open(q1) as f:
        t = json.load(f)
    t["warmup_steps"] = 2
    with open(q1, "w") as f:
        json.dump(t, f)
    return path


def run(root, name, make_system=cell.port_system, seed=2**31 + 91):
    return cell.run_cell(name, seed, 0.2, False, "cpu", time.perf_counter(), root=root,
                         make_system=make_system)


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_of_a_new_cell_is_correct(root, name):
    r = run(root, name)
    assert r["correct"], r["check"]
    assert r["failed"] == 0 and r["attempted"] >= 1
    assert 0.9 <= r["metrics"]["recall"]["value"] <= 1.0
    assert {"qps", "p95_ms", "recall", "setup_s"} <= set(r["metrics"])


@pytest.mark.parametrize("name", CELLS)
def test_the_control_of_a_new_cell_is_not_correct(root, name):
    r = run(root, name, make_system=ControlSystem)
    assert not r["correct"]
    assert numbers(r)["dist_err"] > 10 * r["check"]["dist_err"]["limit"]


@pytest.mark.parametrize("name", CELLS)
def test_a_repeated_row_in_a_new_cell_is_not_correct(root, name):
    r = run(root, name, make_system=factory(Repeated))
    assert not r["correct"] and numbers(r)["bad_answers"] > 0


def test_a_search_leaving_out_slots_is_not_correct_in_the_embedding_cell(root):
    r = run(root, "openai1m.graph-k10", make_system=factory(QuarterSkipped))
    n = numbers(r)
    assert not r["correct"] and n["knn_missed"] > r["check"]["knn_missed"]["limit"]
    assert n["dist_err"] <= r["check"]["dist_err"]["limit"] and n["bad_answers"] == 0


def _ctx(kernels, calls, batch, config):
    """A context whose trace holds `calls` search spans and the kernels
    (name, ms) launched inside them."""
    ops = [(name, "kernel", 0.0, ms * 1e3, None) for name, ms in kernels]
    trace = types.SimpleNamespace(calls=lambda kind: calls if kind == "search" else 0,
                                  ops_of=lambda kind, cats=None: ops if kind == "search" else [])
    return types.SimpleNamespace(trace=trace, config=config,
                                 traffic={"ops": [{"op": "search", "batch": batch}]})


def test_the_pivot_readers_arithmetic():
    pivot_ms = cell.reader("pivot_ms.graph", BENCH)
    roof = cell.reader("pivot_roofline.graph", BENCH)
    cfg = cell.load_json(ROOT, "vssbench/configs/openai1m.json")
    k = "void vss::pivot_product_kernel<signed char>(float const*)"
    ctx = _ctx([(k, 0.5), (k, 0.5), ("void vss::beam_kernel<signed char>", 2.0)], 2, 512, cfg)
    assert pivot_ms(ctx) == pytest.approx(0.5)
    # 2 B P d at 989 TFLOP/s, P = 990,000 / 16
    want = 2 * 512 * 61875 * 1536 / 989e12
    assert roof(ctx) == pytest.approx(100 * want / 0.5e-3)
    # at one query the bytes bound: the int8 rows and the f32 query
    one = _ctx([(k, 0.1)], 1, 1, cfg)
    assert roof(one) == pytest.approx(100 * (61875 * 1536 + 1536 * 4) / 3.35e12 / 0.1e-3)
    # no such kernel (an f32 product): nothing
    assert pivot_ms(_ctx([("gemm", 1.0)], 2, 512, cfg)) is None
    assert roof(_ctx([("gemm", 1.0)], 2, 512, cfg)) is None
    assert pivot_ms(types.SimpleNamespace(trace=None)) is None


def test_the_q1_traffic_reads_one_query_a_call():
    from vssbench.loop import load_traffic

    t = load_traffic("graph-q1")
    assert t["ops"] == [{"op": "search", "batch": 1, "k": 10, "ef": 64}]
    assert t["recall_steps"] == list(range(64, 320)) and t["warmup_steps"] == 64
    assert t["trace_steps"] == 1024 and t["reservoir_calls"] == 16
    assert np.all(np.diff(t["recall_steps"]) == 1)
