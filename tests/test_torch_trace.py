"""The port's spans (`vss_tpu_torch/utils/trace.py`): free while no
profiler runs, each serving call's phases in order inside its span while
one does, the answers the same either way; the bulk builder's phase
seconds; `explain_analyze`'s operator times."""
import numpy as np
import pytest
import torch

from vss_tpu_torch import Database, HNSWConfig, HNSWIndex, col, const, fn
from vss_tpu_torch.query.exec import analyze_plan
from vss_tpu_torch.utils import trace

N, D = 3000, 16   # above scan_topk's 16 x 128 rows: its native route

SEARCH = ["vss.search.intake", "vss.search.pivots", "vss.search.seed", "vss.search.beam",
          "vss.search.rerank"]
SCAN = ["vss.scan.intake", "vss.scan.pass", "vss.scan.select", "vss.scan.rescore"]
# spans inside a phase: the pivot product inside the seeding
NESTED = {"vss.search.seed": ["vss.search.product"]}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the machine (as in test_torch_crud.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def index():
    rng = np.random.default_rng(0)
    centers = rng.uniform(0, 100, (12, D))
    vecs = np.round(centers[rng.integers(0, 12, N)] + rng.normal(0, 8, (N, D)))
    q = np.round(centers[rng.integers(0, 12, 24)] + rng.normal(0, 8, (24, D)))
    idx = HNSWIndex.build(vecs.astype(np.float32), HNSWConfig(dims=D, storage_dtype="int8"),
                          device="cpu")
    return idx, q.astype(np.float32)


def _forbid_record_function(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("record_function built with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)


def test_span_is_the_shared_null_context_without_a_profiler(index, monkeypatch):
    _forbid_record_function(monkeypatch)
    assert trace.span("vss.x") is trace.span("vss.y")
    with trace.span("vss.x"):
        pass
    idx, q = index
    idx.search(q, 5)
    idx.scan_search(q, 5)


def test_span_records_under_the_profiler():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.span("vss.test"):
            torch.ones(4).sum()
    assert [e.name for e in prof.events() if e.name.startswith("vss.")] == ["vss.test"]


def _spans(prof):
    ev = [e for e in prof.events() if e.name.startswith("vss.")]
    return sorted(((e.name, e.time_range.start, e.time_range.end) for e in ev),
                  key=lambda s: s[1])


@pytest.mark.parametrize("path, outer, children", [("search", "vss.search", SEARCH),
                                                    ("scan_search", "vss.scan", SCAN)])
def test_each_call_records_its_phases_in_order_inside_its_span(index, path, outer, children):
    idx, q = index
    call = getattr(idx, path)
    halves = (q[:12], q[12:])
    off = [call(h, 5) for h in halves]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        on = [call(h, 5) for h in halves]
    spans = _spans(prof)
    tops = [s for s in spans if s[0] == outer]
    assert len(tops) == 2
    nested = [n for c in children for n in NESTED.get(c, [])]
    for name, t0, t1 in tops:
        inside = [s for s in spans if s[0] != outer and t0 <= s[1] and s[2] <= t1]
        phases = [s for s in inside if s[0] not in nested]
        assert [s[0] for s in phases] == children
        assert all(a[2] <= b[1] for a, b in zip(phases, phases[1:]))
        for p in phases:
            within = [s[0] for s in inside if s[0] in nested and p[1] <= s[1] and s[2] <= p[2]]
            assert within == NESTED.get(p[0], []), p[0]
    assert len(spans) == 2 * (1 + len(children) + len(nested))
    # the answers are the same, bit for bit, with the profiler on and off
    for a, b in zip(off, on):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_the_bulk_builder_records_its_phases_and_their_seconds():
    rng = np.random.default_rng(1)
    vecs = rng.normal(0, 1, (300, 8)).astype(np.float32)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        idx = HNSWIndex.build(vecs, HNSWConfig(dims=8), method="exact", device="cpu")
    phases = ["candidates", "refine", "backlinks", "levels", "repair"]
    names = [s[0] for s in _spans(prof) if s[0].startswith("vss.build.")]
    assert names == ["vss.build." + p for p in phases]
    secs = idx.build_stats["phase_s"]
    assert list(secs) == phases and all(s >= 0 for s in secs.values())
    # without a profiler the seconds are still there
    again = HNSWIndex.build(vecs, HNSWConfig(dims=8), method="exact", device="cpu")
    assert list(again.build_stats["phase_s"]) == phases


def test_explain_analyze_operator_times_add_up_to_no_more_than_the_root():
    from vss_tpu_torch.query.rewrite import optimize

    db = Database(device="cpu")
    rng = np.random.default_rng(2)
    db.create_table("items", {"id": np.arange(500, dtype=np.int64),
                              "vec": rng.normal(0, 1, (500, 8)).astype(np.float32)})
    db.create_hnsw_index("idx", "items", "vec", metric="l2sq", seed=0)
    dist = fn("array_distance", col("vec"), const(np.zeros(8, np.float32)))
    q = db.query("items").order_by(dist).limit(5).select("id")
    plan = optimize(db, q.plan())
    timings, result = analyze_plan(db, plan)
    assert len(result["id"]) == 5

    def nodes(n):
        yield n
        for c in n.children():
            yield from nodes(c)

    every = list(nodes(plan))
    assert len(every) >= 2 and all(id(n) in timings for n in every)
    root = timings[id(plan)][0]
    own = [timings[id(n)][0] - sum(timings[id(c)][0] for c in n.children()) for n in every]
    assert all(o >= 0 for o in own)
    assert sum(own) <= root * (1 + 1e-9)
    report, _ = db.explain_analyze(q.plan())
    assert "HNSW_INDEX_SCAN" in report and "HNSW Index: idx" in report
