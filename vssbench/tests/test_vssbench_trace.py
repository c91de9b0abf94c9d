"""The trace reduction and each per-layer reader on a hand-made event
list: interval union, attribution of kernels to spans by correlation,
per-call division, kernels by name, the roofline arithmetic."""
import pytest

from vssbench import cell, peaks
from vssbench.loop import Op, Outcome
from vssbench.trace import Trace, merged, union_us


def X(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


def span(kind, ts, dur):
    return X("user_annotation", "vssbench." + kind, ts, dur)


def launch(corr, ts):
    return X("cuda_runtime", "cudaLaunchKernel", ts, 1, correlation=corr)


def kern(name, ts, dur, corr, cat="kernel"):
    return X(cat, name, ts, dur, correlation=corr)


def search_trace():
    """Two search calls [0, 100) and [100, 200): the first runs the beam
    (10 us) and a GEMM (20 us, overlapping), the second the beam and a
    copy; one kernel launched outside any span."""
    return [
        span("search", 0, 100), span("search", 100, 100),
        launch(1, 5), kern("void beam_kernel<8>(BeamArgs)", 30, 10, 1),
        launch(2, 6), kern("gemm", 35, 20, 2),
        launch(3, 110), kern("beam_kernel", 150, 10, 3),
        launch(4, 120), kern("Memcpy DtoH", 170, 5, 4, cat="gpu_memcpy"),
        launch(5, 250), kern("stray", 260, 5, 5),
        X("cpu_op", "aten::copy_", 50, 40), X("cpu_op", "aten::mm", 1, 2),
    ]


def device_only(events):
    """The same events as the device-alone phase records them."""
    return [e for e in events if e["cat"] in ("kernel", "gpu_memcpy", "gpu_memset",
                                              "cuda_runtime")]


class Ctx:
    def __init__(self, events=None, ops=(), traffic=None, config=None, lo=0, hi=0):
        self.trace = Trace(events) if events is not None else None
        self.device_trace = Trace(device_only(events)) if events is not None else None
        self.outcome = Outcome(ops=list(ops), window_s=2.0, lo=lo, hi=hi)
        self.traffic = traffic or {}
        self.config = config or {}


def read(name, ctx):
    return cell.reader(name)(ctx)


def test_union_and_merge():
    assert union_us([(0, 10), (5, 15), (20, 30)]) == 25
    assert union_us([]) == 0
    assert merged([(5, 6), (0, 2), (1, 3)]) == [[0, 3], [5, 6]]


def test_kernels_belong_to_the_span_of_their_launch():
    t = Trace(search_trace())
    assert t.calls("search") == 2
    names = sorted(op[0] for op in t.ops_of("search"))
    assert names == ["Memcpy DtoH", "beam_kernel", "gemm", "void beam_kernel<8>(BeamArgs)"]
    assert (t.t0, t.t1) == (0, 200)
    # busy: [30, 55) and [150, 160) and [170, 175); the stray is outside
    assert t.busy_us() == 40


def test_graph_readers_divide_per_call():
    # steps 0 and 1 untraced (1.8 ms between them), 2 and 3 traced
    ops = [Op("search", 0, 0.0, 0.0008, 512, "window"),
           Op("search", 1, 0.001, 0.0018, 512, "window"),
           Op("search", 2, 0.002, 0.0028, 512, "window", profiled=True),
           Op("search", 3, 0.003, 0.0038, 512, "window", profiled=True),
           Op("search", 0, -1.0, 0.0, 512, "warmup")]
    ctx = Ctx(search_trace(), ops, traffic={"trace_steps": 2})
    assert read("busy_ms.graph", ctx) == pytest.approx(40 / 1e3 / 2)
    assert read("kernels.graph", ctx) == 1.5          # three kernels, the copy is no kernel
    assert read("beam_ms.graph", ctx) == pytest.approx(20 / 1e3 / 2)
    # the device alone holds 45 us of work over its 2 steps; the untraced
    # steps last 1.0 ms (to the next step's start) and 0.8 ms (to its own
    # end, the profiler starting after it)
    assert read("idle_share.read", ctx) == pytest.approx(1 - 45e-6 / 2 * 2 / 0.0018)
    assert read("idle_share.write", ctx) is None
    assert read("busy_ms.scan", ctx) is None


def test_readers_find_nothing_without_a_trace_or_their_kernels():
    assert read("busy_ms.graph", Ctx()) is None
    ev = [span("search", 0, 100), launch(1, 5), kern("gemm", 30, 10, 1)]
    assert read("beam_ms.graph", Ctx(ev)) is None
    assert read("idle_share.read", Ctx([span("search", 0, 10)],
                                       traffic={"trace_steps": 1})) is None
    untraced_only = [Op("search", 0, 0.0, 0.001, 512, "window")]
    assert read("idle_share.read", Ctx(search_trace(), untraced_only[:0],
                                       traffic={"trace_steps": 2})) is None
    assert read("idle_share.read", Ctx(search_trace(), untraced_only,
                                       traffic={"trace_steps": 0})) is None


def test_breakdown_sums_by_name_and_labels_gaps():
    t = Trace(search_trace())
    top = dict(t.top_device_ops())
    assert top["gemm"] == pytest.approx(20e-6)
    gaps = dict(t.idle_gaps())
    # [55, 150) begins inside aten::copy_; [0, 30), [160, 170) and
    # [175, 200) inside a search span and no op of it
    assert gaps == pytest.approx({"aten::copy_": 95e-6, "vssbench.search": 65e-6})


def test_write_readers():
    ev = [span("insert", 0, 100), launch(1, 5), kern("select_kernel", 20, 30, 1),
          launch(2, 6), kern("beam_kernel", 50, 30, 2), span("delete", 100, 10),
          launch(3, 101), kern("fill", 102, 2, 3)]
    ops = [Op("insert", 3, 0.0, 0.020, 1024, "window"), Op("insert", 4, 1.0, 1.030, 1024, "window"),
           Op("insert", 5, 2.0, 2.5, 1024, "window", profiled=True),
           Op("delete", 3, 0.0, 0.002, 1024, "window"), Op("insert", 0, 0, 9, 1024, "warmup")]
    ctx = Ctx(ev, ops, traffic={"trace_steps": 1})
    assert read("kernels.write", ctx) == 2
    assert read("wave_ms.write", ctx) == pytest.approx(25.0)
    assert read("delete_ms.write", ctx) == pytest.approx(2.0)
    # 62 us of device work in the one traced step; the untraced steps 3
    # (to step 4's start, 1.0 s) and 4 (to its end, 0.030 s)
    assert read("idle_share.write", ctx) == pytest.approx(1 - 62e-6 * 2 / 1.030)
    assert read("insert_rows_per_s", ctx) == pytest.approx(3 * 1024 / 2.0)


def test_end_to_end_readers():
    ops = [Op("search", s, s * 0.01, s * 0.01 + 0.001 * (1 + s % 20), 512, "window")
           for s in range(100)] + [Op("search", 0, 0, 5, 512, "warmup")]
    ctx = Ctx(ops=ops)
    assert read("qps", ctx) == pytest.approx(100 * 512 / 2.0)
    assert read("p95_ms", ctx) == pytest.approx(19.05, rel=1e-3)


def test_scan_pass_roofline_arithmetic():
    # 512 x 1,000,000 x 128: 131 GFLOP at 989 TFLOP/s bounds it (0.1325 ms)
    b = peaks.scan_pass_bound_s(512, 1_000_000, 128, "int8")
    assert b == pytest.approx(2 * 512 * 1e6 * 128 / 989e12)
    # one query: the tape's bytes bound it
    one = peaks.scan_pass_bound_s(1, 1_000_000, 128, "int8")
    assert one == pytest.approx((128e6 + 512 + 31250 * 4) / 3.35e12)
    assert peaks.scan_pass_bound_s(512, 1_000_000, 128, "f32") == pytest.approx(
        2 * 512 * 1e6 * 128 / 67e12)
    ev = [span("scan_search", 0, 1000), launch(1, 1),
          kern("void native_segmin_kernel<signed char>(...)", 10, 265, 1),
          launch(2, 2), kern("rescore_topk_kernel", 300, 300, 2)]
    ctx = Ctx(ev, traffic={"ops": [{"op": "scan_search", "batch": 512, "k": 100}]},
              config={"corpus": {"dims": 128}, "index": {"storage_dtype": "int8"}},
              hi=1_000_000)
    assert read("scan_pass_roofline", ctx) == pytest.approx(100 * b / 265e-6)
