"""The readers of the port's own spans (`port_spans.py` and the metrics
`port_idle_ms.*`, `client_idle_ms.read`, `intake_ms.read`) on hand-made
event lists: the arithmetic, nothing without port spans, idle split at a
span's edge, and the exact split of the window's idle time."""
import pytest

from vssbench import cell, port_spans
from vssbench.trace import Trace

from .test_vssbench_trace import X, kern, launch, search_trace, span


def vss(name, ts, dur):
    return X("user_annotation", "vss." + name, ts, dur)


def graph_trace():
    """Two search calls [0, 100) and [100, 200). In each the port's span
    leaves room for the client before and after it: [5, 90) with its
    intake [5, 20), then [105, 190) with its intake [105, 115). The
    device copies the queries in [12, 18), runs kernels in [30, 55) and
    [150, 160), and copies an answer out in [192, 197)."""
    return [
        span("search", 0, 100), span("search", 100, 100),
        vss("search", 5, 85), vss("search.intake", 5, 15), vss("search.beam", 25, 60),
        vss("search", 105, 85), vss("search.intake", 105, 10),
        launch(1, 12), kern("Memcpy HtoD (Pageable -> Device)", 12, 6, 1, cat="gpu_memcpy"),
        launch(2, 25), kern("beam_kernel", 30, 25, 2),
        launch(3, 120), kern("beam_kernel", 150, 10, 3),
        launch(4, 191), kern("Memcpy DtoH", 192, 5, 4, cat="gpu_memcpy"),
        X("cpu_op", "aten::copy_", 10, 9),
    ]


class Ctx:
    def __init__(self, events):
        self.trace = Trace(events)


def read(name, events):
    return cell.reader(name)(Ctx(events))


def test_the_readers_arithmetic():
    ev = graph_trace()
    # idle gaps: [0, 12) [18, 30) [55, 150) [160, 192) [197, 200), 154 us;
    # inside the port's spans [5, 12) [18, 30) [55, 90) [105, 150) [160, 190)
    assert read("port_idle_ms.graph", ev) == pytest.approx(129 / 1e3 / 2)
    # outside: [0, 5) [90, 105) [190, 192) [197, 200)
    assert read("client_idle_ms.read", ev) == pytest.approx(25 / 1e3 / 2)
    assert read("intake_ms.read", ev) == pytest.approx((15 + 10) / 1e3 / 2)
    assert read("port_idle_ms.scan", ev) is None


def test_the_two_idle_metrics_split_the_windows_idle_time_exactly():
    for ev in (graph_trace(), graph_trace() + [vss("search.seed", 20, 4)]):
        t = Trace(ev)
        calls = t.calls("search")
        split = (read("port_idle_ms.graph", ev) + read("client_idle_ms.read", ev)) * calls
        assert split * 1e3 == pytest.approx(t.window_us - t.busy_us(), abs=1e-9)


def test_idle_that_straddles_a_spans_edge_is_split_at_the_edge():
    # one gap [10, 90) across the port span [40, 70): 30 in, 50 out
    ev = [span("scan_search", 0, 100), vss("scan", 40, 30), vss("scan.intake", 40, 5),
          launch(1, 0), kern("native_segmin", 0, 10, 1),
          launch(2, 80), kern("Memcpy DtoH", 90, 10, 2, cat="gpu_memcpy")]
    assert read("port_idle_ms.scan", ev) == pytest.approx(30 / 1e3)
    assert read("client_idle_ms.read", ev) == pytest.approx(50 / 1e3)
    assert read("intake_ms.read", ev) == pytest.approx(5 / 1e3)
    assert read("port_idle_ms.graph", ev) is None


def test_spans_are_clipped_to_the_window():
    # a port span that begins before the first benchmark span counts from it
    ev = [span("search", 10, 90), vss("search", 0, 50), vss("search.intake", 0, 20),
          launch(1, 60), kern("k", 60, 40, 1)]
    assert read("port_idle_ms.graph", ev) == pytest.approx(40 / 1e3)
    assert read("client_idle_ms.read", ev) == pytest.approx(10 / 1e3)
    assert read("intake_ms.read", ev) == pytest.approx(10 / 1e3)


def test_nothing_without_port_spans_a_trace_or_reads():
    for name in ("port_idle_ms.graph", "port_idle_ms.scan", "client_idle_ms.read",
                 "intake_ms.read"):
        assert read(name, search_trace()) is None
        assert cell.reader(name)(type("C", (), {"trace": None})()) is None
    # a window that writes: the idle outside the port is not the client's
    ev = graph_trace() + [span("insert", 200, 50), launch(9, 210), kern("wave", 220, 10, 9)]
    assert read("client_idle_ms.read", ev) is None
    assert read("intake_ms.read", ev) is None


def test_port_spans_leave_the_benchmarks_own_readers_as_they_were():
    t = Trace(graph_trace())
    assert t.calls("search") == 2 and [s[0] for s in t.spans] == ["search", "search"]
    assert len(t.ops_of("search")) == 4
    assert port_spans.overlap_us([(0, 10), (20, 30)], [(5, 25)]) == 10
    assert port_spans.overlap_us([], [(0, 1)]) == 0
