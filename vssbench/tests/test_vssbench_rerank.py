"""The reader of `rerank_ms.graph` on a hand-made trace: the rerank
kernel's device time inside the search spans, divided by the calls;
nothing without a trace, without search calls or without the kernel (a
program whose rerank is torch ops)."""
import pytest

from vssbench import cell
from vssbench.trace import Trace


def X(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


def span(ts, dur):
    return X("user_annotation", "vssbench.search", ts, dur)


def launch(corr, ts):
    return X("cuda_runtime", "cudaLaunchKernel", ts, 1, correlation=corr)


def kern(name, ts, dur, corr):
    return X("kernel", name, ts, dur, correlation=corr)


class Ctx:
    def __init__(self, events=None):
        self.trace = Trace(events) if events is not None else None


RERANK = "void vss::rerank_pool_kernel<float, true>(vss::RerankArgs)"


def test_rerank_ms_reads_the_kernel_per_search_call():
    """Two calls: the rerank runs 40 and 60 us, the beam beside it; a
    rerank launched outside any search span is not counted."""
    ev = [span(0, 100), span(100, 100),
          launch(1, 5), kern("void vss::beam_kernel<signed char>(BeamArgs)", 20, 30, 1),
          launch(2, 6), kern(RERANK, 55, 40, 2),
          launch(3, 110), kern(RERANK, 130, 60, 3),
          launch(4, 250), kern(RERANK, 260, 50, 4)]
    assert cell.reader("rerank_ms.graph")(Ctx(ev)) == pytest.approx(100 / 1e3 / 2)


def test_rerank_ms_reads_nothing_without_its_kernel():
    read = cell.reader("rerank_ms.graph")
    torch_ops = [span(0, 100), launch(1, 5), kern("void at::native::reduce_kernel<512>", 20, 9, 1),
                 launch(2, 6), kern("void at::native::radixSortKVInPlace<2>", 30, 3, 2)]
    assert read(Ctx(torch_ops)) is None
    assert read(Ctx([launch(1, 5), kern(RERANK, 20, 9, 1)])) is None
    assert read(Ctx()) is None
