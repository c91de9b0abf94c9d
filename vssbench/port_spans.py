"""The port's own spans in the full trace, and the device's idle time
inside and outside them.

While the profiler runs, the program records its phases as
`record_function` spans named `vss.<path>[.<phase>]` (`vss.search`,
`vss.search.intake`, `vss.scan`, ...). They land in the trace's host
events (`Trace.host`), on the same clock as the device's operations. The
device's idle time is the traced window less the union of its clipped
operations, as `Trace.busy_us` counts it; here it is split at the edges
of the port's spans. A trace of a program that records no such span
gives None everywhere.
"""
from __future__ import annotations

from vssbench.loop import READS, WRITES
from vssbench.trace import merged

PREFIX = "vss."


def spans(trace, names=None) -> list:
    """(start, end) of the port's spans, clipped to the window: those named
    in `names`, or every one."""
    out = []
    for name, ts, dur in trace.host:
        if name.startswith(PREFIX) and (names is None or name in names):
            s, e = max(ts, trace.t0), min(ts + dur, trace.t1)
            if e > s:
                out.append((s, e))
    return out


def idle_gaps(trace) -> list:
    """The device's idle intervals in the window."""
    gaps, prev = [], trace.t0
    for s, e in merged(trace._clipped(trace.device)):
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if trace.t1 > prev:
        gaps.append((prev, trace.t1))
    return gaps


def overlap_us(a, b) -> float:
    """Length of the intersection of two unions of intervals."""
    a, b = merged(a), merged(b)
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def read_calls(trace) -> int:
    """The read calls of a read-only traced window; 0 where it writes."""
    if any(trace.calls(k) for k in WRITES):
        return 0
    return sum(trace.calls(k) for k in READS)


def port_idle_ms(trace, span_name: str, kind: str):
    """The device's idle ms a call of `kind` inside the port's spans named
    `span_name`; None without such spans or calls."""
    if trace is None or not trace.calls(kind):
        return None
    inside = spans(trace, (span_name,))
    if not inside:
        return None
    return overlap_us(idle_gaps(trace), inside) / 1e3 / trace.calls(kind)


def client_idle_ms(trace):
    """The device's idle ms a read call outside every port span; None
    without port spans or read calls, or where the window writes."""
    if trace is None:
        return None
    n = read_calls(trace)
    port = spans(trace)
    if not n or not port:
        return None
    gaps = idle_gaps(trace)
    idle = sum(e - s for s, e in gaps)
    return (idle - overlap_us(gaps, port)) / 1e3 / n


def intake_ms(trace):
    """Host ms a read call spends in the port's intake spans; None without
    them or read calls, or where the window writes."""
    if trace is None:
        return None
    n = read_calls(trace)
    intake = spans(trace, tuple(PREFIX + k + ".intake" for k in ("search", "scan")))
    if not n or not intake:
        return None
    return sum(e - s for s, e in intake) / 1e3 / n
