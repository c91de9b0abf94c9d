"""Share of the window's untraced steps in which no operation ran on the
device (`trace.untraced_idle_share`: the device's busy time a step from
the trace of the device alone, against those steps' host-clock seconds),
in a cell that reads only."""
from vssbench.loop import READS, WRITES
from vssbench.trace import untraced_idle_share


def read(ctx):
    t = ctx.trace
    if t is None or any(t.calls(k) for k in WRITES) or not any(t.calls(k) for k in READS):
        return None
    return untraced_idle_share(ctx.outcome, ctx.device_trace, ctx.traffic["trace_steps"])
