"""The device's idle time inside the port's `vss.search` spans, per
`HNSWIndex.search` call (ms, full trace; `port_spans.port_idle_ms`): the
host in the port's Python, its intake copy or its launches while no
device operation runs. Nothing where the program records no such span."""
from vssbench.port_spans import port_idle_ms


def read(ctx):
    return port_idle_ms(ctx.trace, "vss.search", "search")
