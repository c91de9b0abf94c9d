"""The device's idle time inside the port's `vss.scan` spans, per
`HNSWIndex.scan_search` call (ms, full trace; `port_spans.port_idle_ms`).
Nothing where the program records no such span."""
from vssbench.port_spans import port_idle_ms


def read(ctx):
    return port_idle_ms(ctx.trace, "vss.scan", "scan_search")
