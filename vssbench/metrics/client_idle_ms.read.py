"""The device's idle time outside every port span, per read call (ms,
full trace; `port_spans.client_idle_ms`): the client's copies of the
answers to the host and its loop, which the port cannot reach. With
`port_idle_ms.*` it splits the traced window's idle time exactly.
Nothing where the program records no span, or in a cell that writes."""
from vssbench.port_spans import client_idle_ms


def read(ctx):
    return client_idle_ms(ctx.trace)
