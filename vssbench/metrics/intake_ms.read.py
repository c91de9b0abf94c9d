"""Host time a read call spends in the port's intake spans
(`vss.search.intake`, `vss.scan.intake`: the queries copied to the
device and scaled), in ms, full trace (`port_spans.intake_ms`). Nothing
where the program records no such span, or in a cell that writes."""
from vssbench.port_spans import intake_ms


def read(ctx):
    return intake_ms(ctx.trace)
