"""Device busy time per `HNSWIndex.search` call (ms): the union of the
device operations launched inside the traced search spans, over their
number."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.calls("search"):
        return None
    ops = t.ops_of("search")
    if not ops:
        return None
    return t.busy_us(ops) / 1e3 / t.calls("search")
