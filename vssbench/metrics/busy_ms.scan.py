"""Device busy time per `HNSWIndex.scan_search` call (ms): the union of
the device operations launched inside the traced scan spans, over their
number."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.calls("scan_search"):
        return None
    ops = t.ops_of("scan_search")
    if not ops:
        return None
    return t.busy_us(ops) / 1e3 / t.calls("scan_search")
