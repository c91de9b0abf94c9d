"""Device kernels per `HNSWIndex.search` call, from the trace (torch's
own kernels as well as the port's hand-written ones)."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.calls("search"):
        return None
    ops = t.ops_of("search", ("kernel",))
    if not ops:
        return None
    return len(ops) / t.calls("search")
