"""Device kernels per `HNSWIndex.insert` call, from the trace."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.calls("insert"):
        return None
    ops = t.ops_of("insert", ("kernel",))
    if not ops:
        return None
    return len(ops) / t.calls("insert")
