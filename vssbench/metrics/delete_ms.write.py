"""Mean time of an `HNSWIndex.delete` call of the window, from the call
to the end of its device work (ms, the benchmark's span on the host
clock; the untraced calls only)."""


def read(ctx):
    ops = [o for o in ctx.outcome.window_ops(("delete",)) if not o.profiled]
    if not ops:
        return None
    return sum(o.t1 - o.t0 for o in ops) / len(ops) * 1e3
