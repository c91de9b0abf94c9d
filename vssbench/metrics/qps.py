"""Queries answered in the window over the window's seconds (host clock)."""
from vssbench.loop import READS


def read(ctx):
    ops = ctx.outcome.window_ops(READS)
    if not ops:
        return None
    return sum(o.items for o in ops) / ctx.outcome.window_s
