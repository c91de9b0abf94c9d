"""Rows inserted in the window over the window's seconds (host clock)."""


def read(ctx):
    ops = ctx.outcome.window_ops(("insert",))
    if not ops:
        return None
    return sum(o.items for o in ops) / ctx.outcome.window_s
