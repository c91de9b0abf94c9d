"""Device time of the graph search's pivot product (`csrc/pivots.cu`
`pivot_product_kernel`, every launch of it: one a column group) per
`HNSWIndex.search` call (ms). Nothing where the search runs no such
kernel (an f32 product instead)."""

NAME = "pivot_product_kernel"


def read(ctx):
    t = ctx.trace
    if t is None or not t.calls("search"):
        return None
    ops = [op for op in t.ops_of("search", ("kernel",)) if NAME in op[0]]
    if not ops:
        return None
    return sum(op[3] for op in ops) / 1e3 / t.calls("search")
