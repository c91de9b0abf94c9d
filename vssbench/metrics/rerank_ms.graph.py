"""Device time of the graph search's f32 rerank (`csrc/rerank.cu`
`rerank_pool_kernel`) per `HNSWIndex.search` call (ms). Nothing where the
search runs no such kernel (no rerank tape, or a program whose rerank is
torch ops)."""

NAME = "rerank_pool_kernel"


def read(ctx):
    t = ctx.trace
    if t is None or not t.calls("search"):
        return None
    ops = [op for op in t.ops_of("search", ("kernel",)) if NAME in op[0]]
    if not ops:
        return None
    return sum(op[3] for op in ops) / 1e3 / t.calls("search")
