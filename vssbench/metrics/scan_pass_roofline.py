"""The exact scan's phase A (today K2, `csrc/scan.cu`
`native_segmin_kernel`) against its roofline (%): the least time of the
pass (`peaks.scan_pass_bound_s`: every query against every live row,
counted from the shapes) over the device time of its kernels per
`HNSWIndex.scan_search` call. Nothing where no such kernel runs."""
from vssbench.peaks import scan_pass_bound_s

NAME = "native_segmin"


def read(ctx):
    t = ctx.trace
    if t is None or not t.calls("scan_search"):
        return None
    ops = [op for op in t.ops_of("scan_search", ("kernel",)) if NAME in op[0]]
    if not ops:
        return None
    per_call_s = sum(op[3] for op in ops) * 1e-6 / t.calls("scan_search")
    batch = next(op["batch"] for op in ctx.traffic["ops"] if op["op"] == "scan_search")
    live = ctx.outcome.hi - ctx.outcome.lo
    idx = ctx.config["index"]
    bound = scan_pass_bound_s(batch, live, ctx.config["corpus"]["dims"], idx["storage_dtype"])
    return 100.0 * bound / per_call_s
