"""The graph search's pivot product (today `pivot_product_kernel`,
`csrc/pivots.cu`) against its roofline (%): the product's least time over
the device time of its kernels per `HNSWIndex.search` call. Nothing where
no such kernel runs.

The least time counts the product's work whatever does it: the f32
product of B queries and P pivots of d values, 2 B P d operations at the
bf16 tensor rate, or its bytes read once, the pivots' rows (P d values
of the tape's dtype) and the f32 queries (B d x 4), at the device
memory's rate, whichever is longer. B is the traffic's batch and d the
configuration's width. P is the real pivot count, not its padding to a
power of two: the level distribution's expectation, rows / m (a row
reaches level 1 with odds 1/m), which the `pivots.real` of the run's
set-up line confirms."""
from vssbench.peaks import _ITEM, H100

NAME = "pivot_product_kernel"


def pivots(config: dict) -> float:
    """The expected real pivot count of a configuration's index."""
    return config["corpus"]["rows"] / config["index"]["m"]


def bound_s(batch: int, config: dict, peaks=H100) -> float:
    d = config["corpus"]["dims"]
    p = pivots(config)
    flops = 2.0 * batch * p * d
    nbytes = p * d * _ITEM[config["index"]["storage_dtype"]] + batch * d * 4
    return max(flops / peaks["bf16_flops"], nbytes / peaks["hbm_bytes"])


def read(ctx):
    t = ctx.trace
    if t is None or not t.calls("search"):
        return None
    ops = [op for op in t.ops_of("search", ("kernel",)) if NAME in op[0]]
    if not ops:
        return None
    per_call_s = sum(op[3] for op in ops) * 1e-6 / t.calls("search")
    batch = next(op["batch"] for op in ctx.traffic["ops"] if op["op"] == "search")
    return 100.0 * bound_s(batch, ctx.config) / per_call_s
