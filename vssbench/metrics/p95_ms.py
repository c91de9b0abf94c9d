"""The 95th percentile of the latency of every read call of the window,
from the call to its result on the host (ms, host clock)."""
import numpy as np

from vssbench.loop import READS


def read(ctx):
    lat = [o.t1 - o.t0 for o in ctx.outcome.window_ops(READS)]
    if not lat:
        return None
    return float(np.percentile(np.asarray(lat), 95.0)) * 1e3
