"""95th percentile of the latency of every request of the window, from
its send to its verdicts in host memory (host clock)."""
import numpy as np


def read(ctx):
    if not ctx.units:
        return None
    lat = np.array([t1 - t0 for t0, t1, _ in ctx.units])
    return float(np.percentile(lat, 95)) * 1e3
