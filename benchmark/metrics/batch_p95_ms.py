"""The 95th percentile of every batch's test() latency in the window,
each ended by a device synchronize."""
import numpy as np


def read(ctx):
    if ctx.mix["loop"] != "query" or not ctx.latencies:
        return None
    return float(np.percentile(np.asarray(ctx.latencies) * 1e3, 95))
