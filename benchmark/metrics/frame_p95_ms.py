"""The 95th percentile of every frame's latency in the window: its
update() and its test(), each ended by a device synchronize."""
import numpy as np


def read(ctx):
    if ctx.mix["loop"] != "stream" or not ctx.latencies:
        return None
    return float(np.percentile(np.asarray(ctx.latencies) * 1e3, 95))
