"""Host milliseconds per frame of the spatial index and its host callers
(runtime.index, the C++ index through ctypes): the program's stage spans
gpismap.update.cull, .update.replay, .retrain.collect and .retrain.grid
summed over the traced episode. None where the program has no such
span."""

STAGES = {"gpismap.update.cull", "gpismap.update.replay",
          "gpismap.retrain.collect", "gpismap.retrain.grid"}


def read(ctx):
    tr = ctx.trace
    if tr is None or ctx.mix["loop"] != "stream" or not ctx.traced_items:
        return None
    ns = [e - s for n, s, e in tr.host if n in STAGES]
    if not ns:
        return None
    return sum(ns) / 1e6 / ctx.traced_items
