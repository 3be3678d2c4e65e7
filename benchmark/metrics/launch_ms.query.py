"""Host milliseconds per batch to launch a query (models.cluster.map_test):
the program's stage spans gpismap.test.candidates, .test.plan, .test.eval
and .test.blend summed over the traced batches. Their excess over the
tile kernel's device time is the query's host bound. None where the
program has no such span."""

STAGES = {"gpismap.test.candidates", "gpismap.test.plan",
          "gpismap.test.eval", "gpismap.test.blend"}


def read(ctx):
    tr = ctx.trace
    if tr is None or ctx.mix["loop"] != "query" or not ctx.traced_items:
        return None
    ns = [e - s for n, s, e in tr.host if n in STAGES]
    if not ns:
        return None
    return sum(ns) / 1e6 / ctx.traced_items
