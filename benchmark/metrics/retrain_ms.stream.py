"""Host milliseconds per frame of the retrain and the factor refresh
(models.cluster): the program's stage spans gpismap.retrain.mirror,
.retrain.fit and .retrain.refresh summed over the traced episode. None
where the program has no such span."""

STAGES = {"gpismap.retrain.mirror", "gpismap.retrain.fit",
          "gpismap.retrain.refresh"}


def read(ctx):
    tr = ctx.trace
    if tr is None or ctx.mix["loop"] != "stream" or not ctx.traced_items:
        return None
    ns = [e - s for n, s, e in tr.host if n in STAGES]
    if not ns:
        return None
    return sum(ns) / 1e6 / ctx.traced_items
