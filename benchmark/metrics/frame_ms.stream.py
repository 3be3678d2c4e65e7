"""Host milliseconds per frame of the frame's device compute through its
read-back (models.mapper2d / mapper3d / obsgp): the program's stage spans
gpismap.update.frame and .update.reeval summed over the traced episode.
None where the program has no such span."""

STAGES = {"gpismap.update.frame", "gpismap.update.reeval"}


def read(ctx):
    tr = ctx.trace
    if tr is None or ctx.mix["loop"] != "stream" or not ctx.traced_items:
        return None
    ns = [e - s for n, s, e in tr.host if n in STAGES]
    if not ns:
        return None
    return sum(ns) / 1e6 / ctx.traced_items
