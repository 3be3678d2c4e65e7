"""Host milliseconds per frame of the factor-cache fill (models.cluster
factorize_slots, a lookup where the cache holds): the program's stage
span gpismap.test.factors summed over the traced episode. None where the
program has no such span."""

STAGES = {"gpismap.test.factors"}


def read(ctx):
    tr = ctx.trace
    if tr is None or ctx.mix["loop"] != "stream" or not ctx.traced_items:
        return None
    ns = [e - s for n, s, e in tr.host if n in STAGES]
    if not ns:
        return None
    return sum(ns) / 1e6 / ctx.traced_items
