"""The device's idle share of the traced episode: 1 - (the union of the
device operations' intervals / the traced window)."""


def read(ctx):
    tr = ctx.trace
    if tr is None or ctx.mix["loop"] != "stream" or tr.busy_s <= 0:
        return None
    return 1.0 - tr.busy_s / tr.window_s
