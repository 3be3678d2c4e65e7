"""Query points answered per second over all the window's seconds."""


def read(ctx):
    if ctx.mix["loop"] != "query" or not ctx.items:
        return None
    return ctx.items * ctx.points_per_item / ctx.window_s
