"""Frames absorbed and queried per second: every frame of the window
over all the window's seconds, episode resets included."""


def read(ctx):
    if ctx.mix["loop"] != "stream" or not ctx.items:
        return None
    return ctx.items / ctx.window_s
