"""Mean synchronized wall of update() per frame in the window (the api
update and everything under it)."""


def read(ctx):
    s = ctx.spans.get("update")
    if ctx.mix["loop"] != "stream" or not s:
        return None
    return 1e3 * sum(s) / len(s)
