"""Mean synchronized wall of the per-frame test() in the window: the map
query, the first after each retrain, which refreshes the factor cache."""


def read(ctx):
    s = ctx.spans.get("test")
    if ctx.mix["loop"] != "stream" or not s:
        return None
    return 1e3 * sum(s) / len(s)
