"""Device milliseconds per frame of the Cholesky and L^-1 kernels
(ops.chol -> csrc/chol.cu), from the traced episode."""


def read(ctx):
    tr = ctx.trace
    if tr is None or ctx.mix["loop"] != "stream" or not ctx.traced_items:
        return None
    t = tr.device_time(lambda n: "chol_" in n or "linv_" in n)
    if t <= 0:
        return None
    return 1e3 * t / ctx.traced_items
