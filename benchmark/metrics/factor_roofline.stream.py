"""The Cholesky and L^-1 kernels' share of their roofline (ops.chol ->
csrc/chol.cu), over the traced episode, in %: the least time the chip
could take for the factorizations the frames needed, over the device
time of the chol_* and linv_* kernels (factor_kernels_ms.stream's match).

The work is the program's factor counters (gpismap_tpu_torch.runtime
.spans, live while the profiler records): each cell handed to chol or
linv counts n = (1 + D) m rows, m its true support, never the padding.
Each factorization and each inverse is n^3 / 3 operations and one 4-byte
read and one write of n^2 entries: the bound is max((sum n^3) / 3 / peak
f32 rate, 8 (sum n^2) / peak bandwidth). None where the program has no
such counters."""


def read(ctx):
    tr = ctx.trace
    if tr is None or ctx.mix["loop"] != "stream":
        return None
    try:
        from gpismap_tpu_torch.runtime import spans
    except ImportError:
        return None
    c = spans.counts()
    rows3 = c.get("chol.rows3", 0) + c.get("linv.rows3", 0)
    rows2 = c.get("chol.rows2", 0) + c.get("linv.rows2", 0)
    t = tr.device_time(lambda n: "chol_" in n or "linv_" in n)
    peak = next((v for k, v in ctx.peaks.items() if k in ctx.device_kind),
                None)
    if rows3 <= 0 or t <= 0 or peak is None:
        return None
    bound = max(rows3 / 3 / peak["f32_flops"],
                8 * rows2 / peak["hbm_bytes_per_s"])
    return 100.0 * bound / t
