"""The tile evaluation kernel's share of its roofline (ops.tile_eval ->
csrc/tile_eval.cu): the least time the chip could take for the traced
batches' work, max(FLOPs / peak f32 rate, bytes / peak bandwidth), over
the kernel's device time, in %. The work is counted from (query, cell)
pairs by harness/work.py, whatever the tiling."""


def read(ctx):
    tr = ctx.trace
    if tr is None or ctx.tile_work is None:
        return None
    t = tr.device_time(lambda n: "tile_eval" in n and "backward" not in n)
    if t <= 0:
        return None
    peak = next((v for k, v in ctx.peaks.items() if k in ctx.device_kind),
                None)
    if peak is None:
        return None
    flops, nbytes = ctx.tile_work
    bound = max(flops / peak["f32_flops"], nbytes / peak["hbm_bytes_per_s"])
    return 100.0 * bound / t
