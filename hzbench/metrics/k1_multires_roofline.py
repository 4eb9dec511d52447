"""k1_multires_roofline [%]: the least time of the work K1 needs on the
first traced call's DEM over that call's K1 device time (device trace).
The work is hzbench.multires_reference.k1_bound's count: the frozen skip
count on the reference's own combined pyramid of that DEM (its fine grid
and the far field rasterised from its TIN), on a sample of the kernel's
blocks drawn from the seed, with the bytes of levels of the fine grid's
shape."""

from hzbench import multires_reference, trace


def read(ctx):
    if ctx.trace is None or not ctx.trace["calls"]:
        return None
    k1 = [t1 - t0 for name, cat, t0, t1 in ctx.trace["dev"]
          if cat == "kernel" and trace.K1 in name]
    if not k1:
        return None
    scene = ctx.driver.dem(1)[0]          # the window's first call's
    bound = multires_reference.k1_bound(scene, ctx.config["count_blocks"],
                                        ctx.seed)[0]
    return 100.0 * bound / (k1[0] * 1e-6)
