"""k1_roofline [%]: the least time of the work K1 needs on the first
traced call's DEM (hzbench.roofline.k1_bound: the benchmark's own count,
on a sample of the kernel's blocks drawn from the seed) over that call's
K1 device time (device trace)."""

from hzbench import roofline, trace


def read(ctx):
    if ctx.trace is None or not ctx.trace["calls"]:
        return None
    k1 = [t1 - t0 for name, cat, t0, t1 in ctx.trace["dev"]
          if cat == "kernel" and trace.K1 in name]
    if not k1:
        return None
    scene, _, _ = ctx.driver.dem(1)       # the window's first call's
    bound, _, _, _ = roofline.k1_bound(scene, ctx.config["count_blocks"],
                                       ctx.seed)
    return 100.0 * bound / (k1[0] * 1e-6)
