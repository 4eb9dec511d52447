"""k2_roofline [%]: the least time of the work K2's sign-exact arm needs
on the first traced call's track (hzbench.roofline.k2_bound: the
benchmark's own count, on a sample of the kernel's blocks drawn from the
seed) over that call's K2 device time (device trace)."""

from hzbench import roofline, trace


def read(ctx):
    if ctx.trace is None or not ctx.trace["calls"]:
        return None
    k2 = [t1 - t0 for name, cat, t0, t1 in ctx.trace["dev"]
          if cat == "kernel" and trace.K2 in name]
    if not k2:
        return None
    bound, _, _, _ = roofline.k2_bound(ctx.scene, ctx.driver.track(0),
                                       ctx.config["count_blocks"], ctx.seed)
    return 100.0 * bound / (k2[0] * 1e-6)
