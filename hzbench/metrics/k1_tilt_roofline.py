"""k1_tilt_roofline [%]: the least time of the work K1's tilt variant
needs on the first traced call's DEM over that call's K1 device time
(device trace).  The work is hzbench.roofline.k1_bound's count on the
curved reference's own lattice box of that DEM
(hzbench.curved_reference.lattice_scene, on a sample of the kernel's
blocks drawn from the seed).  That frozen count leaves out the ramp's two
operations (a multiply-add each for A and B) per (cell, azimuth)."""

from hzbench import curved_reference, roofline, trace


def read(ctx):
    if ctx.trace is None or not ctx.trace["calls"]:
        return None
    k1 = [t1 - t0 for name, cat, t0, t1 in ctx.trace["dev"]
          if cat == "kernel" and trace.K1 in name]
    if not k1:
        return None
    scene = ctx.driver.dem(1)[0]          # the window's first call's
    bound, _, _, _ = roofline.k1_bound(curved_reference.lattice_scene(scene),
                                       ctx.config["count_blocks"], ctx.seed)
    return 100.0 * bound / (k1[0] * 1e-6)
