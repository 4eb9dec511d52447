"""horizon_rate [Mcell_az/s]: considered inner cells x azimuths of every
call completed in the window, over the window's wall (host clock)."""


def read(ctx):
    return ctx.work / ctx.window_s / 1e6
