"""sun_rate [Mcell_sun/s]: inner cells x sun positions of every call
completed in the window, over the window's wall (host clock)."""


def read(ctx):
    return ctx.work / ctx.window_s / 1e6
