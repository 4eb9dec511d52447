"""device_idle_pct.<group> [%]: the share of the traced window in which
no kernel, copy or fill runs on the card (device trace); the reader of
every cell group's metric (``.hz``, ``.sun``, ``.step``)."""

from hzbench import trace


def read(ctx):
    return None if ctx.trace is None else trace.idle_pct(ctx.trace)
