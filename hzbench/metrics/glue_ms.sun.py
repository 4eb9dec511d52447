"""glue_ms.sun [ms]: device time per call of every kernel but K2 (the sun
table, classification and Mueller-Scherer glue of shadow.Terrain), from
the device trace."""

from hzbench import trace


def read(ctx):
    if ctx.trace is None or not ctx.trace["calls"]:
        return None
    us = trace.kernel_us(ctx.trace, trace.K2, other=True)
    return us / ctx.trace["calls"] / 1e3
