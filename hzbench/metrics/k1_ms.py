"""k1_ms [ms]: device time per call of kernel K1 (the horizon mode of
csrc/horizon_sweep.cu, its mask variant too), from the device trace."""

from hzbench import trace


def read(ctx):
    if ctx.trace is None or not ctx.trace["calls"]:
        return None
    us = trace.kernel_us(ctx.trace, trace.K1)
    return us / ctx.trace["calls"] / 1e3 if us else None
