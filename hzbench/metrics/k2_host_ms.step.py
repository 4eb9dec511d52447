"""k2_host_ms.step [ms]: per step, the program's spans of the sun's host
work up to K2's launch: ``hzt.terrain.sun_table`` (the checks and the sun
table), ``hzt.shadow.args`` (K2's arguments) and ``hzt.shadow.k2`` (its
parameters and launch)."""

from hzbench import program_spans


def read(ctx):
    return program_spans.ms_per_call(ctx, "hzt.terrain.sun_table",
                                     "hzt.shadow.args", "hzt.shadow.k2")
