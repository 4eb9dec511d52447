"""classify_ms.step [ms]: per step, the program's spans of the
classification's host work: ``hzt.terrain.occluded`` (the threshold) and
``hzt.terrain.classify`` (the sun dots and Mueller-Scherer)."""

from hzbench import program_spans


def read(ctx):
    return program_spans.ms_per_call(ctx, "hzt.terrain.occluded",
                                     "hzt.terrain.classify")
