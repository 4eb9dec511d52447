"""k1_taken_pct [%]: of the (cell, azimuth) samples K1 could take in its
d1 pairs and mip phases, the share it took and did not skip, over the
traced calls (the program's counters, ``utils.profiling.counters()``)."""

from hzbench import program_spans


def read(ctx):
    return program_spans.taken_pct("k1")
