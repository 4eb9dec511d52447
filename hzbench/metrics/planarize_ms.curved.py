"""planarize_ms.curved [ms]: per call, the program's span
``hzt.curved.planarize`` (``horizon.curved_lattice``): ``regrid.planarize``
of the ENU mesh onto the regular lattice in NumPy float64 (the inverse
mapping's Newton iterations, the heights' resampling).  On the host."""

from hzbench import program_spans


def read(ctx):
    return program_spans.ms_per_call(ctx, "hzt.curved.planarize")
