"""check_ms.hz [ms]: per call, the program's span ``hzt.horizon.check``
(``horizon_gridded``'s entry: validation, ``decompose_vert_grid``,
``detect_regular_grid``, the mask tests, ``is_default_planar_vectors``),
on the host."""

from hzbench import program_spans


def read(ctx):
    return program_spans.ms_per_call(ctx, "hzt.horizon.check")
