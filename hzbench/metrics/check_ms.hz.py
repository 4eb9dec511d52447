"""check_ms.hz [ms]: per call, the program's span ``hzt.horizon.check``:
on the route of uniform 1-D axes ``horizon._check_planar`` (the inner
block, ``hori_acc``, the mask's shape, dtype and ``min()``); on the
vertex-buffer route ``horizon_gridded``'s entry (validation, the same
checks, ``decompose_vert_grid``, ``detect_regular_grid``,
``is_default_planar_vectors``).  On the host."""

from hzbench import program_spans


def read(ctx):
    return program_spans.ms_per_call(ctx, "hzt.horizon.check")
