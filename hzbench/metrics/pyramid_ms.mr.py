"""pyramid_ms.mr [ms]: per call, the program's spans ``hzt.tin.upload``
(``horizon._tin_gridded``: the fine and coarse grids to the card) and
``hzt.tin.pyramid`` (``multires.horizon_sweep_multires_fused``: the
sweep's plan and ``multires_levels``, the combined fine + coarse pyramid),
summed."""

from hzbench import program_spans


def read(ctx):
    return program_spans.ms_per_call(ctx, "hzt.tin.upload",
                                     "hzt.tin.pyramid")
