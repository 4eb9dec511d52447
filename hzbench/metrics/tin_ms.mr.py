"""tin_ms.mr [ms]: per call, the program's span ``hzt.tin.raster``
(``horizon._tin_gridded``): the ratio rule ``tin_ratio_log2`` and
``multires.coarse_grid_from_tin`` (the TIN rasterised triangle by
triangle in float64, the vertex scatter, the fine overlay).  On the
host."""

from hzbench import program_spans


def read(ctx):
    return program_spans.ms_per_call(ctx, "hzt.tin.raster")
