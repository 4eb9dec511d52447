"""geometry_ms.curved [ms]: per call, the program's span
``hzt.curved.geometry`` (``CurvedPipeline.build_geometry``): the lon/lat
meshgrid, ``lonlat2ecef``, ``ecef2enu``, the inner cells' ``surf_norm``
and ``north_dir`` and their ENU vectors.  On the host."""

from hzbench import program_spans


def read(ctx):
    return program_spans.ms_per_call(ctx, "hzt.curved.geometry")
