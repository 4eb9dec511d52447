"""grid_ms.hz [ms]: per call, the program's span ``hzt.pipeline.grid``
(``PlanarPipeline.run``: the unit vectors, the meshgrid and
``auxiliary.rearrange_pad_buffer``, the vertex buffer), on the host."""

from hzbench import program_spans


def read(ctx):
    return program_spans.ms_per_call(ctx, "hzt.pipeline.grid")
