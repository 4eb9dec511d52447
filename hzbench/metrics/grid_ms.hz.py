"""grid_ms.hz [ms]: per call, the program's span ``hzt.pipeline.grid``
(``PlanarPipeline.run``): on the route of uniform 1-D axes the axes'
test (``terrain.axes_grid``), the ``GridSpec`` and the 1-D axes to the
device, broadcast into the topo planes; on the vertex-buffer route the
unit vectors, the meshgrid and ``auxiliary.rearrange_pad_buffer``.  On the
host."""

from hzbench import program_spans


def read(ctx):
    return program_spans.ms_per_call(ctx, "hzt.pipeline.grid")
