"""lattice_ms.curved [ms]: per call, the program's span
``hzt.curved.lattice`` (``horizon.curved_lattice``): the inner cells'
lattice positions, the box, the normals interpolated onto it, the ramps
and the lattice mask.  On the host."""

from hzbench import program_spans


def read(ctx):
    return program_spans.ms_per_call(ctx, "hzt.curved.lattice")
