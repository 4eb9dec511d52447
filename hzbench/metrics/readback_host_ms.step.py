"""readback_host_ms.step [ms]: per step, the wall of the program's span
``hzt.terrain.readback`` (``buffer[:] = out.cpu().numpy()``) less the
device time of the copies inside it: the host's share of the read-back
(the wait for the queued work, staging and the NumPy copy)."""

from hzbench import program_spans


def read(ctx):
    return program_spans.host_ms_per_call(ctx, "hzt.terrain.readback")
