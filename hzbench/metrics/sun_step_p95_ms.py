"""sun_step_p95_ms [ms]: the 95th percentile, over every step of the
window, of one step's wall (host clock; numpy's linear interpolation)."""

import numpy as np


def read(ctx):
    walls = np.asarray([t1 - t0 for t0, t1 in ctx.calls], dtype=np.float64)
    return float(np.percentile(walls, 95.0)) * 1e3
