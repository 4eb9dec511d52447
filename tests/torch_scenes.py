"""Scenes of the sweep's value-exact skips, shared by the CPU tests
(tests/test_torch_sweep_skips.py) and the card's (tests/test_torch_cuda.py).
Imports no JAX."""

import numpy as np

from reference_impl import gaussian_bumps_terrain


def skip_scene(name):
    """(z, sweep keywords, mask or None) of a scene for the sweep's skips
    (see the module's docstring)."""
    kw = dict(dx=25.0, dy=-25.0, azim_num=8, offset=(120, 110),
              inner_shape=(20, 72), dist_search=8000.0)
    n = (260, 292)
    if name == "random":
        return gaussian_bumps_terrain(*n, seed=6, amp=600.0), kw, None
    if name == "random_dx24.7":
        # a step whose multiples float32 rounds: the pairs' second
        # distances differ from float32((m + 1) * step)
        return (gaussian_bumps_terrain(*n, seed=10, amp=600.0),
                dict(kw, dx=24.7, dy=-24.7), None)
    if name in ("spike_inside", "spike_outside"):
        # flat terrain, a far spike north of the block (read by the mip
        # phases) on the last column of the first warp or the first column
        # of the second, and a lower one in the safe d1 range
        z = np.zeros((420, 292), np.float32)
        col = 110 + (31 if name == "spike_inside" else 32)
        z[8, col] = 2000.0
        z[200, col + 3] = 300.0
        return z, dict(kw, offset=(280, 110)), None
    if name == "plateau":
        # the block on a 400 m plateau: the far terrain lies below every
        # ray origin, so every far numerator is negative
        z = gaussian_bumps_terrain(*n, seed=8, amp=150.0)
        z[100:160, 90:200] += 400.0
        return z, kw, None
    if name == "flat_pit":
        # a flat plane with the block sunk 100 m: the rim sets the
        # running value, and every far chunk of the flat plane skips
        z = np.zeros(n, np.float32)
        z[115:145, 105:187] = -100.0
        return z, kw, None
    if name == "masked":
        z = gaussian_bumps_terrain(*n, seed=9, amp=500.0)
        mask = np.zeros(kw["inner_shape"], np.uint8)
        mask[3:15, 10:40] = 1
        mask[::4, 60:] = 1
        return z, kw, mask
    raise KeyError(name)


SKIP_SCENES = ["random", "random_dx24.7", "spike_inside", "spike_outside",
               "plateau", "flat_pit", "masked"]
