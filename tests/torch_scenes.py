"""Scenes of the sweep's skips, shared by the CPU tests
(tests/test_torch_sweep_skips.py for K1, tests/test_torch_shadow_skips.py
for K2) and the card's (tests/test_torch_cuda.py).  Imports no JAX."""

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


def shadow_skip_scene(name):
    """(z, offset, inner shape, dx, dy, suns relative to the domain centre)
    of a scene for K2's skips.  Every scene has safe and masked d1 pairs and
    a mip phase of three chunks; the grid origin is (0, 0)."""
    n, off, inner = (260, 292), (120, 110), (20, 72)
    if name == "random":
        # dx != dy; a sun below the cells (m < 0) and one near overhead
        return (gaussian_bumps_terrain(*n, seed=6, amp=600.0), off, inner,
                25.0, -30.0, [(2.0e5, 1.0e5, 1.5e4), (-1.0e5, 2.0e5, 0.8e4),
                              (3.0e4, -2.0e5, 0.0), (1.0e3, 5.0e2, 1.0e5)])
    if name == "flat_pit":
        # a flat plane with the block sunk 100 m: no terrain beyond the rim
        # reaches a ray, so the far chunks skip
        z = np.zeros(n, np.float32)
        z[115:145, 105:187] = -100.0
        return z, off, inner, 25.0, -25.0, [(2.0e5, 1.0e5, 2.0e4),
                                           (-1.5e5, -0.5e5, 6.0e3)]
    if name == "spike":
        # flat terrain, a far spike north of the block read by the mip
        # phases, a lower one in the safe d1 range; suns toward and away
        z = np.zeros((420, 292), np.float32)
        z[8, 141] = 2000.0
        z[200, 144] = 300.0
        return z, (280, 110), inner, 25.0, -25.0, [
            (0.0, 2.0e5, 2.0e4), (3.0e3, 2.0e5, 4.0e4),
            (0.0, -2.0e5, 1.0e4)]
    if name == "ridge_low_sun":
        # a concave ridge across the rays in the d1 range, low suns behind
        # it: the rays graze its crest, where parabola vertices win
        z = np.zeros(n, np.float32)
        rows = np.arange(n[0], dtype=np.float32)[:, None]
        cols = np.arange(n[1], dtype=np.float32)[None, :]
        crest = 60.0 + 6.0 * np.sin(cols / 9.0)
        z += (95.0 * np.exp(-((rows - crest) ** 2) / (2 * 7.0 ** 2))
              ).astype(np.float32)
        return z, off, inner, 25.0, -25.0, [
            (1.0e4, 3.0e5, 1.6e4), (-2.0e4, 3.0e5, 1.8e4),
            (0.0, 3.0e5, 2.2e4)]
    if name == "overhead":
        # suns nearly overhead: ray slopes of 10-1000
        return (gaussian_bumps_terrain(*n, seed=11, amp=800.0), off, inner,
                25.0, -25.0, [(1.0e3, 5.0e2, 1.0e5), (-2.0e2, -3.0e2, 8.0e4)])
    raise KeyError(name)


SHADOW_SKIP_SCENES = ["random", "flat_pit", "spike", "ridge_low_sun",
                      "overhead"]
