"""A witness of the plain reference that shares nothing with the
program's algorithm: a dense ray march over the bilinear heightfield (no
schedule, no pyramid), as the JAX package's own tests hold its sweep to
one.  The reference has to keep within twice the configuration's
``hori_acc`` of it, the tolerance those tests give the JAX package."""

import math

import numpy as np
import torch

from conftest import SMALL
from hzbench import reference, scenes
from hzbench import sweep as sw


def _bilinear(z, fi, fj):
    h, w = z.shape
    i0 = fi.floor().clamp(0, h - 2).long()
    j0 = fj.floor().clamp(0, w - 2).long()
    wi, wj = fi - i0, fj - j0
    return ((1 - wi) * (1 - wj) * z[i0, j0] + (1 - wi) * wj * z[i0, j0 + 1]
            + wi * (1 - wj) * z[i0 + 1, j0] + wi * wj * z[i0 + 1, j0 + 1])


def dense_march(scene, cells, step_frac=0.25):
    """(N, A) horizon [radian] at ``cells`` in float64: the steepest
    elevation of the terrain along each azimuth, sampled every
    ``step_frac`` of a cell out to the search distance."""
    z = scene["z"].double()
    dx, dy = scene["dx"], scene["dy"]
    step = min(abs(dx), abs(dy)) * step_frac
    s = torch.arange(step, scene["dist_search_m"] + step / 2, step,
                     dtype=torch.float64)
    r0 = cells.rows.double()[:, None]
    c0 = cells.cols.double()[:, None]
    z0 = z[cells.rows, cells.cols][:, None] + reference.HORIZON_RAY_LIFT
    a_num = scene["azim_num"]
    out = torch.empty((cells.n, a_num), dtype=torch.float64)
    for k in range(a_num):
        a = 2.0 * math.pi / a_num * k
        fi = r0 + (s * math.cos(a) / dy)[None, :]
        fj = c0 + (s * math.sin(a) / dx)[None, :]
        tan = (_bilinear(z, fi, fj) - z0) / s[None, :]
        out[:, k] = tan.amax(1).atan()
    lo = math.radians(scene["elev_ang_low_lim"])
    hi = math.radians(reference.ELEV_ANG_UP_LIM)
    return out.clamp(lo, hi)


def test_reference_keeps_to_a_dense_ray_march():
    from hzbench import harness
    man = harness.Manifest()
    cfg = dict(man.config(man.cell("dhm25_hz")), **SMALL["dhm25_hz"])
    gaps = []
    for dem in (0, 1, 2):
        scene = scenes.dhm25_like(cfg, 11, torch.device("cpu"), dem=dem)
        plan = {"inner_shape": scene["inner_shape"],
                "offset": scene["offset"]}
        nb0, nb1 = sw.block_grid(scene["inner_shape"])
        cells = sw.cells_of_blocks(np.arange(nb0 * nb1), plan, "cpu")
        got = reference.horizon_reference(scene, cells)["hori"].double()
        gaps.append(math.degrees(float(
            (got - dense_march(scene, cells)).abs().max())))
    assert max(gaps) < 2.0 * cfg["hori_acc"], gaps
    # the reference is not the march: it takes its own samples
    assert max(gaps) > 0.0
