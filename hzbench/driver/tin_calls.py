"""Traffic kind ``tin_calls``: one 2 m tile per call, as the upstream 2 m
example (``examples/horizon/gridded_planar_DEM_2m.py``) treats a domain:
``models.PlanarPipeline(x, y, z, domain, ..., vert_simp=...,
tri_ind_simp=...)`` built with the tile's far-field TIN and run, its
``hori``, ``svf``, ``slope`` and ``aspect`` brought into host memory.
Every call gets a terrain and a TIN of its own, DEM number ``k + 1`` for
the window's call ``k``, made from the seed before the call and brought
to host memory as a DEM file and a TIN file are read; the warm-up takes
DEM 0.

The calls, their samples, the check and the invariants are those of the
built-in ``horizon_calls`` (:class:`hzbench.drivers.HorizonCalls`,
unmasked); the reference is the multires one
(:mod:`hzbench.multires_reference`), and the control
(:func:`control_readings`) that reference in bfloat16.
"""

import math
import types

import torch

from hzbench import drivers, harness
from hzbench import multires_reference as mref
from hzbench import reference as ref

CONTROL_CALLS = 1


class Driver(drivers.HorizonCalls):

    def __init__(self, *args):
        super().__init__(*args)
        self.make = harness.Manifest().scene(self.cfg["scene"])

    def dem(self, d):
        """DEM ``d``: its scene, no mask, and the inner cells the reference
        checks, drawn from the seed (whole kernel blocks)."""
        scene = (self.scene if d == 0 else
                 self.make(self.cfg, self.seed, self.device, dem=d))
        cells = drivers._check_cells(scene, self.cfg["check_blocks"],
                                     self.seed, self.device, None, d)
        return scene, None, cells

    def prepare(self, k):
        """Call ``k``'s input: the heights and the TIN in host memory, the
        checked cells' indices and the work."""
        d = k + 1
        scene, _, cells = self.dem(d)
        in0, in1 = scene["inner_shape"]
        return types.SimpleNamespace(
            dem=d, z=scene["z"].cpu().numpy(),
            vert_simp=scene["vert_simp"].cpu().numpy(),
            tri_ind_simp=scene["tri_ind_simp"].cpu().numpy(), mask=None,
            ii=cells.ii.cpu().numpy(), jj=cells.jj.cpu().numpy(),
            work=in0 * in1 * scene["azim_num"])

    def call(self, k, inp):
        sc = self.scene
        with drivers._quiet():
            pipe = self.hray.models.PlanarPipeline(
                sc["x"], sc["y"], inp.z, sc["domain"], sc["dist_search_km"],
                azim_num=sc["azim_num"], hori_acc=sc["hori_acc"],
                elev_ang_low_lim=sc["elev_ang_low_lim"],
                vert_simp=inp.vert_simp, tri_ind_simp=inp.tri_ind_simp,
                device=self.device)
            out = pipe.run()
        res = {n: out[n].cpu().numpy() for n in self.OUTPUTS}
        del out, pipe
        self.samples.append((inp.dem, {n: v[inp.ii, inp.jj]
                                       for n, v in res.items()}))
        self.last = (inp, res)
        return inp.work

    def gaps(self, dem, sample):
        """The widest gap of each output between ``sample`` (the sampled
        cells' values of one call on ``dem``, a :meth:`dem` triple) and
        the multires reference's there."""
        scene, _, cells = dem
        r = mref.horizon_reference(scene, cells)
        dev = cells.rows.device
        w = cells.weight > 0
        got = {n: torch.as_tensor(v, device=dev) for n, v in sample.items()}
        gaps = {"hori_gap_deg": (got["hori"] - r["hori"]).abs().amax(1),
                "svf_gap": (got["svf"] - r["svf"]).abs(),
                "slope_gap_deg": (got["slope"] - r["slope"]).abs(),
                "aspect_gap_deg": ref.angle_gap(got["aspect"], r["aspect"])}
        out = {}
        for n, g in gaps.items():
            v = drivers._widest(g, w)
            out[n] = math.degrees(v) if n.endswith("_deg") else v
        return out


def control_readings(drv):
    """The control judged as the program's answers are: the bfloat16
    multires reference at the sampled cells of each call's DEM."""
    out = {}
    for d, _ in drv.samples:
        dem = drv.dem(d)
        r = mref.horizon_reference(dem[0], dem[2], torch.bfloat16)
        sample = {n: v.float().cpu().numpy() for n, v in r.items()}
        for n, v in drv.gaps(dem, sample).items():
            out[n] = max(out.get(n, 0.0), v)
    return out
