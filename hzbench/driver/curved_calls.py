"""Traffic kind ``curved_calls``: one lon/lat DEM per call, as the
upstream curved example (``examples/horizon/gridded_curved_DEM.py``)
treats a domain: ``models.CurvedPipeline(lon, lat, z, domain, ...)``
built and run, its ``hori``, ``svf``, ``slope`` and ``aspect`` brought
into host memory.  Every call gets a terrain of its own, DEM number
``k + 1`` for the window's call ``k``, made from the seed before the
call; the warm-up takes DEM 0.

The calls, their samples, the check and the invariants are those of the
built-in ``horizon_calls`` (:class:`hzbench.drivers.HorizonCalls`,
unmasked); the reference is the curved one
(:mod:`hzbench.curved_reference`), and the control
(:func:`control_readings`) that reference in bfloat16.
"""

import math

import torch

from hzbench import curved_reference as cref
from hzbench import drivers, harness
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

    def call(self, k, inp):
        sc = self.scene
        with drivers._quiet():
            pipe = self.hray.models.CurvedPipeline(
                sc["lon"], sc["lat"], inp.z, sc["domain"],
                sc["dist_search_km"], azim_num=sc["azim_num"],
                hori_acc=sc["hori_acc"], ellps=sc["ellps"],
                elev_ang_low_lim=sc["elev_ang_low_lim"], device=self.device)
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
        the curved reference's there."""
        scene, _, cells = dem
        r = cref.horizon_reference(scene, cells)
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
    curved reference at the sampled cells of each call's DEM."""
    out = {}
    for d, _ in drv.samples:
        dem = drv.dem(d)
        r = cref.horizon_reference(dem[0], dem[2], torch.bfloat16)
        sample = {n: v.float().cpu().numpy() for n, v in r.items()}
        for n, v in drv.gaps(dem, sample).items():
            out[n] = max(out.get(n, 0.0), v)
    return out
