"""How a traffic mix calls the program, and how its answers are checked.

A driver is chosen by the traffic file's ``kind``, among
:data:`DRIVERS` or else as ``Driver`` of the file
``hzbench/driver/<kind>.py`` (:meth:`hzbench.harness.Manifest.driver`; a
kind in both places is an error).  The built-in kinds:

* ``horizon_calls``: ``models.PlanarPipeline(...)`` built and run
  (``mask=...``) on a DEM of its own per call, back to back, each call's
  ``hori``, ``svf``, ``slope`` and ``aspect`` brought into host memory
  (``examples/torch/horizon/gridded_planar_dem.py``'s use);
* ``sun_batch``: ``shadow.Terrain.sw_dir_cor_batch`` of one day's track
  per call, the result in host memory;
* ``sun_steps``: ``shadow.Terrain.sw_dir_cor(sun, buffer)`` one sun a
  step, a closed loop through the days' tracks.

Each call keeps the values of a sample of cells drawn from the seed (whole
kernel blocks); after the window :meth:`check` holds those of a sample of
the calls against the plain reference (:mod:`hzbench.reference`), and
the last call's whole output against the invariants every answer keeps.  The program's own
standard output is discarded.

A driver, built in or of its own file, is built as
``Driver(hray, scene, traffic, cfg, seed, device)`` and has ``warm()``,
``prepare(k)`` (call ``k``'s input, made outside the timed call),
``call(k, inp)`` (the timed call; returns its work), ``release()`` (frees
the program's state after the window) and ``check()`` (the numbers
compared, by name, each with its limit in the configuration's
``limits``).
"""

import contextlib
import math
import os
import types

import numpy as np
import torch

from hzbench import reference as ref
from hzbench import scenes
from hzbench import sweep as sw


@contextlib.contextmanager
def _quiet():
    with open(os.devnull, "w") as sink, contextlib.redirect_stdout(sink):
        yield


def _widest(gap, keep):
    """The largest gap over the kept cells (the last axis); a NaN gap is
    infinite."""
    gap = torch.where(torch.isnan(gap), float("inf"), gap)
    return float(torch.where(keep, gap, 0.0).max())


def _check_cells(scene, n_blocks, seed, device, live=None, *more):
    plan = dict(inner_shape=scene["inner_shape"], offset=scene["offset"])
    blocks = sw.sample_blocks(scene["inner_shape"], n_blocks,
                              scenes.rng_for(seed, 3, *more), live)
    return sw.cells_of_blocks(blocks, plan, device)


def _live_blocks(mask):
    """(block rows, block columns) bool: the kernel blocks that hold a
    considered cell of ``mask``."""
    nb0, nb1 = sw.block_grid(mask.shape)
    full = np.zeros((nb0 * sw.BLOCK_ROWS, nb1 * sw.BLOCK_COLS), bool)
    full[:mask.shape[0], :mask.shape[1]] = mask != 0
    return full.reshape(nb0, sw.BLOCK_ROWS, nb1,
                        sw.BLOCK_COLS).any(axis=(1, 3))


class HorizonCalls:
    """One DEM per call, as the upstream example treats a domain:
    ``models.PlanarPipeline(x, y, z, ...)`` built, run (``mask=...``),
    and its outputs brought into host memory.  Every call gets a terrain
    of its own (and a mask of its own), DEM number ``k + 1`` for the
    window's call ``k``, made from the seed on the device before the call;
    the warm-up takes DEM 0.  So no work can be kept from one call for the
    next."""

    OUTPUTS = ("hori", "svf", "slope", "aspect")

    def __init__(self, hray, scene, traffic, cfg, seed, device):
        self.hray, self.traffic, self.cfg = hray, traffic, cfg
        self.seed, self.device = seed, device
        self.scene = scene
        self.n_check = int(traffic["check_calls"])
        self.samples = []    # per call: (DEM number, sampled answers)
        self.last = None

    def dem(self, d):
        """DEM ``d``: its scene, its mask (None unmasked) and the cells
        the reference checks, drawn from the seed (whole kernel blocks,
        from those that hold a considered cell)."""
        scene = (self.scene if d == 0 else scenes.SCENES[self.cfg["scene"]](
            self.cfg, self.seed, self.device, dem=d))
        mask = live = None
        if self.traffic.get("mask"):
            mask = scenes.patch_mask(self.traffic["mask"],
                                     scene["inner_shape"], self.seed,
                                     self.device, dem=d)
            live = _live_blocks(mask)
        cells = _check_cells(scene, self.cfg["check_blocks"], self.seed,
                             self.device, live, d)
        return scene, mask, cells

    def warm(self):
        self.call(-1, self.prepare(-1))
        self.samples.clear()

    def prepare(self, k):
        """Call ``k``'s input: the heights in host memory (as a DEM file
        is read), the mask, the checked cells' indices and the work."""
        d = k + 1
        scene, mask, cells = self.dem(d)
        in0, in1 = scene["inner_shape"]
        considered = in0 * in1 if mask is None else int(mask.sum())
        return types.SimpleNamespace(
            dem=d, z=scene["z"].cpu().numpy(), mask=mask,
            ii=cells.ii.cpu().numpy(), jj=cells.jj.cpu().numpy(),
            work=considered * scene["azim_num"])

    def call(self, k, inp):
        sc = self.scene
        with _quiet():
            pipe = self.hray.models.PlanarPipeline(
                sc["x"], sc["y"], inp.z, sc["domain"],
                dist_search=sc["dist_search_km"], azim_num=sc["azim_num"],
                hori_acc=sc["hori_acc"],
                elev_ang_low_lim=sc["elev_ang_low_lim"], device=self.device)
            out = pipe.run(mask=inp.mask)
        res = {n: out[n].cpu().numpy() for n in self.OUTPUTS}
        del out, pipe
        self.samples.append((inp.dem, {n: v[inp.ii, inp.jj]
                                       for n, v in res.items()}))
        self.last = (inp, res)
        return inp.work

    def release(self):
        """Nothing of the program's is held between calls."""

    def check(self):
        """The numbers compared: the sampled answers of a sample of the
        calls drawn from the seed (the last among them) against the
        reference on each one's DEM, the last call's whole output against
        the invariants."""
        bad = self._invariants()
        rng = scenes.rng_for(self.seed, 4)
        n = len(self.samples)
        pick = sorted(set(rng.choice(n, size=min(self.n_check, n),
                                     replace=False).tolist()) | {n - 1})
        out = {}
        for i in pick:
            d, sample = self.samples[i]
            for name, v in self.gaps(self.dem(d), sample).items():
                out[name] = max(out.get(name, 0.0), v)
        return dict(out, bad_values=bad)

    def _invariants(self):
        """Non-finite values, angles outside the clamp, sky view factors
        outside (0, 1.001], masked cells not at the fill."""
        (inp, last), self.last = self.last, None
        # the limits as the float32 clamp holds them
        lo = np.float32(math.radians(self.scene["elev_ang_low_lim"]))
        hi = np.float32(math.radians(ref.ELEV_ANG_UP_LIM))
        h = last["hori"]
        bad = int((~np.isfinite(h)).sum())
        if inp.mask is None:
            bad += int(((h < lo) | (h > hi)).sum())
        else:
            keep = inp.mask == 1
            hk = h[keep]
            bad += int(((hk < lo) | (hk > hi)).sum())
            bad += int((h[~keep] != 0.0).sum())   # hori_fill
        svf = last["svf"]
        bad += int((~np.isfinite(svf)).sum() + (svf <= 0.0).sum()
                   + (svf > 1.001).sum())
        return bad

    def gaps(self, dem, sample):
        """The widest gap of each output between ``sample`` (the sampled
        cells' values of one call on ``dem``, a :meth:`dem` triple) and
        the reference's there."""
        scene, mask, cells = dem
        r = ref.horizon_reference(scene, cells)
        dev = cells.rows.device
        w = cells.weight > 0
        if mask is not None:
            ii, jj = cells.ii.cpu().numpy(), cells.jj.cpu().numpy()
            w &= torch.as_tensor(mask[ii, jj] == 1, device=dev)
        got = {n: torch.as_tensor(v, device=dev) for n, v in sample.items()}
        gaps = {"hori_gap_deg": (got["hori"] - r["hori"]).abs().amax(1),
                "svf_gap": (got["svf"] - r["svf"]).abs(),
                "slope_gap_deg": (got["slope"] - r["slope"]).abs(),
                "aspect_gap_deg": ref.angle_gap(got["aspect"], r["aspect"])}
        out = {}
        for n, g in gaps.items():
            v = _widest(g, w)
            out[n] = math.degrees(v) if n.endswith("_deg") else v
        return out


class _Sun:
    """The ``Terrain`` of the artificial-topography example."""

    def __init__(self, hray, scene, traffic, cfg, seed, device):
        self.scene, self.traffic, self.seed = scene, traffic, seed
        z = scene["z"].cpu().numpy()
        xx, yy = np.meshgrid(scene["x"], scene["y"])
        (o0, o1), (in0, in1) = scene["offset"], scene["inner_shape"]

        def on_dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        vec_norm = np.zeros((in0, in1, 3), dtype=np.float32)
        vec_norm[..., 2] = 1.0
        sl1 = (slice(o0 - 1, o0 + in0 + 1), slice(o1 - 1, o1 + in1 + 1))
        vec_tilt = hray.topo_param.slope_plane_meth(
            on_dev(xx[sl1]), on_dev(yy[sl1]),
            on_dev(z[sl1]))[1:-1, 1:-1].contiguous()
        surf = hray.topo_param.surface_enlargement_factor(on_dev(vec_norm),
                                                          vec_tilt)
        vert = hray.auxiliary.rearrange_pad_buffer(xx, yy, z)
        self.terrain = hray.shadow.Terrain()
        with _quiet():
            self.terrain.initialise(
                vert, z.shape[0], z.shape[1], o0, o1, vec_tilt, vec_norm,
                surf, np.ascontiguousarray(z[o0:o0 + in0, o1:o1 + in1]),
                np.ones((in0, in1), dtype=np.uint8),
                ang_max=scene["ang_max"], refrac_cor=False,
                acc=scene["acc"], device=device)
        self.cells = _check_cells(scene, cfg["check_blocks"], seed, device)
        self.ii = self.cells.ii.cpu().numpy()
        self.jj = self.cells.jj.cpu().numpy()
        self.n_check = int(traffic["check_calls"])
        self.steps = int(traffic["track"]["steps"])
        self.samples = []
        self.suns = []
        self.last = None

    def track(self, day):
        return scenes.sun_track(self.traffic["track"], self.seed, day)

    def release(self):
        self.terrain = None

    def check(self):
        """The numbers compared: the answers of a sample of the calls (the
        last among them) against the reference, the last call's whole
        output against the invariants."""
        last, self.last = self.last, None
        bad = int((~np.isfinite(last)).sum() + (last < 0.0).sum())
        del last
        rng = scenes.rng_for(self.seed, 4)
        n = len(self.samples)
        pick = sorted(set(rng.choice(n, size=min(self.n_check, n),
                                     replace=False).tolist()) | {n - 1})
        return {"swdc_gap": self.gaps([(self.suns[i], self.samples[i])
                                       for i in pick]),
                "bad_values": bad}

    def gaps(self, pairs):
        """The widest gap between the sampled answers and the reference's
        over ``pairs`` of (suns (T, 3), answers (T, N) or (N,))."""
        dev = self.cells.rows.device
        w = self.cells.weight > 0
        size = max(1, self.steps // pairs[0][0].shape[0])
        gap = 0.0
        for i in range(0, len(pairs), size):
            group = pairs[i:i + size]
            suns = np.concatenate([p[0] for p in group])
            r = ref.sw_dir_cor_reference(self.scene, self.cells, suns)
            got = torch.as_tensor(np.concatenate(
                [p[1].reshape(-1, self.cells.n) for p in group]), device=dev)
            gap = max(gap, _widest((got - r).abs(), w))
        return gap


class SunBatch(_Sun):
    """``Terrain.sw_dir_cor_batch`` of day ``k``'s track per call."""

    def __init__(self, *args):
        super().__init__(*args)
        in0, in1 = self.scene["inner_shape"]
        self.work = in0 * in1 * self.steps

    def warm(self):
        self.call(0, self.prepare(0))
        self.samples.clear()
        self.suns.clear()

    def prepare(self, k):
        return self.track(k)

    def call(self, k, suns):
        out = self.terrain.sw_dir_cor_batch(suns).cpu().numpy()
        self.samples.append(out[:, self.ii, self.jj])
        self.suns.append(suns)
        self.last = out
        return self.work


class SunSteps(_Sun):
    """``Terrain.sw_dir_cor(sun, buffer)`` per step: step ``k`` takes sun
    ``k mod T`` of day ``k // T``'s track."""

    def __init__(self, *args):
        super().__init__(*args)
        self.buffer = np.empty(self.scene["inner_shape"], dtype=np.float32)
        self.day, self.day_track = None, None
        self.work = 1

    def warm(self):
        for k in range(3):
            self.call(k, self.prepare(k))
        self.samples.clear()
        self.suns.clear()

    def prepare(self, k):
        day, i = divmod(k, self.steps)
        if day != self.day:
            self.day, self.day_track = day, self.track(day)
        return self.day_track[i]

    def call(self, k, sun):
        self.terrain.sw_dir_cor(sun, self.buffer)
        self.samples.append(self.buffer[self.ii, self.jj])
        self.suns.append(sun[None, :])
        self.last = self.buffer
        return self.work


DRIVERS = {"horizon_calls": HorizonCalls, "sun_batch": SunBatch,
           "sun_steps": SunSteps}
