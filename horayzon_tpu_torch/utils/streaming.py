# Copyright (c) 2026
# MIT License
"""Tiled streaming execution with resume-at-tile granularity (counterpart
of :mod:`horayzon_tpu.utils.streaming`).

The reference streams per-timestep results to an append-mode NetCDF so a
killed run keeps completed steps (gridded_curved_DEM_SRTM.py:207-266); for
spatial scaling it relies on the inner/outer-domain split.  Here large inner
domains are processed tile by tile: each finished tile is written atomically
to disk and a restarted run skips completed tiles — checkpoint/resume for
free, plus bounded device memory for the horizon cube of arbitrarily large
domains.

:class:`TiledHorizonRunner` sweeps each tile with the fused sweep (kernel
K1 on the card) where the run's azimuths and arguments allow it, as
``horizon_gridded(engine="auto")`` does, and with the reference's XLA
engine otherwise; the reference's runner always takes the XLA engine
(``horayzon_tpu/utils/streaming.py:74-78``).  :class:`SunTrackRunner`
streams ``Terrain``'s batch queries (kernel K2 on the card).
"""

import os

import numpy as np
import torch

from horayzon_tpu_torch.horizon import azimuth_angles
from horayzon_tpu_torch.ops import fused_sweep as _fused
from horayzon_tpu_torch.ops import mip as _mip
from horayzon_tpu_torch.ops import sweep as _sweep

#: Arguments of the XLA engine's ``horizon_sweep`` that the fused entry
#: takes with the same meaning.
FUSED_KWARGS = frozenset(("hori_acc", "elev_ang_low_lim", "elev_ang_up_lim",
                          "ray_org_elev", "rel_err", "max_level"))
#: The arguments of those that set the pyramid's pads.
_PLAN_KWARGS = ("hori_acc", "rel_err", "max_level")


def fused_route(azim, sweep_kwargs):
    """True if a tiled run over ``azim`` with ``sweep_kwargs`` can take the
    fused sweep: ``azim`` equals, in float32, the fused route's own
    azimuths ``2*pi*k/A`` (:func:`horayzon_tpu_torch.horizon.
    azimuth_angles`), and every keyword is one the fused entry takes
    (:data:`FUSED_KWARGS`).  Otherwise the run takes the XLA engine."""
    a32 = np.asarray(azim, dtype=np.float32)
    return (a32.ndim == 1 and a32.size > 0
            and np.array_equal(a32, azimuth_angles(a32.size))
            and set(sweep_kwargs) <= FUSED_KWARGS)


class TiledHorizonRunner:
    """Run the gridded horizon sweep tile by tile with on-disk streaming.

    Parameters
    ----------
    z_outer : (H, W) array or tensor — outer heightfield, uploaded to
        ``device`` once.
    dx, dy : float — grid spacing (dy signed).
    offset : (off0, off1) — inner-domain offset in the outer grid.
    inner_shape : (in0, in1) — total inner-domain size.
    azim : (A,) array [radian].
    dist_search : float [metre].
    out_dir : str — directory for per-tile results (one .npy a tile).
    tile : (t0, t1) — tile size (the last row/column of tiles may be
        smaller).
    device : where the sweeps run, the card unless the caller asks for
        the CPU.
    sweep_kwargs : forwarded to the tile's sweep: the fused
        :func:`horayzon_tpu_torch.ops.fused_sweep.horizon_sweep_fused` if
        :func:`fused_route` holds (K1 on a CUDA device, its plain version
        on the CPU; the max-mip levels are built once and shared by every
        tile, since a tile's pads are the run's), else
        :func:`horayzon_tpu_torch.ops.sweep.horizon_sweep`.
    """

    def __init__(self, z_outer, *, dx, dy, offset, inner_shape, azim,
                 dist_search, out_dir, tile=(512, 512), device="cuda",
                 **sweep_kwargs):
        self.device = torch.device(device)
        self.z_outer = torch.as_tensor(
            z_outer, dtype=torch.float32, device=self.device).contiguous()
        self.dx = dx
        self.dy = dy
        self.offset = offset
        self.inner_shape = tuple(inner_shape)
        self.azim = np.asarray(azim)
        self.dist_search = dist_search
        self.out_dir = out_dir
        self.tile = tile
        self.sweep_kwargs = sweep_kwargs
        self.fused = fused_route(self.azim, sweep_kwargs)
        self._levels = None
        os.makedirs(out_dir, exist_ok=True)

    def tiles(self):
        in0, in1 = self.inner_shape
        t0, t1 = self.tile
        for i0 in range(0, in0, t0):
            for j0 in range(0, in1, t1):
                yield (i0, j0, min(t0, in0 - i0), min(t1, in1 - j0))

    def _tile_path(self, i0, j0):
        return os.path.join(self.out_dir, f"hori_tile_{i0:06d}_{j0:06d}.npy")

    def pyramid(self):
        """The padded max-mip levels of ``z_outer`` that every tile of the
        fused route reads, built on first use."""
        if self._levels is None:
            plan = _fused.plan_sweep(
                tuple(self.z_outer.shape), inner_shape=self.inner_shape,
                offset=self.offset, dist_search=self.dist_search,
                dx=self.dx, dy=self.dy,
                **{k: v for k, v in self.sweep_kwargs.items()
                   if k in _PLAN_KWARGS})
            self._levels = _mip.padded_levels(self.z_outer, plan["pads"])
        return self._levels

    def sweep_tile(self, i0, j0, n0, n1):
        """The (n0, n1, A) float32 horizon [radian] of the tile at inner
        cell ``(i0, j0)``, on the runner's device."""
        offset = (self.offset[0] + i0, self.offset[1] + j0)
        if self.fused:
            return _fused.horizon_sweep_fused(
                self.z_outer, dx=self.dx, dy=self.dy, offset=offset,
                inner_shape=(n0, n1), azim_num=len(self.azim),
                dist_search=self.dist_search, pyramid=self.pyramid(),
                **self.sweep_kwargs)
        hori, _ = _sweep.horizon_sweep(
            self.z_outer, dx=self.dx, dy=self.dy, offset=offset,
            inner_shape=(n0, n1), azim=self.azim,
            dist_search=self.dist_search, **self.sweep_kwargs)
        return hori

    def run(self, verbose=True):
        """Process all tiles, skipping ones already on disk (resume).

        Returns the list of tile paths."""
        paths = []
        done = 0
        todo = list(self.tiles())
        for (i0, j0, n0, n1) in todo:
            path = self._tile_path(i0, j0)
            paths.append(path)
            if os.path.exists(path):
                done += 1
                continue
            hori = self.sweep_tile(i0, j0, n0, n1)
            tmp = path + ".tmp.npy"
            np.save(tmp, hori.cpu().numpy())
            os.replace(tmp, path)   # atomic: no partial tiles on crash
            done += 1
            if verbose:
                print(f"tile ({i0},{j0}) done [{done}/{len(todo)}]")
        return paths

    def assemble(self):
        """Merge the on-disk tiles into the full (in0, in1, A) array."""
        in0, in1 = self.inner_shape
        out = np.empty((in0, in1, len(self.azim)), dtype=np.float32)
        for (i0, j0, n0, n1) in self.tiles():
            out[i0:i0 + n0, j0:j0 + n1] = np.load(self._tile_path(i0, j0))
        return out


class SunTrackRunner:
    """Stream a sun-track shadow / sw_dir_cor run to disk, resumably.

    The reference appends each timestep to an append-mode NetCDF so a
    killed run keeps completed steps
    (examples/shadow/gridded_curved_DEM_SRTM.py:207-266).  Here the track
    is processed in device-batched chunks; each finished chunk is written
    atomically (`os.replace`) and a restarted run skips chunks already on
    disk — so a long ``sw_dir_cor_batch`` is never all-or-nothing.

    Parameters
    ----------
    terrain : :class:`horayzon_tpu_torch.shadow.Terrain` (initialised; its
        queries run on its device: K2, sign-exact, on the card).
    sun_positions : (T, 3) array — ENU sun coordinates per timestep.
    out_dir : str — directory for per-chunk results.
    mode : "sw_dir_cor" or "shadow".
    chunk : timesteps per device batch (and per checkpoint file).
    """

    def __init__(self, terrain, sun_positions, *, out_dir,
                 mode="sw_dir_cor", chunk=8):
        if mode not in ("sw_dir_cor", "shadow"):
            raise ValueError("mode must be 'sw_dir_cor' or 'shadow'")
        self.terrain = terrain
        self.sun_positions = np.asarray(sun_positions, dtype=np.float32)
        if self.sun_positions.ndim != 2 or self.sun_positions.shape[1] != 3:
            raise ValueError("sun_positions must have shape (T, 3)")
        self.out_dir = out_dir
        self.mode = mode
        self.chunk = int(chunk)
        os.makedirs(out_dir, exist_ok=True)

    def chunks(self):
        t_total = self.sun_positions.shape[0]
        for t0 in range(0, t_total, self.chunk):
            yield t0, min(self.chunk, t_total - t0)

    def _chunk_path(self, t0):
        return os.path.join(self.out_dir,
                            f"{self.mode}_steps_{t0:06d}.npy")

    def run(self, verbose=True):
        """Process all chunks, skipping ones already on disk (resume).

        Returns the list of chunk paths."""
        fn = (self.terrain.sw_dir_cor_batch if self.mode == "sw_dir_cor"
              else self.terrain.shadow_batch)
        paths = []
        todo = list(self.chunks())
        for n_done, (t0, n_t) in enumerate(todo, start=1):
            path = self._chunk_path(t0)
            paths.append(path)
            if os.path.exists(path):
                continue
            out = fn(self.sun_positions[t0:t0 + n_t])
            tmp = path + ".tmp.npy"
            np.save(tmp, out.cpu().numpy())
            os.replace(tmp, path)   # atomic: no partial chunks on crash
            if verbose:
                print(f"sun-track chunk t={t0} done "
                      f"[{n_done}/{len(todo)}]")
        return paths

    def assemble(self):
        """Merge the on-disk chunks into the full (T, in0, in1) array."""
        parts = [np.load(self._chunk_path(t0)) for t0, _ in self.chunks()]
        return np.concatenate(parts, axis=0)
