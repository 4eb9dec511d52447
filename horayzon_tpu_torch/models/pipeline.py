# Copyright (c) 2026
# MIT License
"""End-to-end planar pipeline: the counterpart of
:class:`horayzon_tpu.models.PlanarPipeline`."""

import numpy as np
import torch

from horayzon_tpu_torch import auxiliary, horizon, topo_param


class PlanarPipeline:
    """Planar-DEM terrain-parameter pipeline.

    Equivalent to examples/horizon/gridded_planar_DEM.py: given the outer
    x/y/elevation grid and the inner-domain bounds, computes horizon, slope,
    SVF, and slope angle/aspect on ``device`` (the card unless the caller
    asks for the CPU).
    """

    def __init__(self, x, y, elevation, domain, dist_search, azim_num=180,
                 hori_acc=0.25, elev_ang_low_lim=-15.0, *, device="cuda"):
        self.x = np.asarray(x, dtype=np.float32)
        self.y = np.asarray(y, dtype=np.float32)
        self.elevation = np.asarray(elevation, dtype=np.float32)
        self.dist_search = dist_search
        self.azim_num = azim_num
        self.hori_acc = hori_acc
        self.elev_ang_low_lim = elev_ang_low_lim
        self.device = torch.device(device)
        # Inner-domain slices (gridded_planar_DEM.py:60-67)
        self.slice_in = (
            slice(np.where(self.y >= domain["y_max"])[0][-1],
                  np.where(self.y <= domain["y_min"])[0][0] + 1),
            slice(np.where(self.x <= domain["x_min"])[0][-1],
                  np.where(self.x >= domain["x_max"])[0][0] + 1))
        self.offset_0 = self.slice_in[0].start
        self.offset_1 = self.slice_in[1].start

    def run(self, mask=None):
        """Compute all terrain parameters; returns a dict of tensors on the
        pipeline's device."""
        dem_dim_0, dem_dim_1 = self.elevation.shape
        in0 = self.slice_in[0].stop - self.slice_in[0].start
        in1 = self.slice_in[1].stop - self.slice_in[1].start
        vec_norm = np.zeros((in0, in1, 3), dtype=np.float32)
        vec_norm[:, :, 2] = 1.0
        vec_north = np.zeros((in0, in1, 3), dtype=np.float32)
        vec_north[:, :, 1] = 1.0
        x_2d, y_2d = np.meshgrid(self.x, self.y)
        vert_grid = auxiliary.rearrange_pad_buffer(
            x_2d.astype(np.float32), y_2d.astype(np.float32), self.elevation)
        hori, azim = horizon.horizon_gridded(
            vert_grid, dem_dim_0, dem_dim_1, vec_norm, vec_north,
            self.offset_0, self.offset_1, dist_search=self.dist_search,
            azim_num=self.azim_num, hori_acc=self.hori_acc,
            elev_ang_low_lim=self.elev_ang_low_lim, mask=mask,
            device=self.device)

        def on_device(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        sl = (slice(self.slice_in[0].start - 1, self.slice_in[0].stop + 1),
              slice(self.slice_in[1].start - 1, self.slice_in[1].stop + 1))
        vec_tilt = topo_param.slope_plane_meth(
            on_device(x_2d[sl]), on_device(y_2d[sl]),
            on_device(self.elevation[sl]))[1:-1, 1:-1]
        svf = topo_param.sky_view_factor(azim, hori, vec_tilt)
        slope, aspect = topo_param.slope_angle_aspect(vec_tilt)
        return {"hori": hori, "azim": azim, "svf": svf, "slope": slope,
                "aspect": aspect, "vec_tilt": vec_tilt,
                "elevation": on_device(self.elevation[self.slice_in]),
                "x": on_device(self.x[self.slice_in[1]]),
                "y": on_device(self.y[self.slice_in[0]])}
