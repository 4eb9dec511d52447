# Copyright (c) 2026
# MIT License
"""End-to-end pipelines: the counterparts of
:class:`horayzon_tpu.models.PlanarPipeline` and
:class:`horayzon_tpu.models.CurvedPipeline`."""

import numpy as np
import torch

from horayzon_tpu_torch import (auxiliary, direction, horizon, terrain,
                                topo_param, transform)
from horayzon_tpu_torch.utils import profiling
from horayzon_tpu_torch.utils.profiling import span


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
        pipeline's device.

        Uniform 1-D axes (:func:`terrain.axes_grid`) go to the fused sweep
        straight, with the heights as they are; other axes go through the
        vertex buffer and ``horizon_gridded``, as the reference does.  The
        outputs are the same."""
        with span("hzt.pipeline.run"):
            s0, s1 = self.slice_in
            inner_shape = (s0.stop - s0.start, s1.stop - s1.start)
            with span("hzt.pipeline.grid"):
                grid = terrain.axes_grid(self.x, self.y)
                profiling.count_route("planar_buffer" if grid is None
                                      else "planar_axes")
                if grid is None:
                    vec_norm = np.zeros(inner_shape + (3,), dtype=np.float32)
                    vec_norm[:, :, 2] = 1.0
                    vec_north = np.zeros(inner_shape + (3,),
                                         dtype=np.float32)
                    vec_north[:, :, 1] = 1.0
                    x_2d, y_2d = np.meshgrid(self.x, self.y)
                    vert_grid = auxiliary.rearrange_pad_buffer(
                        x_2d.astype(np.float32), y_2d.astype(np.float32),
                        self.elevation)
                    planes = (x_2d, y_2d, self.elevation)
                else:
                    # the meshgrid's planes, broadcast on the device
                    x_dev = self._on_device(self.x)
                    y_dev = self._on_device(self.y)
                    planes = (x_dev[None, :].expand(len(y_dev), -1),
                              y_dev[:, None].expand(-1, len(x_dev)))
            if grid is None:
                hori, azim = horizon.horizon_gridded(
                    vert_grid, *self.elevation.shape, vec_norm, vec_north,
                    self.offset_0, self.offset_1,
                    dist_search=self.dist_search, azim_num=self.azim_num,
                    hori_acc=self.hori_acc,
                    elev_ang_low_lim=self.elev_ang_low_lim, mask=mask,
                    device=self.device)
            else:
                with span("hzt.horizon.check"):
                    mask, masked = horizon._check_planar(
                        self.elevation.shape, (self.offset_0, self.offset_1),
                        inner_shape, hori_acc=self.hori_acc, mask=mask,
                        ray_org_elev=0.01)
                hori, azim, z_dev = horizon._fused_planar(
                    self.elevation, grid,
                    offset=(self.offset_0, self.offset_1),
                    inner_shape=inner_shape, mask=mask, masked=masked,
                    hori_fill=0.0, verbose=True, device=self.device,
                    azim_num=self.azim_num,
                    dist_search=self.dist_search * 1000.0,
                    hori_acc=self.hori_acc,
                    elev_ang_low_lim=self.elev_ang_low_lim,
                    ray_org_elev=0.01)
                planes += (z_dev,)
            with span("hzt.pipeline.topo"):
                sl = (slice(s0.start - 1, s0.stop + 1),
                      slice(s1.start - 1, s1.stop + 1))
                vec_tilt = topo_param.slope_plane_meth(
                    *(self._on_device(a[sl]) for a in planes))[1:-1, 1:-1]
                svf = topo_param.sky_view_factor(azim, hori, vec_tilt)
                slope, aspect = topo_param.slope_angle_aspect(vec_tilt)
            with span("hzt.pipeline.outputs"):
                return {"hori": hori, "azim": azim, "svf": svf,
                        "slope": slope, "aspect": aspect, "vec_tilt": vec_tilt,
                        "elevation": self._on_device(
                            planes[2][self.slice_in]).contiguous(),
                        "x": self._on_device(self.x[s1]),
                        "y": self._on_device(self.y[s0])}

    def _on_device(self, a):
        """A copy of host array ``a`` on the pipeline's device; a tensor
        (there already) as it is."""
        if isinstance(a, torch.Tensor):
            return a
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)


class CurvedPipeline:
    """Curved-Earth (lon/lat) terrain-parameter pipeline.

    Equivalent to examples/horizon/gridded_curved_DEM.py: lon/lat DEM with
    ellipsoidal heights -> ECEF -> local ENU mesh -> (planarised) horizon
    sweep -> SVF/slope on the lon/lat inner grid, on ``device`` (the card
    unless the caller asks for the CPU).

    Parameters
    ----------
    lon, lat : 1-D coordinate axes [degree] (lat typically descending).
    elevation : (len(lat), len(lon)) ellipsoidal heights [metre].
    domain : dict with inner lon/lat bounds.
    dist_search : float [kilometre].
    ellps : "sphere" | "GRS80" | "WGS84".
    """

    def __init__(self, lon, lat, elevation, domain, dist_search,
                 azim_num=180, hori_acc=0.25, ellps="WGS84",
                 elev_ang_low_lim=-85.0, *, device="cuda"):
        self.lon = np.asarray(lon, dtype=np.float64)
        self.lat = np.asarray(lat, dtype=np.float64)
        self.elevation = np.asarray(elevation, dtype=np.float32)
        self.domain = domain
        self.dist_search = dist_search
        self.azim_num = azim_num
        self.hori_acc = hori_acc
        self.ellps = ellps
        self.elev_ang_low_lim = elev_ang_low_lim
        self.device = torch.device(device)
        # Inner-domain slices (gridded_curved_DEM.py pattern)
        self.slice_in = (
            slice(np.where(self.lat >= domain["lat_max"])[0][-1],
                  np.where(self.lat <= domain["lat_min"])[0][0] + 1),
            slice(np.where(self.lon <= domain["lon_min"])[0][-1],
                  np.where(self.lon >= domain["lon_max"])[0][0] + 1))
        self.offset_0 = self.slice_in[0].start
        self.offset_1 = self.slice_in[1].start

    def build_geometry(self):
        """ENU mesh + per-cell unit vectors on the host (the L2 stage of the
        reference pipeline, SURVEY section 3.5)."""
        with span("hzt.curved.geometry"):
            lon_2d, lat_2d = np.meshgrid(self.lon, self.lat)
            lon_or = float(np.mean([self.domain["lon_min"],
                                    self.domain["lon_max"]]))
            lat_or = float(np.mean([self.domain["lat_min"],
                                    self.domain["lat_max"]]))
            self.trans = transform.TransformerEcef2enu(lon_or, lat_or,
                                                       self.ellps)
            xe, ye, ze = transform.lonlat2ecef(lon_2d, lat_2d,
                                               self.elevation, self.ellps)
            self.x, self.y, self.z = transform.ecef2enu(xe, ye, ze,
                                                        self.trans)
            sl = self.slice_in
            vn_ecef = direction.surf_norm(lon_2d[sl], lat_2d[sl])
            vnorth_ecef = direction.north_dir(xe[sl], ye[sl], ze[sl],
                                              vn_ecef, self.ellps)
            self.vec_norm = transform.ecef2enu_vector(vn_ecef, self.trans)
            self.vec_north = transform.ecef2enu_vector(vnorth_ecef,
                                                       self.trans)
        return self

    def run(self, mask=None):
        """Compute all terrain parameters; returns a dict of tensors on the
        pipeline's device."""
        with span("hzt.curved.run"):
            profiling.count_route("curved_tilt")
            if not hasattr(self, "x"):
                self.build_geometry()
            dem_dim_0, dem_dim_1 = self.elevation.shape
            with span("hzt.curved.buffer"):
                vert_grid = auxiliary.rearrange_pad_buffer(self.x, self.y,
                                                           self.z)
            hori, azim = horizon.horizon_gridded(
                vert_grid, dem_dim_0, dem_dim_1, self.vec_norm,
                self.vec_north, self.offset_0, self.offset_1,
                dist_search=self.dist_search, azim_num=self.azim_num,
                hori_acc=self.hori_acc,
                elev_ang_low_lim=self.elev_ang_low_lim, mask=mask,
                verbose=False, device=self.device)

            def on_device(a):
                return torch.from_numpy(np.ascontiguousarray(a)).to(
                    self.device)

            # Tilted normals in the local tangent frames (reference pattern:
            # rotation_matrix_glob2loc + slope_plane_meth,
            # gridded_curved_DEM.py)
            sl = self.slice_in
            with span("hzt.curved.topo"):
                sl1 = (slice(sl[0].start - 1, sl[0].stop + 1),
                       slice(sl[1].start - 1, sl[1].stop + 1))
                rot = transform.rotation_matrix_glob2loc(self.vec_north,
                                                         self.vec_norm)
                vec_tilt = topo_param.slope_plane_meth(
                    on_device(self.x[sl1]), on_device(self.y[sl1]),
                    on_device(self.z[sl1]), rot_mat=on_device(rot),
                    output_rot=True)[1:-1, 1:-1]
                svf = topo_param.sky_view_factor(azim, hori, vec_tilt)
                slope, aspect = topo_param.slope_angle_aspect(vec_tilt)
            with span("hzt.curved.outputs"):
                return {"hori": hori, "azim": azim, "svf": svf,
                        "slope": slope, "aspect": aspect,
                        "vec_tilt": vec_tilt,
                        "elevation": on_device(self.elevation[sl]),
                        "lon": on_device(self.lon[sl[1]]),
                        "lat": on_device(self.lat[sl[0]])}
