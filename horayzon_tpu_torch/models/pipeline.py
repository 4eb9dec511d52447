# Copyright (c) 2026
# MIT License
"""End-to-end pipelines: the counterparts of
:class:`horayzon_tpu.models.PlanarPipeline` and
:class:`horayzon_tpu.models.CurvedPipeline`."""

import numpy as np
import torch

from horayzon_tpu_torch import horizon, terrain, topo_param, transform
from horayzon_tpu_torch.ops import geometry
from horayzon_tpu_torch.utils.profiling import span


def _on_device(a, device):
    """Host array ``a`` as a tensor on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


class PlanarPipeline:
    """Planar-DEM terrain-parameter pipeline.

    Equivalent to examples/horizon/gridded_planar_DEM.py: given the outer
    x/y/elevation grid and the inner-domain bounds, computes horizon, slope,
    SVF, and slope angle/aspect on ``device`` (the card unless the caller
    asks for the CPU).  ``vert_simp`` and ``tri_ind_simp`` (flat float32
    x, y, z of the vertices and flat int32 indices, three a triangle) give
    a simplified outer TIN as the far field, as
    examples/horizon/gridded_planar_DEM_2m.py attaches one: the elevation
    grid is then the fine grid around the inner domain, and the horizon
    takes the entry's ``tin`` route.
    """

    def __init__(self, x, y, elevation, domain, dist_search, azim_num=180,
                 hori_acc=0.25, elev_ang_low_lim=-15.0, *, vert_simp=None,
                 tri_ind_simp=None, device="cuda"):
        self.x = np.asarray(x, dtype=np.float32)
        self.y = np.asarray(y, dtype=np.float32)
        self.elevation = np.asarray(elevation, dtype=np.float32)
        self.vert_simp = (None if vert_simp is None else
                          np.asarray(vert_simp, dtype=np.float32).reshape(-1))
        self.tri_ind_simp = (None if tri_ind_simp is None else
                             np.asarray(tri_ind_simp,
                                        dtype=np.int32).reshape(-1))
        # the entry's counts, its defaults without a TIN
        self.num_vert_simp = (1 if self.vert_simp is None
                              else len(self.vert_simp) // 3)
        self.num_tri_simp = (1 if self.tri_ind_simp is None
                             else len(self.tri_ind_simp) // 3)
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

        Uniform 1-D axes (:func:`terrain.axes_grid`) hand
        :func:`horizon.gridded_planes` their grid, so no plane of x or y is
        formed; other axes hand it their meshgrid's planes to test, as the
        reference's vertex buffer does.  The outputs are the same.  A TIN
        goes to the entry with the grid; other axes with a TIN are refused
        there (``ValueError``)."""
        with span("hzt.pipeline.run"):
            s0, s1 = self.slice_in
            with span("hzt.pipeline.grid"):
                grid = terrain.axes_grid(self.x, self.y)
                x = y = None
                if grid is None:
                    x, y = np.meshgrid(self.x, self.y)
            hori, azim = horizon.gridded_planes(
                x, y, self.elevation, None, None,
                (self.offset_0, self.offset_1),
                (s0.stop - s0.start, s1.stop - s1.start),
                self.dist_search, azim_num=self.azim_num,
                hori_acc=self.hori_acc,
                elev_ang_low_lim=self.elev_ang_low_lim, mask=mask,
                vert_simp=self.vert_simp, num_vert_simp=self.num_vert_simp,
                tri_ind_simp=self.tri_ind_simp,
                num_tri_simp=self.num_tri_simp, grid=grid,
                device=self.device)
            with span("hzt.pipeline.topo"):
                sl = (slice(s0.start - 1, s0.stop + 1),
                      slice(s1.start - 1, s1.stop + 1))
                z = _on_device(self.elevation[sl], self.device)
                x_in = _on_device(self.x[sl[1]], self.device)
                y_in = _on_device(self.y[sl[0]], self.device)
                # the meshgrid's planes, broadcast on the device
                vec_tilt = topo_param.slope_plane_meth(
                    x_in[None, :].expand_as(z), y_in[:, None].expand_as(z),
                    z)[1:-1, 1:-1]
                svf = topo_param.sky_view_factor(azim, hori, vec_tilt)
                slope, aspect = topo_param.slope_angle_aspect(vec_tilt)
            with span("hzt.pipeline.outputs"):
                return {"hori": hori, "azim": azim, "svf": svf,
                        "slope": slope, "aspect": aspect, "vec_tilt": vec_tilt,
                        "elevation": z[1:-1, 1:-1].contiguous(),
                        "x": x_in[1:-1], "y": y_in[1:-1]}


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
        """ENU mesh + per-cell unit vectors (the L2 stage of the reference
        pipeline, SURVEY section 3.5), float32 arrays in host memory: on a
        CUDA device one launch of the geometry kernel and one read-back
        (:func:`horayzon_tpu_torch.ops.geometry.build`), on the CPU NumPy
        float64 on the meshgrid."""
        with span("hzt.curved.geometry"):
            lon_or = float(np.mean([self.domain["lon_min"],
                                    self.domain["lon_max"]]))
            lat_or = float(np.mean([self.domain["lat_min"],
                                    self.domain["lat_max"]]))
            self.trans = transform.TransformerEcef2enu(lon_or, lat_or,
                                                       self.ellps)
            (self.x, self.y, self.z, self.vec_norm,
             self.vec_north) = geometry.build(
                self.lon, self.lat, self.elevation, self.slice_in,
                self.trans, device=self.device)
        return self

    def run(self, mask=None):
        """Compute all terrain parameters; returns a dict of tensors on the
        pipeline's device."""
        with span("hzt.curved.run"):
            if not hasattr(self, "x"):
                self.build_geometry()
            sl = self.slice_in
            hori, azim = horizon.gridded_planes(
                self.x, self.y, self.z, self.vec_norm, self.vec_north,
                (self.offset_0, self.offset_1), self.vec_norm.shape[:2],
                self.dist_search, azim_num=self.azim_num,
                hori_acc=self.hori_acc,
                elev_ang_low_lim=self.elev_ang_low_lim, mask=mask,
                verbose=False, device=self.device)
            # Tilted normals in the local tangent frames (reference pattern:
            # rotation_matrix_glob2loc + slope_plane_meth,
            # gridded_curved_DEM.py)
            with span("hzt.curved.topo"):
                sl1 = (slice(sl[0].start - 1, sl[0].stop + 1),
                       slice(sl[1].start - 1, sl[1].stop + 1))
                rot = transform.rotation_matrix_glob2loc(self.vec_north,
                                                         self.vec_norm)
                vec_tilt = topo_param.slope_plane_meth(
                    *(_on_device(a[sl1], self.device)
                      for a in (self.x, self.y, self.z)),
                    rot_mat=_on_device(rot, self.device),
                    output_rot=True)[1:-1, 1:-1]
                svf = topo_param.sky_view_factor(azim, hori, vec_tilt)
                slope, aspect = topo_param.slope_angle_aspect(vec_tilt)
            with span("hzt.curved.outputs"):
                return {"hori": hori, "azim": azim, "svf": svf,
                        "slope": slope, "aspect": aspect,
                        "vec_tilt": vec_tilt,
                        "elevation": _on_device(self.elevation[sl],
                                                self.device),
                        "lon": _on_device(self.lon[sl[1]], self.device),
                        "lat": _on_device(self.lat[sl[0]], self.device)}
