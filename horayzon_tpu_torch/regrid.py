# Copyright (c) 2026
# MIT License
"""Planarisation of curved-Earth ENU meshes onto regular grids.

Copy of :mod:`horayzon_tpu.regrid`, made because importing ``horayzon_tpu``
loads JAX; ``tests/test_torch_schedule.py`` holds the copy equal to the
original.  It runs once per dataset on the host, in NumPy float64.

The reference ray-traces curved (lon/lat) domains by embedding the DEM in
local tangent-plane ENU coordinates and building an Embree BVH over the
irregular vertex cloud (examples/horizon/gridded_curved_DEM.py;
horizon_comp.cpp:101-231).  The TPU sweep kernels instead require a *regular*
heightfield so that ray marching is a uniform shift of the whole grid
(ops/sweep.py).

This module bridges the two: it resamples the curved ENU surface
``(X(i,j), Y(i,j), Z(i,j))`` onto a regular (x, y) lattice at native
resolution.  The inverse mapping (x, y) -> fractional grid index is solved by
vectorised Newton iteration seeded with a global affine fit; for the smooth,
near-affine lon/lat->ENU mappings of real DEM domains this converges to
sub-millicell accuracy in a handful of iterations.  Earth curvature is
retained exactly: the resampled heightfield's z *is* the ENU z (terrain drops
away from the tangent plane with distance).

The companion forward mapping (original cell -> regular-grid position) is a
closed form ``(X - x0)/dx``, used to read swept results (horizon, SVF, ...)
back onto the original lon/lat grid.
"""

import dataclasses

import numpy as np

from horayzon_tpu_torch.terrain import GridSpec


@dataclasses.dataclass
class PlanarizedGrid:
    """Regular-grid resampling of a curved ENU mesh."""
    grid: GridSpec            # regular lattice (x0, y0, dx, dy, shape)
    z: np.ndarray             # (Hr, Wr) float32 ENU z; clamp-to-edge outside
    valid: np.ndarray         # (Hr, Wr) bool: inside the source mesh
    fi: np.ndarray            # (Hr, Wr) float64 source fractional row index
    fj: np.ndarray            # (Hr, Wr) float64 source fractional col index

    def sample_source_field(self, field):
        """Bilinear sample of a per-source-vertex field at the resample
        points (e.g. lon, lat, or precomputed unit vectors)."""
        return _bilinear(np.asarray(field, dtype=np.float64), self.fi,
                         self.fj)

    def to_regular_indices(self, x_pts, y_pts):
        """Map ENU positions to fractional indices of the regular grid."""
        g = self.grid
        return ((np.asarray(y_pts) - g.y0) / g.dy,
                (np.asarray(x_pts) - g.x0) / g.dx)


def _bilinear(a, fi, fj):
    h, w = a.shape[:2]
    i0 = np.clip(np.floor(fi).astype(np.int64), 0, h - 2)
    j0 = np.clip(np.floor(fj).astype(np.int64), 0, w - 2)
    wi = np.clip(fi - i0, 0.0, 1.0)
    wj = np.clip(fj - j0, 0.0, 1.0)
    if a.ndim == 3:
        wi = wi[..., None]
        wj = wj[..., None]
    return ((1 - wi) * (1 - wj) * a[i0, j0]
            + (1 - wi) * wj * a[i0, j0 + 1]
            + wi * (1 - wj) * a[i0 + 1, j0]
            + wi * wj * a[i0 + 1, j0 + 1])


def invert_mapping(x_src, y_src, x_t, y_t, num_iter=8):
    """Solve X(fi, fj) = x_t, Y(fi, fj) = y_t by vectorised Newton.

    Parameters
    ----------
    x_src, y_src : (H, W) float64
        ENU coordinates of the source mesh vertices.
    x_t, y_t : arrays (same shape)
        Target ENU positions.

    Returns
    -------
    fi, fj : float64 arrays — fractional source indices (clipped to the
        grid); ``converged`` bool array.
    """
    h, w = x_src.shape
    # Global affine seed: [x; y] ~= A [j; i] + b (least squares over a
    # subsample of the mesh)
    step_i = max(1, h // 64)
    step_j = max(1, w // 64)
    ii, jj = np.mgrid[0:h:step_i, 0:w:step_j]
    ones = np.ones(ii.size)
    m = np.stack([jj.ravel(), ii.ravel(), ones], axis=1)
    cx, *_ = np.linalg.lstsq(m, x_src[::step_i, ::step_j].ravel(),
                             rcond=None)
    cy, *_ = np.linalg.lstsq(m, y_src[::step_i, ::step_j].ravel(),
                             rcond=None)
    a_mat = np.array([[cx[0], cx[1]], [cy[0], cy[1]]])
    b_vec = np.array([cx[2], cy[2]])
    a_inv = np.linalg.inv(a_mat)

    res = np.stack([np.asarray(x_t, dtype=np.float64) - b_vec[0],
                    np.asarray(y_t, dtype=np.float64) - b_vec[1]], axis=-1)
    fj = a_inv[0, 0] * res[..., 0] + a_inv[0, 1] * res[..., 1]
    fi = a_inv[1, 0] * res[..., 0] + a_inv[1, 1] * res[..., 1]

    for _ in range(num_iter):
        fi_c = np.clip(fi, 0.0, h - 1.0)
        fj_c = np.clip(fj, 0.0, w - 1.0)
        x_cur = _bilinear(x_src, fi_c, fj_c)
        y_cur = _bilinear(y_src, fi_c, fj_c)
        # Local Jacobian via central-ish finite differences of the bilinear
        # interpolant (exact within a cell)
        eps = 0.5
        dxdj = (_bilinear(x_src, fi_c, np.clip(fj_c + eps, 0, w - 1))
                - _bilinear(x_src, fi_c, np.clip(fj_c - eps, 0, w - 1)))
        dydj = (_bilinear(y_src, fi_c, np.clip(fj_c + eps, 0, w - 1))
                - _bilinear(y_src, fi_c, np.clip(fj_c - eps, 0, w - 1)))
        dxdi = (_bilinear(x_src, np.clip(fi_c + eps, 0, h - 1), fj_c)
                - _bilinear(x_src, np.clip(fi_c - eps, 0, h - 1), fj_c))
        dydi = (_bilinear(y_src, np.clip(fi_c + eps, 0, h - 1), fj_c)
                - _bilinear(y_src, np.clip(fi_c - eps, 0, h - 1), fj_c))
        # Actual step used in the difference (clipping at borders)
        sj = (np.clip(fj_c + eps, 0, w - 1) - np.clip(fj_c - eps, 0, w - 1))
        si = (np.clip(fi_c + eps, 0, h - 1) - np.clip(fi_c - eps, 0, h - 1))
        dxdj /= np.maximum(sj, 1e-9)
        dydj /= np.maximum(sj, 1e-9)
        dxdi /= np.maximum(si, 1e-9)
        dydi /= np.maximum(si, 1e-9)
        det = dxdj * dydi - dxdi * dydj
        det = np.where(np.abs(det) < 1e-12, 1e-12, det)
        rx = np.asarray(x_t) - x_cur
        ry = np.asarray(y_t) - y_cur
        fj = fj_c + (dydi * rx - dxdi * ry) / det
        fi = fi_c + (-dydj * rx + dxdj * ry) / det

    fi_c = np.clip(fi, 0.0, h - 1.0)
    fj_c = np.clip(fj, 0.0, w - 1.0)
    x_cur = _bilinear(x_src, fi_c, fj_c)
    y_cur = _bilinear(y_src, fi_c, fj_c)
    err = np.hypot(np.asarray(x_t) - x_cur, np.asarray(y_t) - y_cur)
    inside = (fi >= -1e-6) & (fi <= h - 1 + 1e-6) \
        & (fj >= -1e-6) & (fj <= w - 1 + 1e-6)
    return fi_c, fj_c, inside & (err < 1.0)


def planarize(x_enu, y_enu, z_enu, target_spacing=None):
    """Resample a curved ENU mesh onto a regular lattice.

    Parameters
    ----------
    x_enu, y_enu, z_enu : (H, W) arrays
        ENU coordinates of the mesh vertices (row-major, as produced by the
        lonlat2ecef -> ecef2enu pipeline; rows typically north-to-south).
    target_spacing : float, optional
        Lattice spacing [m]; defaults to the finest source spacing.

    Returns
    -------
    :class:`PlanarizedGrid`
    """
    x_enu = np.asarray(x_enu, dtype=np.float64)
    y_enu = np.asarray(y_enu, dtype=np.float64)
    z_enu = np.asarray(z_enu, dtype=np.float64)
    if x_enu.shape != y_enu.shape or y_enu.shape != z_enu.shape:
        raise ValueError("Inconsistent shapes of input arrays")
    h, w = x_enu.shape
    if target_spacing is None:
        dxs = np.abs(np.diff(x_enu, axis=1))
        dys = np.abs(np.diff(y_enu, axis=0))
        target_spacing = float(min(dxs[dxs > 0].min(), dys[dys > 0].min()))
    # Preserve the source row direction (north-up grids: y decreasing)
    y_desc = y_enu[-1, 0] < y_enu[0, 0]
    x0 = float(x_enu.min())
    x1 = float(x_enu.max())
    y_lo = float(y_enu.min())
    y_hi = float(y_enu.max())
    wr = int(np.floor((x1 - x0) / target_spacing)) + 1
    hr = int(np.floor((y_hi - y_lo) / target_spacing)) + 1
    x_axis = x0 + np.arange(wr) * target_spacing
    if y_desc:
        y_axis = y_hi - np.arange(hr) * target_spacing
        dy = -target_spacing
        y_start = y_hi
    else:
        y_axis = y_lo + np.arange(hr) * target_spacing
        dy = target_spacing
        y_start = y_lo
    xt, yt = np.meshgrid(x_axis, y_axis)
    fi, fj, ok = invert_mapping(x_enu, y_enu, xt, yt)
    # Out-of-hull lattice cells (the corner wedges of the warped mesh's
    # bounding box) keep the clamp-to-edge bilinear value rather than a
    # sentinel: a sentinel *inside* the lattice passes the sweep's
    # geometric in-domain masks, and a dense-phase parabola fitted through
    # the resulting cliff fabricates phantom peaks several degrees high.
    # Clamp-to-edge terrain is smooth and matches the reference's
    # behaviour of rays simply leaving the scene (horizon_comp.cpp: Embree
    # returns no hit past the mesh).  ``valid`` still records the hull.
    z_res = _bilinear(z_enu, fi, fj).astype(np.float32)
    grid = GridSpec(x0=x0, y0=y_start, dx=target_spacing, dy=dy,
                    shape=(hr, wr))
    return PlanarizedGrid(grid=grid, z=z_res, valid=ok, fi=fi, fj=fj)
