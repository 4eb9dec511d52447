# Copyright (c) 2026
# MIT License
"""Terrain grid utilities (copy of part of :mod:`horayzon_tpu.terrain`).

Vertex-buffer decomposition, regular-grid detection, the planar-vector
test and the general sweep geometry's basis fields and marching
directions, copied because importing ``horayzon_tpu`` loads JAX.
``tests/test_torch_schedule.py`` holds the copies equal to the originals.
"""

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Regular-grid geometry: ``x = x0 + j*dx``, ``y = y0 + i*dy``.

    ``dy`` is signed; north-up grids (decreasing y with row index) have
    ``dy < 0``.
    """
    x0: float
    y0: float
    dx: float
    dy: float
    shape: tuple  # (H, W)

    def x_axis(self):
        return self.x0 + np.arange(self.shape[1]) * self.dx

    def y_axis(self):
        return self.y0 + np.arange(self.shape[0]) * self.dy

    def crop(self, offset, inner_shape):
        return GridSpec(x0=self.x0 + offset[1] * self.dx,
                        y0=self.y0 + offset[0] * self.dy,
                        dx=self.dx, dy=self.dy, shape=tuple(inner_shape))


def decompose_vert_grid(vert_grid, dem_dim_0, dem_dim_1):
    """Flat padded (x, y, z) vertex buffer -> three (H, W) float32 arrays.

    Inverse of :func:`horayzon_tpu_torch.auxiliary.rearrange_pad_buffer`;
    the trailing padding is dropped.
    """
    vert_grid = np.asarray(vert_grid, dtype=np.float32)
    n = dem_dim_0 * dem_dim_1 * 3
    if vert_grid.size < n:
        raise ValueError("inconsistency between input arguments vert_grid, "
                         "dem_dim_0 and dem_dim_1")
    v = vert_grid[:n].reshape(dem_dim_0, dem_dim_1, 3)
    return v[..., 0], v[..., 1], v[..., 2]


def detect_regular_grid(x, y, rtol=1.0e-3):
    """Detect a regular axis-aligned grid; return a :class:`GridSpec` or None.

    Requires x to vary only along the second axis and y only along the first,
    both with uniform spacing (within ``rtol`` of the spacing).
    """
    x = np.asarray(x)
    y = np.asarray(y)
    if x.ndim != 2 or x.shape != y.shape:
        return None
    x_row = x[0]
    y_col = y[:, 0]
    grid = axes_grid(x_row, y_col, rtol)
    if grid is None:
        return None
    if np.abs(x - x_row[None, :]).max() > abs(grid.dx) * rtol:
        return None
    if np.abs(y - y_col[:, None]).max() > abs(grid.dy) * rtol:
        return None
    return grid


def axes_grid(x_axis, y_axis, rtol=1.0e-3):
    """The :class:`GridSpec` of the grid ``np.meshgrid(x_axis, y_axis)``,
    or None: both axes 1-D with at least two points and a nonzero spacing
    uniform within ``rtol`` of it (:func:`detect_regular_grid`'s test of
    a grid's first row and column, which it applies here)."""
    x_axis = np.asarray(x_axis)
    y_axis = np.asarray(y_axis)
    if x_axis.ndim != 1 or y_axis.ndim != 1:
        return None
    w, h = len(x_axis), len(y_axis)
    if w < 2 or h < 2:
        return None
    dx = float(x_axis[1] - x_axis[0])
    dy = float(y_axis[1] - y_axis[0])
    if dx == 0.0 or dy == 0.0:
        return None
    if np.abs(np.diff(x_axis) - dx).max() > abs(dx) * rtol:
        return None
    if np.abs(np.diff(y_axis) - dy).max() > abs(dy) * rtol:
        return None
    return GridSpec(x0=float(x_axis[0]), y0=float(y_axis[0]),
                    dx=dx, dy=dy, shape=(h, w))


def is_default_planar_vectors(vec_norm, vec_north, atol=1.0e-6):
    """True if norm == (0,0,1) and north == (0,1,0) everywhere (the planar
    configuration of e.g. examples/horizon/gridded_planar_DEM.py:71-76)."""
    vec_norm = np.asarray(vec_norm)
    vec_north = np.asarray(vec_north)
    expect_norm = np.array([0.0, 0.0, 1.0], dtype=vec_norm.dtype)
    expect_north = np.array([0.0, 1.0, 0.0], dtype=vec_north.dtype)
    return (np.abs(vec_norm - expect_norm).max() <= atol
            and np.abs(vec_north - expect_north).max() <= atol)


def basis_fields(vec_norm, vec_north):
    """Per-cell orthonormal basis fields for the general sweep geometry.

    east = north x norm (the reference's rot_inv columns,
    horizon_comp.cpp:772-779).  Returns a dict of (in0, in1) float32 arrays.
    """
    vec_norm = np.asarray(vec_norm, dtype=np.float32)
    vec_north = np.asarray(vec_north, dtype=np.float32)
    east = np.cross(vec_north, vec_norm)
    return {
        "ex": east[..., 0], "ey": east[..., 1], "ez": east[..., 2],
        "nx2": vec_north[..., 0], "ny2": vec_north[..., 1],
        "nz2": vec_north[..., 2],
        "mx": vec_norm[..., 0], "my": vec_norm[..., 1],
        "mz": vec_norm[..., 2],
    }


def mean_marching_directions(azim, vec_norm, vec_north):
    """Domain-mean horizontal marching direction per azimuth: (A, 2).

    u3 = sin(a) * mean_east + cos(a) * mean_north, projected to the
    horizontal plane and normalised.
    """
    vec_norm = np.asarray(vec_norm, dtype=np.float64)
    vec_north = np.asarray(vec_north, dtype=np.float64)
    east = np.cross(vec_north, vec_norm)
    e_mean = east.reshape(-1, 3).mean(axis=0)
    n_mean = vec_north.reshape(-1, 3).mean(axis=0)
    azim = np.asarray(azim, dtype=np.float64)
    u3 = (np.sin(azim)[:, None] * e_mean[None, :]
          + np.cos(azim)[:, None] * n_mean[None, :])
    u_xy = u3[:, :2]
    norm = np.linalg.norm(u_xy, axis=1, keepdims=True)
    return u_xy / np.maximum(norm, 1.0e-12)
