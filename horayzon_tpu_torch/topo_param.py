# Copyright (c) 2026
# MIT License
"""Derived terrain parameters in torch: slope normals, sky view factor,
visible sky fraction, topographic openness, slope angle and aspect,
surface enlargement factor.

Counterpart of :mod:`horayzon_tpu.topo_param` (slope_plane_meth,
slope_vector_meth, sky_view_factor, visible_sky_fraction,
topographic_openness, slope_angle_aspect, surface_enlargement_factor),
which computes them with XLA outside any Pallas kernel.  Plain torch,
batched over all cells; the per-cell 3x3 least-squares solve is the
reference's closed-form Cramer solve.  Inputs may be tensors or numpy
arrays; everything runs on the device of the input tensors.
"""

import math

import numpy as np
import torch

__all__ = ["slope_plane_meth", "slope_vector_meth", "sky_view_factor",
           "visible_sky_fraction", "topographic_openness",
           "slope_angle_aspect", "surface_enlargement_factor"]


def _as_f32(a, name):
    if isinstance(a, np.ndarray):
        a = torch.from_numpy(np.require(a, requirements="W"))
    a = torch.as_tensor(a)
    if a.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"input array '{name}' has incorrect data type")
    return a.to(torch.float32)


def _nine_point_stack(a):
    """Stack the 3x3 neighbourhood of every interior cell: (9, H-2, W-2)."""
    h, w = a.shape
    return torch.stack([a[k:k + h - 2, l:l + w - 2]
                        for k in range(3) for l in range(3)])


def slope_plane_meth(x, y, z, rot_mat=None, output_rot=False):
    """Plane-based slope computation (ArcGIS 9-point least-squares fit).

    Mirrors ``horayzon_tpu.topo_param.slope_plane_meth``.  Returns tilted
    surface normal unit vectors, shape (H, W, 3) float32; border cells are
    NaN.  ``rot_mat`` (H, W, 3, 3): optional per-cell rotations to a local
    frame whose z-axis is local up; ``output_rot`` keeps the normals in
    that frame.
    """
    x = _as_f32(x, "x")
    y = _as_f32(y, "y")
    z = _as_f32(z, "z")
    if x.shape != y.shape or y.shape != z.shape:
        raise ValueError("Inconsistent shapes of input arrays")
    if rot_mat is not None:
        rot_mat = _as_f32(rot_mat, "rot_mat")
        if rot_mat.shape[:2] != x.shape:
            raise ValueError("Inconsistent shapes of input arrays")
    # Translate: coordinates relative to the centre cell
    coord = torch.stack([_nine_point_stack(x) - x[1:-1, 1:-1],
                         _nine_point_stack(y) - y[1:-1, 1:-1],
                         _nine_point_stack(z) - z[1:-1, 1:-1]], dim=-1)
    if rot_mat is not None:
        rot = rot_mat[1:-1, 1:-1]  # (Hc, Wc, 3, 3)
        coord = torch.einsum("hwab,khwb->khwa", rot, coord)

    xs, ys, zs = coord[..., 0], coord[..., 1], coord[..., 2]
    sx = xs.sum(dim=0)
    sy = ys.sum(dim=0)
    sz = zs.sum(dim=0)
    sxx = (xs * xs).sum(dim=0)
    sxy = (xs * ys).sum(dim=0)
    sxz = (xs * zs).sum(dim=0)
    syy = (ys * ys).sum(dim=0)
    syz = (ys * zs).sum(dim=0)
    nine = torch.full_like(sx, 9.0)

    # Solve  [[sxx sxy sx], [sxy syy sy], [sx sy 9]] v = [sxz, syz, sz]
    # per cell via Cramer's rule.
    a11, a12, a13 = sxx, sxy, sx
    a21, a22, a23 = sxy, syy, sy
    a31, a32, a33 = sx, sy, nine
    det = (a11 * (a22 * a33 - a23 * a32)
           - a12 * (a21 * a33 - a23 * a31)
           + a13 * (a21 * a32 - a22 * a31))
    v0 = (sxz * (a22 * a33 - a23 * a32)
          - a12 * (syz * a33 - a23 * sz)
          + a13 * (syz * a32 - a22 * sz)) / det
    v1 = (a11 * (syz * a33 - a23 * sz)
          - sxz * (a21 * a33 - a23 * a31)
          + a13 * (a21 * sz - syz * a31)) / det

    vec = torch.stack([v0, v1, -torch.ones_like(v0)], dim=-1)
    vec = vec / torch.linalg.vector_norm(vec, dim=-1, keepdim=True)
    # Orient upwards
    vec = torch.where(vec[..., 2:3] < 0.0, -vec, vec)

    if rot_mat is not None and not output_rot:
        # Rotate back with the transposed matrices
        vec = torch.einsum("hwba,hwb->hwa", rot_mat[1:-1, 1:-1], vec)

    out = torch.full(tuple(x.shape) + (3,), math.nan, dtype=torch.float32,
                     device=x.device)
    out[1:-1, 1:-1] = vec
    return out


def slope_vector_meth(x, y, z, rot_mat=None, output_rot=False):
    """Vector-based slope computation: the average of the four triangle
    normals around each cell (Corripio 2003).

    Mirrors ``horayzon_tpu.topo_param.slope_vector_meth``.  Returns tilted
    surface normal unit vectors flipped to ``z >= 0``, shape (H, W, 3)
    float32; border cells are NaN.  ``rot_mat`` (H, W, 3, 3): optional
    per-cell rotations; with ``output_rot`` the normals are rotated by them
    (as the reference does), otherwise ``rot_mat`` is only validated.
    """
    x = _as_f32(x, "x")
    y = _as_f32(y, "y")
    z = _as_f32(z, "z")
    if x.shape != y.shape or y.shape != z.shape:
        raise ValueError("Inconsistent shapes of input arrays")
    if output_rot and (rot_mat is None):
        raise ValueError("'rot_mat' must be provided for 'output_rot = True'")
    if rot_mat is not None:
        rot_mat = _as_f32(rot_mat, "rot_mat")
        if rot_mat.shape[:2] != x.shape:
            raise ValueError("Inconsistent shapes of input arrays")

    def xyz(sl0, sl1):
        return torch.stack([x[sl0, sl1], y[sl0, sl1], z[sl0, sl1]], dim=-1)

    mid, lo, hi = slice(1, -1), slice(None, -2), slice(2, None)
    c = xyz(mid, mid)
    left, down = xyz(mid, lo) - c, xyz(hi, mid) - c
    right, up = xyz(mid, hi) - c, xyz(lo, mid) - c
    cross = torch.linalg.cross
    vec = (((cross(left, down) + cross(down, right)) + cross(right, up))
           + cross(up, left)) / 4.0
    vec = vec / torch.linalg.vector_norm(vec, dim=-1, keepdim=True)
    vec = torch.where(vec[..., 2:3] < 0.0, -vec, vec)
    if rot_mat is not None and output_rot:
        vec = torch.einsum("hwab,hwb->hwa", rot_mat[1:-1, 1:-1], vec)
    out = torch.full(tuple(x.shape) + (3,), math.nan, dtype=torch.float32,
                     device=x.device)
    out[1:-1, 1:-1] = vec
    return out


def _sky_inputs(azim, hori, vec_tilt):
    """The validated float32 ``azim`` (A,), ``hori`` (H, W, A), ``vec_tilt``
    (H, W, 3) of the sky parameters, and ``theta``: the horizon clamped
    from below by the tilted plane's own horizon (the plane-sphere
    intersection, topo_param.pyx:442-449), which the sky view factor and
    the visible sky fraction share.  Returns (azim, vec_tilt, theta)."""
    azim = _as_f32(azim, "azim")
    hori = _as_f32(hori, "hori")
    vec_tilt = _as_f32(vec_tilt, "vec_tilt")
    if ((azim.shape[0] != hori.shape[2])
            or (hori.shape[:2] != vec_tilt.shape[:2])
            or (vec_tilt.shape[2] != 3)):
        raise ValueError("Inconsistent/incorrect shapes of input arrays")
    azim_sin = torch.sin(azim)  # (A,)
    azim_cos = torch.cos(azim)
    tx = vec_tilt[..., 0:1]
    ty = vec_tilt[..., 1:2]
    tz = vec_tilt[..., 2:3]
    hori_plane = torch.atan(-azim_sin * tx / tz - azim_cos * ty / tz)
    return azim, vec_tilt, torch.maximum(hori, hori_plane)


def _azim_weight(azim):
    """``(azim[1] - azim[0]) / (2 pi)``, divided by a tensor on the
    device: a CUDA tensor over a Python scalar is a product with the
    scalar's reciprocal, which rounds twice."""
    two_pi = torch.tensor(2.0 * math.pi, dtype=torch.float32,
                          device=azim.device)
    return (azim[1] - azim[0]) / two_pi


def sky_view_factor(azim, hori, vec_tilt):
    """Sky view factor: fraction of isotropic sky radiation received.

    Mirrors ``horayzon_tpu.topo_param.sky_view_factor``: ``azim`` (A,)
    [radian], ``hori`` (H, W, A) [radian], ``vec_tilt`` (H, W, 3).
    Returns (H, W) float32.
    """
    azim, vec_tilt, theta = _sky_inputs(azim, hori, vec_tilt)
    tx = vec_tilt[..., 0:1]
    ty = vec_tilt[..., 1:2]
    tz = vec_tilt[..., 2:3]
    term = ((tx * torch.sin(azim) + ty * torch.cos(azim))
            * ((math.pi / 2.0) - theta - torch.sin(2.0 * theta) / 2.0)
            + tz * torch.cos(theta) ** 2)
    return _azim_weight(azim) * term.sum(dim=-1)


def visible_sky_fraction(azim, hori, vec_tilt):
    """Visible sky fraction: the solid angle of the visible sky.

    Mirrors ``horayzon_tpu.topo_param.visible_sky_fraction``; arguments as
    :func:`sky_view_factor`.  Returns (H, W) float32.
    """
    azim, _, theta = _sky_inputs(azim, hori, vec_tilt)
    term = 1.0 - torch.cos((math.pi / 2.0) - theta)
    return _azim_weight(azim) * term.sum(dim=-1)


def topographic_openness(azim, hori):
    """Positive topographic openness (Yokoyama et al. 2002): the mean over
    the azimuths of ``pi/2 - hori``.

    Mirrors ``horayzon_tpu.topo_param.topographic_openness``.  Returns
    (H, W) float32 [radian].
    """
    azim = _as_f32(azim, "azim")
    hori = _as_f32(hori, "hori")
    if azim.shape[0] != hori.shape[2]:
        raise ValueError("Inconsistent/incorrect shapes of input arrays")
    return ((math.pi / 2.0) - hori).mean(dim=-1)


def slope_angle_aspect(vec_tilt):
    """Slope angle and aspect (clockwise from North) from tilted normals.

    Returns (slope [radian], aspect [radian, 0..2pi]) float32 tensors.
    """
    vec_tilt = _as_f32(vec_tilt, "vec_tilt")
    slope = torch.arccos(torch.clamp(vec_tilt[..., 2], max=1.0))
    aspect = math.pi / 2.0 - torch.atan2(vec_tilt[..., 1], vec_tilt[..., 0])
    aspect = torch.where(aspect < 0.0, aspect + 2.0 * math.pi, aspect)
    return slope, aspect


def surface_enlargement_factor(vec_norm, vec_tilt):
    """Surface enlargement factor 1 / (norm . tilt).

    Mirrors ``horayzon_tpu.topo_param.surface_enlargement_factor`` (the
    computation of the reference examples, e.g.
    examples/shadow/gridded_planar_DEM_artificial.py:96-99): ``vec_norm``
    and ``vec_tilt`` (H, W, 3).  Returns (H, W) float32 on their device.
    """
    vec_norm = _as_f32(vec_norm, "vec_norm")
    vec_tilt = _as_f32(vec_tilt, "vec_tilt").to(vec_norm.device)
    p = vec_norm * vec_tilt
    return 1.0 / ((p[..., 0] + p[..., 1]) + p[..., 2])
