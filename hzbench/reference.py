"""The plain reference that decides ``correct``, and its comparisons.

It reads only the inputs the benchmark made (heights, coordinates, the
mask, the sun positions) and works out the schedule, the pyramid, the
vectors and the results again at a sample of cells, with the frozen sweep
of :mod:`hzbench.sweep`.  It imports nothing of the program.  The slope,
sky view factor and correction-factor arithmetic is copied at commit
c632955 from ``horayzon_tpu_torch/topo_param.py`` (``slope_plane_meth``,
``sky_view_factor``, ``slope_angle_aspect``,
``surface_enlargement_factor``) and ``horayzon_tpu_torch/shadow.py``
(``sun_dots``, ``_classify``), in the same order of operations.

``dtype=torch.bfloat16`` computes everything in bfloat16: the control,
which the comparison has to refuse.
"""

import math

import numpy as np
import torch

from hzbench import sweep as sw

HORIZON_RAY_LIFT = 0.01    # horizon_gridded's ray_org_elev [m]
SHADOW_RAY_LIFT = 0.05     # Terrain's lift of the ray origin [m]
ELEV_ANG_UP_LIM = 89.98    # horizon_sweep_fused's upper limit [degree]


def horizon_plan(scene):
    """The plan of the horizon sweep of a planar scene."""
    return sw.plan_sweep(scene["z"].shape, inner_shape=scene["inner_shape"],
                         offset=scene["offset"],
                         dist_search=scene["dist_search_m"],
                         dx=scene["dx"], dy=scene["dy"],
                         hori_acc=scene["hori_acc"])


def shadow_plan(scene):
    return sw.plan_shadow(scene["z"].shape, inner_shape=scene["inner_shape"],
                          offset=scene["offset"], dx=scene["dx"],
                          dy=scene["dy"], hori_acc=scene["acc"])


def _at(field, cells, di=0, dj=0):
    return field[cells.rows + di, cells.cols + dj]


def tilt_vectors(scene, cells, dtype):
    """(N, 3) tilted normals at the cells: the nine-point plane fit."""
    dev = cells.rows.device
    xs = torch.as_tensor(scene["x"], device=dev)
    ys = torch.as_tensor(scene["y"], device=dev)
    z = scene["z"].to(dtype)
    nb = [(k - 1, l - 1) for k in range(3) for l in range(3)]
    # the float32 coordinate offsets, then the heights in ``dtype``
    x9 = torch.stack([xs[cells.cols + dj] for _, dj in nb])
    y9 = torch.stack([ys[cells.rows + di] for di, _ in nb])
    z9 = torch.stack([_at(z, cells, di, dj) for di, dj in nb])
    xs9, ys9 = (x9 - x9[4]).to(dtype), (y9 - y9[4]).to(dtype)
    zs9 = z9 - z9[4]
    sx, sy, sz = xs9.sum(0), ys9.sum(0), zs9.sum(0)
    sxx, sxy, sxz = (xs9 * xs9).sum(0), (xs9 * ys9).sum(0), \
        (xs9 * zs9).sum(0)
    syy, syz = (ys9 * ys9).sum(0), (ys9 * zs9).sum(0)
    nine = torch.full_like(sx, 9.0)
    a11, a12, a13 = sxx, sxy, sx
    a21, a22, a23 = sxy, syy, sy
    a31, a32, a33 = sx, sy, nine
    det = (a11 * (a22 * a33 - a23 * a32) - a12 * (a21 * a33 - a23 * a31)
           + a13 * (a21 * a32 - a22 * a31))
    v0 = (sxz * (a22 * a33 - a23 * a32) - a12 * (syz * a33 - a23 * sz)
          + a13 * (syz * a32 - a22 * sz)) / det
    v1 = (a11 * (syz * a33 - a23 * sz) - sxz * (a21 * a33 - a23 * a31)
          + a13 * (a21 * sz - syz * a31)) / det
    vec = torch.stack([v0, v1, -torch.ones_like(v0)], dim=-1)
    vec = vec / torch.linalg.vector_norm(vec, dim=-1, keepdim=True)
    return torch.where(vec[..., 2:3] < 0.0, -vec, vec)


def horizon_reference(scene, cells, dtype=torch.float32):
    """At ``cells``: the horizon (N, A) [radian], sky view factor, slope
    and aspect (N,) [radian] of the planar scene."""
    plan = horizon_plan(scene)
    z = scene["z"].to(dtype)
    levels = sw.padded_levels(z, plan["pads"])
    z_inner = _at(z, cells)
    z_org = z_inner + float(np.float32(HORIZON_RAY_LIFT))
    a_num = scene["azim_num"]
    trig = sw.trig_table(a_num)
    raw = sw.sweep_cells(cells, levels, plan, z_inner,
                         sw.horizon_mode(plan, z_org, trig))
    lo, hi = math.radians(scene["elev_ang_low_lim"]), \
        math.radians(ELEV_ANG_UP_LIM)
    hori = raw.atan().clamp(lo, hi).t()
    tilt = tilt_vectors(scene, cells, dtype)
    azim = torch.as_tensor(((2.0 * np.pi) / a_num
                            * np.arange(a_num)).astype(np.float32),
                           device=z.device).to(dtype)
    tx, ty, tz = tilt[:, 0:1], tilt[:, 1:2], tilt[:, 2:3]
    s_az, c_az = torch.sin(azim), torch.cos(azim)
    plane = torch.atan(-s_az * tx / tz - c_az * ty / tz)
    theta = torch.maximum(hori, plane)
    term = ((tx * s_az + ty * c_az)
            * ((math.pi / 2.0) - theta - torch.sin(2.0 * theta) / 2.0)
            + tz * torch.cos(theta) ** 2)
    two_pi = torch.tensor(2.0 * math.pi, dtype=dtype, device=z.device)
    svf = ((azim[1] - azim[0]) / two_pi) * term.sum(dim=-1)
    slope = torch.arccos(torch.clamp(tilt[:, 2], max=1.0))
    aspect = math.pi / 2.0 - torch.atan2(tilt[:, 1], tilt[:, 0])
    aspect = torch.where(aspect < 0.0, aspect + 2.0 * math.pi, aspect)
    return {"hori": hori, "svf": svf, "slope": slope, "aspect": aspect}


def shadow_metric(scene, cells, suns, dtype=torch.float32, hook=None):
    """The exact occlusion metric (T, N) of ``suns`` (T, 3) at ``cells``,
    with the (T,) near-vertical flags, the plan, the sun table and the
    ray slopes.  ``hook`` (a :class:`hzbench.sweep.SkipCount` maker,
    ``hook(plan, levels, z_org, table, m)``) runs the sweep with the
    kernel's skips."""
    plan = shadow_plan(scene)
    z = scene["z"].to(dtype)
    levels = sw.padded_levels(z, plan["pads"])
    z_inner = _at(z, cells)
    z_org = z_inner + float(np.float32(SHADOW_RAY_LIFT))
    table, near = sw.sun_table(suns, scene["center"], scene["dx"],
                               scene["dy"])
    m = sw.ray_slopes(cells, z_org, table, plan, scene["grid_origin"])
    h = None if hook is None else hook(plan, levels, z_org, table, m)
    metric = sw.sweep_cells(cells, levels, plan, z_inner,
                            sw.shadow_mode(plan, z_org, table, m), hook=h)
    return metric, near, h


def sw_dir_cor_reference(scene, cells, suns, dtype=torch.float32):
    """The correction factor (T, N) of ``suns`` at ``cells``."""
    dev = cells.rows.device
    metric, near, _ = shadow_metric(scene, cells, suns, dtype)
    lit = ~torch.as_tensor(near, device=dev)[:, None]
    occluded = (metric > 0.0) & lit
    z = scene["z"].to(dtype)
    x_in = torch.as_tensor(scene["x"], device=dev).to(dtype)[cells.cols]
    y_in = torch.as_tensor(scene["y"], device=dev).to(dtype)[cells.rows]
    z_org = _at(z, cells) + float(np.float32(SHADOW_RAY_LIFT))
    tilt = tilt_vectors(scene, cells, dtype)
    norm = torch.zeros_like(tilt)
    norm[:, 2] = 1.0
    p = norm * tilt
    surf_enl = 1.0 / ((p[:, 0] + p[:, 1]) + p[:, 2])
    sp = torch.as_tensor(np.asarray(suns, dtype=np.float32),
                         device=dev).to(dtype)
    sx = sp[:, 0:1] - x_in
    sy = sp[:, 1:2] - y_in
    sz = sp[:, 2:3] - z_org
    mag = sw.sqrt_rn(sx * sx + sy * sy + sz * sz)
    sun = (sx / mag, sy / mag, sz / mag)

    def dot3(v):
        return (v[:, 0] * sun[0] + v[:, 1] * sun[1]) + v[:, 2] * sun[2]

    dot_ns, dot_ts = dot3(norm), dot3(tilt)
    dot_min = float(np.float32(math.cos(math.radians(scene["ang_max"]))))
    val = (dot_ts / torch.maximum(dot_ns, dot_ns.new_tensor(dot_min))) \
        * surf_enl
    val = torch.where(occluded, 0.0, val)
    return torch.where(dot_ts > dot_min, val, 0.0)


def angle_gap(a, b):
    """|a - b| of two angles [radian], taken around the circle."""
    d = (a - b).abs() % (2.0 * math.pi)
    return torch.minimum(d, 2.0 * math.pi - d)
