"""The plain reference of a curved (lon/lat) horizon run, which decides
``correct`` in the curved cells.

It starts from the scene's ``lon``, ``lat`` and heights alone and works
everything out again at a sample of inner cells, importing nothing of the
program.  Copied at commit dae790f from ``horayzon_tpu_torch``, each in
its order of operations:

* the geometry (NumPy float64 on the host, as the program's):
  ``transform.lonlat2ecef``, ``TransformerEcef2enu``, ``ecef2enu``,
  ``ecef2enu_vector``, ``rotation_matrix_glob2loc``;
  ``direction.surf_norm``, ``north_dir``; ``CurvedPipeline.build_geometry``;
* the planarisation, rewritten in torch float64 so that it runs on the
  scene's device: ``regrid.planarize``, ``invert_mapping``, ``_bilinear``
  (the affine seed's least squares stays NumPy's, on the host);
* the lattice box, its interpolated normals and ramps:
  ``horizon.curved_lattice``;
* the tilt ramp ``(raw + sin(az) * A) + cos(az) * B`` of
  ``ops/fused_sweep.py::_add_tilt``, then the arctan and the clamp;
* the float64 bilinear read-back: ``horizon.read_back``;
* the rotated plane fit, sky view factor, slope and aspect:
  ``topo_param.slope_plane_meth(rot_mat=..., output_rot=True)``,
  ``sky_view_factor``, ``slope_angle_aspect``.

The horizon is swept by the frozen sweep (:mod:`hzbench.sweep`) at the
lattice cells of the bilinear stencils of the sampled inner cells only.
``dtype=torch.bfloat16`` runs the sweep, the ramp and the topographic
parameters in bfloat16 (the program's float64 geometry, planarisation and
read-back weights stay float64): the control, which the comparison has to
refuse.
"""

import math

import numpy as np
import torch

from hzbench import reference as ref
from hzbench import sweep as sw

F32 = np.float32
SPHERE_R = 6370997.0
WGS_A = 6378137.0
FLATTENING = {"GRS80": 1.0 / 298.257222101, "WGS84": 1.0 / 298.257223563}


# ---------------------------------------------------------------------------
# Geometry (NumPy float64, the program's own precision)
# ---------------------------------------------------------------------------

def ellipsoid(ellps):
    """(a, b, e^2) of ``ellps``."""
    if ellps == "sphere":
        return SPHERE_R, SPHERE_R, 0.0
    a = WGS_A
    b = a * (1.0 - FLATTENING[ellps])
    return a, b, 1.0 - (b ** 2 / a ** 2)


def lonlat2ecef(lon, lat, h, ellps):
    lon_r = np.deg2rad(np.asarray(lon, dtype=np.float64))
    lat_r = np.deg2rad(np.asarray(lat, dtype=np.float64))
    h = np.asarray(h)
    if ellps == "sphere":
        r = SPHERE_R + h
        return (r * np.cos(lat_r) * np.cos(lon_r),
                r * np.cos(lat_r) * np.sin(lon_r), r * np.sin(lat_r))
    a, b, e_2 = ellipsoid(ellps)
    n = a / np.sqrt(1.0 - e_2 * np.sin(lat_r) ** 2)
    return ((n + h) * np.cos(lat_r) * np.cos(lon_r),
            (n + h) * np.cos(lat_r) * np.sin(lon_r),
            (b ** 2 / a ** 2 * n + h) * np.sin(lat_r))


def enu_frame(lon_or, lat_or, ellps):
    """The ENU origin's ECEF position and the ECEF-to-ENU rotation."""
    origin = [float(v) for v in lonlat2ecef(
        np.array(lon_or), np.array(lat_or), np.array(0.0, dtype=F32),
        ellps)]
    sin_lon, cos_lon = np.sin(np.deg2rad(lon_or)), np.cos(np.deg2rad(lon_or))
    sin_lat, cos_lat = np.sin(np.deg2rad(lat_or)), np.cos(np.deg2rad(lat_or))
    return origin, (sin_lon, cos_lon, sin_lat, cos_lat)


def ecef2enu(xe, ye, ze, frame):
    (x0, y0, z0), (sin_lon, cos_lon, sin_lat, cos_lat) = frame
    dx, dy, dz = xe - x0, ye - y0, ze - z0
    return ((-sin_lon * dx + cos_lon * dy).astype(F32),
            (-sin_lat * cos_lon * dx - sin_lat * sin_lon * dy
             + cos_lat * dz).astype(F32),
            (+cos_lat * cos_lon * dx + cos_lat * sin_lon * dy
             + sin_lat * dz).astype(F32))


def ecef2enu_vector(vec, frame):
    _, (sin_lon, cos_lon, sin_lat, cos_lat) = frame
    rot = np.array([[-sin_lon, cos_lon, 0.0],
                    [-sin_lat * cos_lon, -sin_lat * sin_lon, cos_lat],
                    [cos_lat * cos_lon, cos_lat * sin_lon, sin_lat]],
                   dtype=np.float64)
    return (vec.astype(np.float64) @ rot.T).astype(F32)


def surf_norm(lon, lat):
    lon_r = np.deg2rad(np.asarray(lon, dtype=np.float64))
    lat_r = np.deg2rad(np.asarray(lat, dtype=np.float64))
    return np.stack([np.cos(lat_r) * np.cos(lon_r),
                     np.cos(lat_r) * np.sin(lon_r), np.sin(lat_r)],
                    axis=-1).astype(F32)


def north_dir(xe, ye, ze, vn, ellps):
    _, b, _ = ellipsoid(ellps)
    vn = vn.astype(np.float64)
    vec = np.stack([-xe, -ye, b - ze], axis=-1)
    dot = np.sum(vec * vn, axis=-1, keepdims=True)
    proj = vec - dot * vn
    norm = np.linalg.norm(proj, axis=-1, keepdims=True)
    return (proj / norm).astype(F32)


def geometry(scene):
    """The ENU mesh ``x``, ``y``, ``z`` (H, W) float32 and the inner cells'
    unit normals and norths (in0, in1, 3) float32, from the scene's
    ``lon``, ``lat``, heights ``z`` and inner domain."""
    lon_2d, lat_2d = np.meshgrid(scene["lon"], scene["lat"])
    dom = scene["domain"]
    lon_or = float(np.mean([dom["lon_min"], dom["lon_max"]]))
    lat_or = float(np.mean([dom["lat_min"], dom["lat_max"]]))
    frame = enu_frame(lon_or, lat_or, scene["ellps"])
    h = scene["z"].cpu().numpy()
    xe, ye, ze = lonlat2ecef(lon_2d, lat_2d, h, scene["ellps"])
    x, y, z = ecef2enu(xe, ye, ze, frame)
    (o0, o1), (in0, in1) = scene["offset"], scene["inner_shape"]
    sl = (slice(o0, o0 + in0), slice(o1, o1 + in1))
    vn = surf_norm(lon_2d[sl], lat_2d[sl])
    vnorth = north_dir(xe[sl], ye[sl], ze[sl], vn, scene["ellps"])
    return dict(x=x, y=y, z=z, vec_norm=ecef2enu_vector(vn, frame),
                vec_north=ecef2enu_vector(vnorth, frame))


# ---------------------------------------------------------------------------
# Planarisation (torch float64 on the scene's device)
# ---------------------------------------------------------------------------

def bilinear(a, fi, fj):
    """``regrid._bilinear`` in torch: ``a`` (h, w) or (h, w, c)."""
    h, w = a.shape[:2]
    i0 = fi.floor().long().clamp(0, h - 2)
    j0 = fj.floor().long().clamp(0, w - 2)
    wi = (fi - i0).clamp(0.0, 1.0)
    wj = (fj - j0).clamp(0.0, 1.0)
    if a.dim() == 3:
        wi, wj = wi[..., None], wj[..., None]
    return ((1 - wi) * (1 - wj) * a[i0, j0]
            + (1 - wi) * wj * a[i0, j0 + 1]
            + wi * (1 - wj) * a[i0 + 1, j0]
            + wi * wj * a[i0 + 1, j0 + 1])


def invert_mapping(x_src, y_src, x_t, y_t, num_iter=8):
    """``regrid.invert_mapping`` without its convergence flags: the
    fractional source indices (fi, fj) of the targets, clipped."""
    h, w = x_src.shape
    step_i, step_j = max(1, h // 64), max(1, w // 64)
    ii, jj = np.mgrid[0:h:step_i, 0:w:step_j]
    m = np.stack([jj.ravel(), ii.ravel(), np.ones(ii.size)], axis=1)
    xs = x_src[::step_i, ::step_j].cpu().numpy().ravel()
    ys = y_src[::step_i, ::step_j].cpu().numpy().ravel()
    cx, *_ = np.linalg.lstsq(m, xs, rcond=None)
    cy, *_ = np.linalg.lstsq(m, ys, rcond=None)
    a_inv = np.linalg.inv(np.array([[cx[0], cx[1]], [cy[0], cy[1]]]))
    (a00, a01), (a10, a11) = a_inv.tolist()
    r0, r1 = x_t - float(cx[2]), y_t - float(cy[2])
    fj = a00 * r0 + a01 * r1
    fi = a10 * r0 + a11 * r1
    eps = 0.5

    def jc(v):
        return v.clamp(0, w - 1)

    def ic(v):
        return v.clamp(0, h - 1)

    for _ in range(num_iter):
        fi_c, fj_c = fi.clamp(0.0, h - 1.0), fj.clamp(0.0, w - 1.0)
        x_cur = bilinear(x_src, fi_c, fj_c)
        y_cur = bilinear(y_src, fi_c, fj_c)
        dxdj = (bilinear(x_src, fi_c, jc(fj_c + eps))
                - bilinear(x_src, fi_c, jc(fj_c - eps)))
        dydj = (bilinear(y_src, fi_c, jc(fj_c + eps))
                - bilinear(y_src, fi_c, jc(fj_c - eps)))
        dxdi = (bilinear(x_src, ic(fi_c + eps), fj_c)
                - bilinear(x_src, ic(fi_c - eps), fj_c))
        dydi = (bilinear(y_src, ic(fi_c + eps), fj_c)
                - bilinear(y_src, ic(fi_c - eps), fj_c))
        sj = jc(fj_c + eps) - jc(fj_c - eps)
        si = ic(fi_c + eps) - ic(fi_c - eps)
        dxdj = dxdj / sj.clamp_min(1e-9)
        dydj = dydj / sj.clamp_min(1e-9)
        dxdi = dxdi / si.clamp_min(1e-9)
        dydi = dydi / si.clamp_min(1e-9)
        det = dxdj * dydi - dxdi * dydj
        det = torch.where(det.abs() < 1e-12, 1e-12, det)
        rx = x_t - x_cur
        ry = y_t - y_cur
        fj = fj_c + (dydi * rx - dxdi * ry) / det
        fi = fi_c + (-dydj * rx + dxdj * ry) / det
    return fi.clamp(0.0, h - 1.0), fj.clamp(0.0, w - 1.0)


def planarize(x, y, z, device):
    """``regrid.planarize`` of the float32 ENU mesh at its finest spacing:
    a dict of the lattice (``x0``, ``y0``, ``dx``, ``dy``, ``shape``), its
    float32 heights ``z`` and the source indices ``fi``, ``fj`` (float64),
    on ``device``."""
    x, y, z = (torch.as_tensor(a, device=device).double() for a in (x, y, z))
    dxs = (x[:, 1:] - x[:, :-1]).abs()
    dys = (y[1:, :] - y[:-1, :]).abs()
    spacing = float(min(dxs[dxs > 0].min(), dys[dys > 0].min()))
    y_desc = bool(y[-1, 0] < y[0, 0])
    x0, x1 = float(x.min()), float(x.max())
    y_lo, y_hi = float(y.min()), float(y.max())
    wr = int(np.floor((x1 - x0) / spacing)) + 1
    hr = int(np.floor((y_hi - y_lo) / spacing)) + 1
    x_axis = x0 + torch.arange(wr, dtype=torch.float64, device=device) \
        * spacing
    n_r = torch.arange(hr, dtype=torch.float64, device=device) * spacing
    y_axis, dy, y0 = ((y_hi - n_r, -spacing, y_hi) if y_desc
                      else (y_lo + n_r, spacing, y_lo))
    yt, xt = torch.meshgrid(y_axis, x_axis, indexing="ij")
    fi, fj = invert_mapping(x, y, xt, yt)
    return dict(x0=x0, y0=y0, dx=spacing, dy=dy, shape=(hr, wr),
                z=bilinear(z, fi, fj).float(), fi=fi, fj=fj)


# ---------------------------------------------------------------------------
# The lattice box and the horizon at the sampled cells
# ---------------------------------------------------------------------------

def lattice(scene, geo=None):
    """The planarised lattice of the scene's DEM and its box: a dict of
    :func:`planarize`'s lattice, ``box`` ``(i_lo, i_hi, j_lo, j_hi)``, the
    inner cells' lattice positions ``fi_in``, ``fj_in`` (float32), the
    ramps ``ramp_a``, ``ramp_b`` on the box (float32) and the geometry
    ``geo`` (:func:`geometry`)."""
    geo = geometry(scene) if geo is None else geo
    dev = scene["z"].device
    pg = planarize(geo["x"], geo["y"], geo["z"], dev)
    (o0, o1), (in0, in1) = scene["offset"], scene["inner_shape"]
    hr, wr = pg["shape"]
    sl = (slice(o0, o0 + in0), slice(o1, o1 + in1))
    # float32, as the program's NumPy forms them from the float32 mesh
    x_in = torch.as_tensor(geo["x"][sl], device=dev)
    y_in = torch.as_tensor(geo["y"][sl], device=dev)
    fi_in = (y_in - float(F32(pg["y0"]))) / float(F32(pg["dy"]))
    fj_in = (x_in - float(F32(pg["x0"]))) / float(F32(pg["dx"]))
    i_lo = max(int(np.floor(float(fi_in.min()))) - 1, 0)
    i_hi = min(int(np.ceil(float(fi_in.max()))) + 2, hr)
    j_lo = max(int(np.floor(float(fj_in.min()))) - 1, 0)
    j_hi = min(int(np.ceil(float(fj_in.max()))) + 2, wr)
    fi_src = (pg["fi"][i_lo:i_hi, j_lo:j_hi] - o0).clamp(0.0, in0 - 1.0)
    fj_src = (pg["fj"][i_lo:i_hi, j_lo:j_hi] - o1).clamp(0.0, in1 - 1.0)
    vn = torch.as_tensor(geo["vec_norm"], device=dev).double()
    norm_r = bilinear(vn, fi_src, fj_src)
    norm_r = norm_r / torch.sqrt((norm_r * norm_r).sum(-1, keepdim=True))
    return dict(pg, box=(i_lo, i_hi, j_lo, j_hi), fi_in=fi_in, fj_in=fj_in,
                ramp_a=(norm_r[..., 0] / norm_r[..., 2]).float(),
                ramp_b=(norm_r[..., 1] / norm_r[..., 2]).float(), geo=geo)


def lattice_scene(scene, lat=None):
    """The planar scene of the lattice box that K1's tilt variant sweeps
    (:func:`hzbench.roofline.k1_bound` reads it)."""
    lat = lattice(scene) if lat is None else lat
    i_lo, i_hi, j_lo, j_hi = lat["box"]
    return dict(z=lat["z"], inner_shape=(i_hi - i_lo, j_hi - j_lo),
                offset=(i_lo, j_lo), dx=lat["dx"], dy=lat["dy"],
                dist_search_m=scene["dist_search_m"],
                hori_acc=scene["hori_acc"], azim_num=scene["azim_num"])


def _stencils(lat, cells):
    """The read-back stencils of ``cells`` in the box: (i0, j0) (N,)
    int64 and the weights (w00, w01, w10, w11) (N,) float64."""
    i_lo, i_hi, j_lo, j_hi = lat["box"]
    rin0, rin1 = i_hi - i_lo, j_hi - j_lo
    fi = (lat["fi_in"][cells.ii, cells.jj] - i_lo).clamp(0.0, rin0 - 1.0)
    fj = (lat["fj_in"][cells.ii, cells.jj] - j_lo).clamp(0.0, rin1 - 1.0)
    i0 = fi.floor().long().clamp(0, rin0 - 2)
    j0 = fj.floor().long().clamp(0, rin1 - 2)
    # exact in float32, as in the program's float64
    wi = (fi - i0).clamp(0.0, 1.0).double()
    wj = (fj - j0).clamp(0.0, 1.0).double()
    return i0, j0, ((1 - wi) * (1 - wj), (1 - wi) * wj, wi * (1 - wj),
                    wi * wj)


def lattice_horizon(scene, lat, rows, cols, dtype=torch.float32):
    """(N, A) horizon [radian] at the box's lattice cells ``rows``,
    ``cols`` (box indices, (N,) int64): the frozen sweep of the box's plan,
    the tilt ramp, the arctan and the clamp."""
    i_lo, i_hi, j_lo, j_hi = lat["box"]
    plan = sw.plan_sweep(lat["shape"], inner_shape=(i_hi - i_lo, j_hi - j_lo),
                         offset=(i_lo, j_lo),
                         dist_search=scene["dist_search_m"], dx=lat["dx"],
                         dy=lat["dy"], hori_acc=scene["hori_acc"])
    cells = sw.Cells(rows=rows + i_lo, cols=cols + j_lo, ii=rows, jj=cols,
                     weight=torch.ones(rows.shape, dtype=torch.float64,
                                       device=rows.device))
    z = lat["z"].to(dtype)
    levels = sw.padded_levels(z, plan["pads"])
    z_inner = z[cells.rows, cells.cols]
    z_org = z_inner + float(F32(ref.HORIZON_RAY_LIFT))
    trig = sw.trig_table(scene["azim_num"])
    raw = sw.sweep_cells(cells, levels, plan, z_inner,
                         sw.horizon_mode(plan, z_org, trig))
    tab = torch.as_tensor(trig, device=z.device).to(dtype)
    ux, uy = tab[:, 0, None], tab[:, 1, None]
    raw = ((raw + ux * lat["ramp_a"][rows, cols].to(dtype))
           + uy * lat["ramp_b"][rows, cols].to(dtype))
    lo = math.radians(scene["elev_ang_low_lim"])
    hi = math.radians(ref.ELEV_ANG_UP_LIM)
    return raw.atan().clamp(lo, hi).t()


def tilt_vectors(geo, cells, dtype):
    """(N, 3) tilted normals at ``cells`` in their local frames: the
    nine-point plane fit of the ENU mesh rotated into each cell's (east,
    north, normal) frame."""
    dev = cells.rows.device
    rows, cols = cells.rows.cpu().numpy(), cells.cols.cpu().numpy()
    ii, jj = cells.ii.cpu().numpy(), cells.jj.cpu().numpy()
    north, norm = geo["vec_north"][ii, jj], geo["vec_norm"][ii, jj]
    rot = np.stack([np.cross(north, norm, axisa=1, axisb=1), north, norm],
                   axis=1)
    rot = torch.as_tensor(rot, device=dev).to(dtype)       # (N, 3, 3)
    nb = [(k - 1, m - 1) for k in range(3) for m in range(3)]
    coord = []
    for name in ("x", "y", "z"):
        a = geo[name]
        c = np.stack([a[rows + di, cols + dj] - a[rows, cols]
                      for di, dj in nb])                     # (9, N) float32
        coord.append(torch.as_tensor(c, device=dev).to(dtype))
    # rot @ (x, y, z) per cell and neighbour
    xs, ys, zs = ((rot[None, :, r, 0] * coord[0]
                   + rot[None, :, r, 1] * coord[1])
                  + rot[None, :, r, 2] * coord[2] for r in range(3))
    sx, sy, sz = xs.sum(0), ys.sum(0), zs.sum(0)
    sxx, sxy, sxz = (xs * xs).sum(0), (xs * ys).sum(0), (xs * zs).sum(0)
    syy, syz = (ys * ys).sum(0), (ys * zs).sum(0)
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


def horizon_reference(scene, cells, dtype=torch.float32, lat=None):
    """At ``cells`` (whole kernel blocks of the inner lon/lat grid): the
    horizon (N, A) [radian], sky view factor, slope and aspect (N,)
    [radian] of the curved scene.  ``lat``: the scene's :func:`lattice`,
    when the caller has it already."""
    lat = lattice(scene) if lat is None else lat
    i0, j0, wts = _stencils(lat, cells)
    # the stencils' lattice cells, each swept once
    ci = torch.stack([i0, i0, i0 + 1, i0 + 1])
    cj = torch.stack([j0, j0 + 1, j0, j0 + 1])
    w1 = lat["box"][3] - lat["box"][2]
    key, inv = torch.unique(ci * w1 + cj, return_inverse=True)
    hl = lattice_horizon(scene, lat, key // w1, key % w1, dtype)
    a = hl.double()[inv]                                     # (4, N, A)
    terms = [wts[k][:, None] * a[k] for k in range(4)]
    hori = (((terms[0] + terms[1]) + terms[2]) + terms[3]).to(
        torch.float32).to(dtype)
    tilt = tilt_vectors(lat["geo"], cells, dtype)
    a_num = scene["azim_num"]
    azim = torch.as_tensor(((2.0 * np.pi) / a_num
                            * np.arange(a_num)).astype(F32),
                           device=hori.device).to(dtype)
    tx, ty, tz = tilt[:, 0:1], tilt[:, 1:2], tilt[:, 2:3]
    s_az, c_az = torch.sin(azim), torch.cos(azim)
    plane = torch.atan(-s_az * tx / tz - c_az * ty / tz)
    theta = torch.maximum(hori, plane)
    term = ((tx * s_az + ty * c_az)
            * ((math.pi / 2.0) - theta - torch.sin(2.0 * theta) / 2.0)
            + tz * torch.cos(theta) ** 2)
    two_pi = torch.tensor(2.0 * math.pi, dtype=dtype, device=hori.device)
    svf = ((azim[1] - azim[0]) / two_pi) * term.sum(dim=-1)
    slope = torch.arccos(torch.clamp(tilt[:, 2], max=1.0))
    aspect = math.pi / 2.0 - torch.atan2(tilt[:, 1], tilt[:, 0])
    aspect = torch.where(aspect < 0.0, aspect + 2.0 * math.pi, aspect)
    return {"hori": hori, "svf": svf, "slope": slope, "aspect": aspect}
