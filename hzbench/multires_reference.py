"""The plain reference of a horizon run with a simplified outer TIN as the
far field, which decides ``correct`` in the 2 m multires cell.

It starts from the scene's fine grid, its axes and its TIN alone and
works the far field, the pyramid and the results out again at a sample
of inner cells, importing nothing of the program.  Copied at commit
87af39b from ``horayzon_tpu_torch``, each in its order of operations:

* the ratio rule: ``horizon.tin_ratio_log2`` (the JAX package's
  ``horayzon_tpu/horizon.py:608-645``) and ``ops/multires.py::
  validate_fine_halo``, on the frozen schedule of :mod:`hzbench.sweep`;
* the coarse far field: ``ops/multires.py::coarse_grid_from_tin`` (the
  lattice, the raster's resolution, the vertex scatter, the fine
  overlay) with its own rasteriser in place of ``rasterize_tin``'s loop
  over triangles: the same float64 operations in the same order,
  vectorised over chunks of triangles and their bounding boxes, in torch
  on the scene's device, the overlapping values' maximum taken by a
  scatter;
* the combined pyramid: ``ops/multires.py::combined_pyramid``, with the
  frozen 2 x 2 max-pool of :mod:`hzbench.sweep` (``mip.max_downsample2``);
* then the frozen sweep (:func:`hzbench.sweep.sweep_cells`) of the fine
  grid's plan at the sampled cells over that pyramid, and the tilt, sky
  view factor, slope and aspect of :mod:`hzbench.reference`
  (``horizon_reference``'s arithmetic, copied).

Departures: the rasteriser is vectorised (its values are the loop's bit
for bit: each point's weights and height are the same float64
operations, and a maximum does not depend on the order); the far field
is built on the scene's device.  TF32 is switched off for matrix
products and convolutions (none is used; the switch keeps it so).

``dtype=torch.bfloat16`` runs the pyramid, the sweep and the topographic
parameters in bfloat16 (the ratio rule and the rasterisation stay
float64, the far field float32): the control, which the comparison has to
refuse.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from hzbench import reference as ref
from hzbench import roofline
from hzbench import sweep as sw

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

#: Triangles rasterised at once.
CHUNK = 2048


def _tin(scene):
    """The TIN as the program takes it: (V, 3) float32 vertices and (T, 3)
    int64 indices, NumPy arrays."""
    verts = np.asarray(torch.as_tensor(scene["vert_simp"]).cpu(),
                       dtype=np.float32).reshape(-1, 3)
    tris = np.asarray(torch.as_tensor(scene["tri_ind_simp"]).cpu(),
                      dtype=np.int64).reshape(-1, 3)
    return verts, tris


def ratio_log2(scene, verts, n_tri):
    """log2 of the coarse / fine spacing ratio of the scene's TIN
    (``verts`` (V, 3) float32, ``n_tri`` triangles): from the TIN's mean
    triangle footprint (two triangles a quad of coarse cells), clipped to
    1..8, then reduced until the fine grid's halo covers every phase that
    reads a fine-derived level."""
    dx, dy = scene["dx"], scene["dy"]
    bbox_cells = (max(np.ptp(verts[:, 0]) / abs(dx), 1.0)
                  * max(np.ptp(verts[:, 1]) / abs(dy), 1.0))
    cells_per_tri = max(bbox_cells / max(n_tri, 1), 2.0)
    r = int(np.clip(round(math.log2(math.sqrt(cells_per_tri / 2.0))), 1, 8))
    step = min(abs(dx), abs(dy))
    phases, s_values = sw.build_schedule(step, scene["dist_search_m"],
                                         sw.default_rel_err(scene["hori_acc"]))
    (off0, off1), (in0, in1) = scene["offset"], scene["inner_shape"]
    hf, wf = scene["z"].shape
    halo = min(off0, off1, hf - off0 - in0, wf - off1 - in1)
    while True:
        s_fine_max = 0.0
        for ph, s_vals in zip(phases, s_values):
            if ph.level < r:
                s_fine_max = max(s_fine_max, float(s_vals[-1]))
        if halo >= int(math.ceil(s_fine_max / step)) + 2:
            return r
        if r == 1:
            raise ValueError("the fine grid's halo is too small for the "
                             "schedule at ratio 1")
        r -= 1


def rasterize(verts, tris, *, origin_xy, spacing_xy, shape, device,
              fill=sw.PAD_VALUE):
    """(H, W) float32 on ``device``: the TIN's height at each lattice point
    by barycentric interpolation, the maximum where triangles overlap,
    ``fill`` outside every triangle (``rasterize_tin``'s values)."""
    f64 = dict(dtype=torch.float64, device=device)
    v = torch.as_tensor(np.asarray(verts, dtype=np.float64), **f64)
    t = torch.as_tensor(np.asarray(tris, dtype=np.int64), device=device)
    x0, y0 = origin_xy
    sx, sy = spacing_xy
    h, w = shape
    out = torch.full((h * w,), fill, **f64)
    vi = (v[:, 1] - y0) / sy
    vj = (v[:, 0] - x0) / sx
    vz = v[:, 2]
    eps, tol = 1.0e-9, 1.0e-6
    for c0 in range(0, t.shape[0], CHUNK):
        a, b, c = t[c0:c0 + CHUNK].unbind(1)
        ia, ib, ic = vi[a], vi[b], vi[c]
        ja, jb, jc = vj[a], vj[b], vj[c]
        i_lo = (torch.minimum(torch.minimum(ia, ib), ic) - eps).ceil() \
            .long().clamp_min(0)
        i_hi = (torch.maximum(torch.maximum(ia, ib), ic) + eps).floor() \
            .long().clamp_max(h - 1)
        j_lo = (torch.minimum(torch.minimum(ja, jb), jc) - eps).ceil() \
            .long().clamp_min(0)
        j_hi = (torch.maximum(torch.maximum(ja, jb), jc) + eps).floor() \
            .long().clamp_max(w - 1)
        d = (ib - ia) * (jc - ja) - (jb - ja) * (ic - ia)
        live = (i_hi >= i_lo) & (j_hi >= j_lo) & (d.abs() >= 1.0e-12)
        if not bool(live.any()):
            continue
        bh = int((i_hi - i_lo)[live].max()) + 1
        bw = int((j_hi - j_lo)[live].max()) + 1
        ii = i_lo[:, None, None] + torch.arange(bh, device=device)[:, None]
        jj = j_lo[:, None, None] + torch.arange(bw, device=device)
        keep = (ii <= i_hi[:, None, None]) & (jj <= j_hi[:, None, None]) \
            & live[:, None, None]

        def e(q):
            return q[:, None, None]

        fi, fj = ii.to(torch.float64), jj.to(torch.float64)
        dd = e(torch.where(live, d, 1.0))
        wb = ((fi - e(ia)) * e(jc - ja) - (fj - e(ja)) * e(ic - ia)) / dd
        wc = ((fj - e(ja)) * e(ib - ia) - (fi - e(ia)) * e(jb - ja)) / dd
        wa = 1.0 - wb - wc
        keep &= (wa >= -tol) & (wb >= -tol) & (wc >= -tol)
        z_tri = wa * e(vz[a]) + wb * e(vz[b]) + wc * e(vz[c])
        out.scatter_reduce_(0, (ii * w + jj)[keep], z_tri[keep], "amax")
    return out.view(h, w).to(torch.float32)


def far_field(scene):
    """The coarse far field of the scene's TIN: a dict of ``ratio_log2``,
    ``z_coarse`` ((Hc, Wc) float32 on the scene's device) and
    ``coarse_offset`` (fine cell (0, 0) in the coarse lattice, in fine
    cells), as ``coarse_grid_from_tin`` builds them."""
    verts, tris = _tin(scene)
    rl = ratio_log2(scene, verts, len(tris))
    z_fine = scene["z"]
    dev = z_fine.device
    dx, dy = scene["dx"], scene["dy"]
    x0, y0 = float(scene["x"][0]), float(scene["y"][0])
    r = 2 ** rl
    hf, wf = z_fine.shape
    pad_c = int(math.ceil(scene["dist_search_m"] / (abs(dx) * r))) + 2
    n_i = (hf + r - 1) // r + 2 * pad_c
    n_j = (wf + r - 1) // r + 2 * pad_c
    oi = oj = pad_c * r
    corner = (x0 - oj * dx, y0 - oi * dy)
    sub = min(r, 4)
    while sub > 1 and (n_i * sub) * (n_j * sub) > 2 * 10 ** 8:
        sub //= 2
    z_s = rasterize(verts, tris, origin_xy=corner,
                    spacing_xy=(dx * r / sub, dy * r / sub),
                    shape=(n_i * sub, n_j * sub), device=dev)
    z_coarse = z_s.view(n_i, sub, n_j, sub).amax(dim=(1, 3)).contiguous()
    used = torch.as_tensor(verts[np.unique(tris)].astype(np.float64),
                           device=dev)
    ci_v = ((used[:, 1] - corner[1]) / (dy * r)).floor().long()
    cj_v = ((used[:, 0] - corner[0]) / (dx * r)).floor().long()
    ok = (ci_v >= 0) & (ci_v < n_i) & (cj_v >= 0) & (cj_v < n_j)
    z_coarse.view(-1).scatter_reduce_(
        0, (ci_v * n_j + cj_v)[ok], used[ok, 2].to(torch.float32), "amax")
    hp, wp = hf - hf % r, wf - wf % r
    pooled = z_fine[:hp, :wp].reshape(hp // r, r, wp // r, r).amax(
        dim=(1, 3))
    ci, cj = oi // r, oj // r
    sl = (slice(ci, ci + hp // r), slice(cj, cj + wp // r))
    z_coarse[sl] = torch.maximum(z_coarse[sl], pooled)
    return dict(ratio_log2=rl, z_coarse=z_coarse, coarse_offset=(oi, oj))


def combined_levels(z_fine, far, pads):
    """The padded pyramid levels of the fine grid and the far field, in
    the layout of ``sw.padded_levels`` for a grid of ``z_fine``'s shape:
    levels below the ratio max-mips of the fine grid, those from it on
    max-mips of the coarse grid (``combined_pyramid``)."""
    rl = far["ratio_log2"]
    z_coarse = far["z_coarse"].to(z_fine.dtype)
    r = 2 ** rl
    oi, oj = far["coarse_offset"]
    num_levels = len(pads)
    hf, wf = z_fine.shape
    hc, wc = z_coarse.shape
    fine = [z_fine]
    for _ in range(min(rl, num_levels) - 1):
        fine.append(sw._down2(fine[-1]))
    levels = [F.pad(lv, (p, p, p, p), value=sw.PAD_VALUE).contiguous()
              for lv, p in zip(fine, pads)]
    if num_levels <= rl:
        return levels
    nl = num_levels - rl
    align = 2 ** nl
    need = max(pads[lvl] * 2 ** (lvl - rl)
               for lvl in range(rl, num_levels)) + 2
    p0 = ((need + align - 1) // align) * align

    def build_axis(size_f, off_c, size_c):
        span = (size_f + r - 1) // r
        lo, hi = -p0, span + p0
        return lo, hi - lo, max(lo, -off_c), min(hi, size_c - off_c)

    ci, cj = oi // r, oj // r
    lo_i, n_i, qi0, qi1 = build_axis(hf, ci, hc)
    lo_j, n_j, qj0, qj1 = build_axis(wf, cj, wc)
    base = torch.full((n_i, n_j), sw.PAD_VALUE, dtype=z_fine.dtype,
                      device=z_fine.device)
    if qi1 > qi0 and qj1 > qj0:
        base[qi0 - lo_i:qi1 - lo_i, qj0 - lo_j:qj1 - lo_j] = \
            z_coarse[qi0 + ci:qi1 + ci, qj0 + cj:qj1 + cj]
    coarse = [base]
    for _ in range(nl - 1):
        coarse.append(sw._down2(coarse[-1]))
    h, w = hf, wf
    shapes = [(h, w)]
    for _ in range(num_levels - 1):
        h, w = (h + 1) // 2, (w + 1) // 2
        shapes.append((h, w))
    for lvl, a in zip(range(rl, num_levels), coarse):
        cut = (p0 >> (lvl - rl)) - pads[lvl]
        if cut >= 0:
            a = a[cut:, cut:]
        else:
            a = F.pad(a, (-cut, 0, -cut, 0), value=sw.PAD_VALUE)
        rows = shapes[lvl][0] + 2 * pads[lvl]
        cols = shapes[lvl][1] + 2 * pads[lvl]
        short = (max(0, cols - a.shape[1]), max(0, rows - a.shape[0]))
        if any(short):
            a = F.pad(a, (0, short[0], 0, short[1]), value=sw.PAD_VALUE)
        levels.append(a[:rows, :cols].contiguous())
    return levels


def horizon_reference(scene, cells, dtype=torch.float32, far=None):
    """At ``cells``: the horizon (N, A) [radian], sky view factor, slope
    and aspect (N,) [radian] of the scene with its far field.  ``far``:
    the scene's :func:`far_field`, when the caller has it already."""
    far = far_field(scene) if far is None else far
    plan = ref.horizon_plan(scene)
    z = scene["z"].to(dtype)
    levels = combined_levels(z, far, plan["pads"])
    z_inner = z[cells.rows, cells.cols]
    z_org = z_inner + float(np.float32(ref.HORIZON_RAY_LIFT))
    a_num = scene["azim_num"]
    trig = sw.trig_table(a_num)
    raw = sw.sweep_cells(cells, levels, plan, z_inner,
                         sw.horizon_mode(plan, z_org, trig))
    lo, hi = math.radians(scene["elev_ang_low_lim"]), \
        math.radians(ref.ELEV_ANG_UP_LIM)
    hori = raw.atan().clamp(lo, hi).t()
    # hzbench/reference.py::horizon_reference from here on
    tilt = ref.tilt_vectors(scene, cells, dtype)
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


def k1_bound(scene, n_blocks, seed, dir_chunk=30, far=None):
    """K1 on the scene's combined pyramid: (bound seconds, bound by,
    sampled share, counts), as :func:`hzbench.roofline.k1_bound` counts
    them: the frozen skip count on this module's own levels, the bytes of
    levels of the fine grid's shape."""
    far = far_field(scene) if far is None else far
    plan = ref.horizon_plan(scene)
    z = scene["z"]
    levels = combined_levels(z, far, plan["pads"])
    pool, pmin = sw.pooled(levels, plan["pads"][0])
    trig = sw.trig_table(scene["azim_num"])

    class Run:
        device = z.device
        n_dirs = scene["azim_num"]

        def __call__(self, cells, d0, d1):
            z_inner = z[cells.rows, cells.cols]
            z_org = z_inner + float(np.float32(ref.HORIZON_RAY_LIFT))
            mode = sw.horizon_mode(plan, z_org, trig[d0:d1])
            hook = sw.SkipCount(cells, plan, pool, pmin, z_org, mode[:2])
            sw.sweep_cells(cells, levels, plan, z_inner, mode, hook=hook)
            return hook.n

    counts, share = roofline._sampled_counts(
        plan, n_blocks, np.random.default_rng(seed), scene["inner_shape"],
        Run(), dir_chunk)
    n_cells = scene["inner_shape"][0] * scene["inner_shape"][1]
    ops, moved = roofline.work(plan, counts, n_cells, scene["azim_num"],
                               False, trig.nbytes)
    return roofline.bound_s(ops, moved) + (share, counts)
