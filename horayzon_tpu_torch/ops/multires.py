# Copyright (c) 2026
# MIT License
"""Multi-resolution terrain: full-resolution inner grid + coarse far field.

Counterpart of :mod:`horayzon_tpu.ops.multires`, the repo's answer to the
reference's simplified outer TIN (examples/horizon/gridded_planar_DEM_2m.py).
The far field is a coarse heightfield at ``2**ratio_log2`` times the fine
spacing, and the sweep's pyramid is assembled from both sources
(:func:`combined_pyramid`): levels below ``ratio_log2`` are max-mips of the
fine grid, read only by the dense and near-mip phases, which
:func:`validate_fine_halo` keeps inside the fine grid's halo; levels from
``ratio_log2`` on are max-mips of the coarse grid, which covers the whole
search distance.

The reference's XLA multires engine, ``horizon_sweep_multires``
(``horayzon_tpu/ops/multires.py:454-515``), is :func:`horizon_sweep_multires`
here: the plain torch XLA engine (:func:`horayzon_tpu_torch.ops.sweep.
horizon_core`) on the same combined pyramid, planar or general, as the
reference runs it in XLA.

Replaces on the TPU side: ``combined_pyramid``,
``horizon_sweep_multires_pallas`` and its custom VJP ``_mr_hz`` /
``_mr_fwd`` / ``_mr_bwd`` (``horayzon_tpu/ops/multires.py``), which run the
fused kernel ``pallas_sweep.py::_kernel`` and the replay ``_bwd_kernel`` on
a pyramid that is not the outer grid's own.  Here the same two kernels run,
K1 / K1-argmax (``csrc/horizon_sweep.cu``) and K3
(``csrc/horizon_replay_bwd.cu``), unchanged: they take a row stride and a
pad per level and never ask where a level came from.  K1's skips bound the
far field with the 8 x 8 pooled companions of these combined levels
(``fused_sweep.skip_inputs``), so a coarse-derived level bounds what the
sweep reads of it.

What bounds it on this card: the sweep, as in the single-grid run.  K1 is
bound by the instructions it executes per sample, not by where its loads come
from (the read floor, ``csrc/read_floor.cu``, runs the same reads no faster
from shared memory or aligned).  The fine grid of the 2 m example is 5120^2
(105 MB, more than the 50 MB L2), but the dense steps of a 1024^2 inner
block touch only the block plus its 230-cell reach of level 0, so the
kernel's working set stays L2-resident; the pyramid build and its VJP move
the whole fine grid through device memory once or twice and are bound by
bytes.  What the design does about it: every level is cropped to the
single-grid layout ``ceil(hf / 2^l) + 2 * pads[l]`` (the reference keeps a
coarse-derived level larger when its assembly overshoots), so the kernels,
``fused_sweep.check_pyramid`` and ``replay.padded_level_shapes`` stand as
they are and no level carries rows that no sample reads.  The gradient
needs no second Function: :func:`horizon_sweep_multires_fused` builds the
pyramid under autograd and hands it to ``fused_sweep.horizon_sweep_fused``,
whose Function returns the replay's per-level cotangents for the levels it
was given; autograd then carries them through the max-pools, the crops and
the coarse base embedding to **both** grids (an exact tie of a max halves
the cotangent, as ``jnp.maximum``'s VJP does).

:func:`rasterize_tin`, :func:`coarse_grid_from_tin` and
:func:`validate_fine_halo` are host NumPy, copied because importing
``horayzon_tpu.ops.multires`` loads JAX; ``tests/test_torch_schedule.py``
holds the copies equal to the originals.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from horayzon_tpu_torch.ops import fused_sweep as _fused
from horayzon_tpu_torch.ops import mip as _mip
from horayzon_tpu_torch.ops import sweep as _sweep
from horayzon_tpu_torch.utils.profiling import span


def combined_pyramid(z_fine, z_coarse, ratio_log2, coarse_offset, schedule):
    """Padded pyramid levels from a fine and a coarse heightfield, in the
    layout of :func:`horayzon_tpu_torch.ops.mip.padded_levels` for a grid of
    ``z_fine``'s shape: level ``l`` is ``ceil(hf / 2^l) + 2 * pads[l]`` rows
    (columns likewise) with ``pads[l]`` cells before fine cell 0.

    ``z_fine`` (Hf, Wf) and ``z_coarse`` (Hc, Wc) float32 tensors on one
    device; ``coarse_offset`` the position of fine cell (0, 0) within the
    coarse grid in *fine* cells, multiples of ``2**ratio_log2``;
    ``schedule`` an :class:`ops.sweep.Schedule`.  Differentiable by autograd
    w.r.t. both grids.  Equal, bit for bit, to the reference's
    ``combined_pyramid(..., pad_extra=LEVEL_PAD_EXTRA)`` cropped to this
    layout (:func:`horayzon_tpu_torch.ops.mip.combined_pyramid_from_jax`).
    """
    r = 2 ** ratio_log2
    oi, oj = coarse_offset
    if oi % r or oj % r:
        raise ValueError("coarse_offset must be multiples of the spacing "
                         "ratio (aligned grids)")
    pads = schedule.pads
    num_levels = len(pads)
    hf, wf = z_fine.shape
    hc, wc = z_coarse.shape
    n_fine = min(ratio_log2, num_levels)
    pyramid = [F.pad(lv, (p, p, p, p), value=_mip.PAD_VALUE).contiguous()
               for lv, p in zip(_mip.build_pyramid(z_fine, n_fine), pads)]
    if num_levels <= ratio_log2:
        return pyramid

    # Coarse-derived levels (l >= ratio_log2).  Fine-aligned level-r cell q
    # covers fine rows [q*r, (q+1)*r) and maps to coarse cell q + oi//r.
    # A level-r base over q in [-p0, span + p0) takes coarse data where
    # there is some, so shifts in every direction read real far-field
    # terrain; then it is mipped down.  p0 is a multiple of 2^nl, which
    # keeps every level's blocks aligned to fine cell 0.
    nl = num_levels - ratio_log2
    align = 2 ** nl
    need = max(pads[lvl] * 2 ** (lvl - ratio_log2)
               for lvl in range(ratio_log2, num_levels)) + 2
    p0 = ((need + align - 1) // align) * align

    def build_axis(size_f, off_c, size_c):
        span = (size_f + r - 1) // r
        lo, hi = -p0, span + p0
        # coarse index of fine-aligned cell q: q + off_c
        return lo, hi - lo, max(lo, -off_c), min(hi, size_c - off_c)

    ci, cj = oi // r, oj // r
    lo_i, n_i, qi0, qi1 = build_axis(hf, ci, hc)
    lo_j, n_j, qj0, qj1 = build_axis(wf, cj, wc)
    base = torch.full((n_i, n_j), _mip.PAD_VALUE, dtype=torch.float32,
                      device=z_fine.device)
    if qi1 > qi0 and qj1 > qj0:
        base[qi0 - lo_i:qi1 - lo_i, qj0 - lo_j:qj1 - lo_j] = \
            z_coarse[qi0 + ci:qi1 + ci, qj0 + cj:qj1 + cj]

    shapes = _mip.level_shapes((hf, wf), num_levels)
    for lvl, a in zip(range(ratio_log2, num_levels),
                      _mip.build_pyramid(base, nl)):
        # left offset of this level in its own cells: p0 / 2^k, exact
        cut = (p0 >> (lvl - ratio_log2)) - pads[lvl]
        if cut >= 0:
            a = a[cut:, cut:]
        else:
            a = F.pad(a, (-cut, 0, -cut, 0), value=_mip.PAD_VALUE)
        rows = shapes[lvl][0] + 2 * pads[lvl]
        cols = shapes[lvl][1] + 2 * pads[lvl]
        short = (max(0, cols - a.shape[1]), max(0, rows - a.shape[0]))
        if any(short):
            a = F.pad(a, (0, short[0], 0, short[1]), value=_mip.PAD_VALUE)
        pyramid.append(a[:rows, :cols].contiguous())
    return pyramid


def rasterize_tin(vert_simp, tri_ind_simp, *, origin_xy, spacing_xy, shape,
                  fill=_mip.PAD_VALUE):
    """Sample a TIN onto a regular lattice by barycentric interpolation
    (copy of ``horayzon_tpu.ops.multires.rasterize_tin``).

    ``vert_simp``: flat float32 array of interleaved (x, y, z) vertices;
    ``tri_ind_simp``: flat int32 vertex indices, 3 per triangle;
    ``origin_xy``: (x0, y0) of lattice point (0, 0); ``spacing_xy``:
    (sx, sy), sy signed like ``dy``; ``shape``: (H, W).  Returns (H, W)
    float32: the TIN height at each lattice point, the maximum where
    triangles overlap, ``fill`` outside all triangles."""
    verts = np.asarray(vert_simp, dtype=np.float64).reshape(-1, 3)
    tris = np.asarray(tri_ind_simp, dtype=np.int64).reshape(-1, 3)
    x0, y0 = origin_xy
    sx, sy = spacing_xy
    h, w = shape
    out = np.full((h, w), fill, dtype=np.float64)

    # Vertex positions in (row, col) lattice coordinates
    vi = (verts[:, 1] - y0) / sy
    vj = (verts[:, 0] - x0) / sx
    vz = verts[:, 2]
    eps = 1.0e-9
    for a, b, c in tris:
        i_lo = max(int(np.ceil(min(vi[a], vi[b], vi[c]) - eps)), 0)
        i_hi = min(int(np.floor(max(vi[a], vi[b], vi[c]) + eps)), h - 1)
        j_lo = max(int(np.ceil(min(vj[a], vj[b], vj[c]) - eps)), 0)
        j_hi = min(int(np.floor(max(vj[a], vj[b], vj[c]) + eps)), w - 1)
        if i_hi < i_lo or j_hi < j_lo:
            continue
        ii, jj = np.meshgrid(np.arange(i_lo, i_hi + 1),
                             np.arange(j_lo, j_hi + 1), indexing="ij")
        # Barycentric coordinates of the lattice points
        d = ((vi[b] - vi[a]) * (vj[c] - vj[a])
             - (vj[b] - vj[a]) * (vi[c] - vi[a]))
        if abs(d) < 1.0e-12:
            continue
        wb = ((ii - vi[a]) * (vj[c] - vj[a])
              - (jj - vj[a]) * (vi[c] - vi[a])) / d
        wc = ((jj - vj[a]) * (vi[b] - vi[a])
              - (ii - vi[a]) * (vj[b] - vj[a])) / d
        wa = 1.0 - wb - wc
        tol = 1.0e-6
        inside = (wa >= -tol) & (wb >= -tol) & (wc >= -tol)
        if not inside.any():
            continue
        z_tri = wa * vz[a] + wb * vz[b] + wc * vz[c]
        block = out[i_lo:i_hi + 1, j_lo:j_hi + 1]
        np.maximum(block, np.where(inside, z_tri, fill), out=block)
    return out.astype(np.float32)


def coarse_grid_from_tin(vert_simp, tri_ind_simp, *, grid, fine_shape,
                         z_fine, ratio_log2, dist_search):
    """The coarse far field from a simplified outer TIN (copy of
    ``horayzon_tpu.ops.multires.coarse_grid_from_tin``).

    The coarse lattice is aligned to the fine grid (spacing ``2**r`` fine
    cells), extends ``dist_search`` beyond it and is filled from the TIN:
    rasterised at up to 4 x the coarse resolution and max-pooled, with the
    TIN's own vertices scattered into their cells (block maxima from
    below); over the fine grid's extent the max-pooled fine terrain wins.
    Returns ``(z_coarse, coarse_offset)`` as NumPy for
    :func:`horizon_sweep_multires_fused`."""
    r = 2 ** ratio_log2
    hf, wf = fine_shape
    # pad the lattice by the search distance, in whole coarse cells
    pad_c = int(math.ceil(dist_search / (abs(grid.dx) * r))) + 2
    n_i = (hf + r - 1) // r + 2 * pad_c
    n_j = (wf + r - 1) // r + 2 * pad_c
    oi = oj = pad_c * r                     # fine cell 0 at coarse pad_c
    corner = (grid.x0 - oj * grid.dx, grid.y0 - oi * grid.dy)
    sub = min(r, 4)
    while sub > 1 and (n_i * sub) * (n_j * sub) > 2 * 10 ** 8:
        sub //= 2                            # cap host raster memory
    z_s = rasterize_tin(vert_simp, tri_ind_simp, origin_xy=corner,
                        spacing_xy=(grid.dx * r / sub, grid.dy * r / sub),
                        shape=(n_i * sub, n_j * sub))
    z_coarse = z_s.reshape(n_i, sub, n_j, sub).max(axis=(1, 3))
    verts3 = np.asarray(vert_simp, dtype=np.float64).reshape(-1, 3)
    tris3 = np.asarray(tri_ind_simp, dtype=np.int64).reshape(-1)
    used = verts3[np.unique(tris3)]
    ci_v = np.floor((used[:, 1] - corner[1]) / (grid.dy * r)).astype(int)
    cj_v = np.floor((used[:, 0] - corner[0]) / (grid.dx * r)).astype(int)
    ok = (ci_v >= 0) & (ci_v < n_i) & (cj_v >= 0) & (cj_v < n_j)
    np.maximum.at(z_coarse, (ci_v[ok], cj_v[ok]),
                  used[ok, 2].astype(np.float32))
    # overlay the fine grid's own max-pooled blocks (exact where known)
    hp = hf - hf % r
    wp = wf - wf % r
    pooled = np.asarray(z_fine)[:hp, :wp] \
        .reshape(hp // r, r, wp // r, r).max(axis=(1, 3))
    ci, cj = oi // r, oj // r
    z_coarse[ci:ci + hp // r, cj:cj + wp // r] = np.maximum(
        z_coarse[ci:ci + hp // r, cj:cj + wp // r], pooled)
    return z_coarse, (oi, oj)


def validate_fine_halo(schedule, ratio_log2, step, offset, inner_shape,
                       fine_shape):
    """Raise if phases reading fine-derived levels can leave the fine
    grid's halo: they would sample sentinel padding instead of terrain
    (copy of ``horayzon_tpu.ops.multires._validate_fine_halo``).  Returns
    the halo [cells]."""
    in0, in1 = inner_shape
    off0, off1 = offset
    hf, wf = fine_shape
    halo = min(off0, off1, hf - off0 - in0, wf - off1 - in1)
    s_fine_max = 0.0
    for ph, s_vals in zip(schedule.phases, schedule.s_values):
        if ph.level < ratio_log2:
            s_fine_max = max(s_fine_max, float(s_vals[-1]))
    halo_needed = int(math.ceil(s_fine_max / step)) + 2
    if halo < halo_needed:
        raise ValueError(
            f"fine-grid halo ({halo} cells) too small for the schedule: "
            f"phases below level {ratio_log2} march to {s_fine_max:.0f} m "
            f"(= {halo_needed} cells).  Widen the fine halo or use a "
            f"smaller spacing ratio.")
    return halo


def multires_levels(z_fine, z_coarse, *, ratio_log2, coarse_offset, dx, dy,
                    offset, inner_shape, dist_search, hori_acc=0.25,
                    rel_err=None, max_level=10):
    """The combined pyramid of one multires sweep: the sweep's schedule
    from its geometry (as ``fused_sweep.plan_sweep`` builds it), the
    fine-halo check, then :func:`combined_pyramid`."""
    _fused.check_block(z_fine, offset, inner_shape)
    plan = _fused.plan_sweep(tuple(z_fine.shape), inner_shape=inner_shape,
                             offset=offset, dist_search=dist_search, dx=dx,
                             dy=dy, hori_acc=hori_acc, rel_err=rel_err,
                             max_level=max_level)
    schedule = _sweep.build_schedule(plan["step"], plan["dist"],
                                     plan["rel_err"],
                                     max_level=plan["max_level"])
    validate_fine_halo(schedule, ratio_log2, plan["step"], offset,
                       inner_shape, tuple(z_fine.shape))
    return combined_pyramid(z_fine, z_coarse, int(ratio_log2),
                            (int(coarse_offset[0]), int(coarse_offset[1])),
                            schedule)


def horizon_sweep_multires_fused(z_fine, z_coarse, *, ratio_log2,
                                 coarse_offset, dx, dy, offset, inner_shape,
                                 azim_num, dist_search, hori_acc=0.25,
                                 elev_ang_low_lim=-15.0,
                                 elev_ang_up_lim=89.98, ray_org_elev=0.01,
                                 rel_err=None, max_level=10, mask=None):
    """Gridded horizon with a coarse far field on the fused sweep.

    Same contract as ``horayzon_tpu.ops.multires.
    horizon_sweep_multires_pallas`` (without its tiling arguments): the
    sweep of :func:`horayzon_tpu_torch.ops.fused_sweep.horizon_sweep_fused`
    over ``z_fine`` (inner block + halo at full resolution), with the
    pyramid levels at and above ``ratio_log2`` taken from ``z_coarse``, so
    the full-resolution outer grid never has to exist.  ``mask``: optional
    (in0, in1) uint8 or bool, nonzero where a cell is swept; a mask with no
    such cell gives the lower limit everywhere.

    ``z_fine`` decides the device: a CUDA tensor runs K1 (and, when
    ``z_fine`` or ``z_coarse`` requires grad, K1-argmax and K3), a CPU
    tensor their plain versions.  Differentiable w.r.t. ``z_fine`` AND
    ``z_coarse``.  Planar.  Returns (in0, in1, azim_num) float32 [radian].
    """
    z_fine = torch.as_tensor(z_fine).to(torch.float32)
    z_coarse = torch.as_tensor(z_coarse).to(device=z_fine.device,
                                            dtype=torch.float32)
    geo = dict(dx=dx, dy=dy, offset=offset, inner_shape=inner_shape,
               dist_search=dist_search, hori_acc=hori_acc, rel_err=rel_err,
               max_level=max_level)
    with span("hzt.tin.pyramid"):
        levels = multires_levels(z_fine, z_coarse, ratio_log2=ratio_log2,
                                 coarse_offset=coarse_offset, **geo)
    return _fused.horizon_sweep_fused(
        z_fine, azim_num=azim_num, elev_ang_low_lim=elev_ang_low_lim,
        elev_ang_up_lim=elev_ang_up_lim, ray_org_elev=ray_org_elev,
        pyramid=levels, mask=mask, **geo)


def horizon_sweep_multires(z_fine, z_coarse, *, ratio_log2, coarse_offset,
                           dx, dy, offset, inner_shape, azim, dist_search,
                           hori_acc=0.25, elev_ang_low_lim=-15.0,
                           elev_ang_up_lim=89.98, ray_org_elev=0.01,
                           geom=None, u_xy=None, rel_err=None,
                           max_level=10):
    """Gridded horizon with a coarse far field on the XLA engine
    (``horayzon_tpu.ops.multires.horizon_sweep_multires``).

    The contract of :func:`horayzon_tpu_torch.ops.sweep.horizon_sweep`
    with the outer heightfield split into ``z_fine`` (inner block + halo
    at full resolution) and ``z_coarse`` (the far field at ``2**ratio_log2``
    times the spacing, fine cell (0, 0) at ``coarse_offset`` fine cells).
    The schedule is the unsplit one (every dense phase carries in-domain
    masks against the fine grid, as the reference's); the fine halo must
    cover every phase below ``ratio_log2`` (:func:`validate_fine_halo`).
    ``z_fine`` decides the device.  Returns (in0, in1, A) float32
    [radian]."""
    z_fine = torch.as_tensor(z_fine).to(torch.float32)
    z_coarse = torch.as_tensor(z_coarse).to(device=z_fine.device,
                                            dtype=torch.float32)
    step = min(abs(dx), abs(dy))
    if rel_err is None:
        rel_err = _sweep.default_rel_err(hori_acc)
    schedule = _sweep.build_schedule(step, dist_search, rel_err,
                                     max_level=max_level)
    (in0, in1), (off0, off1) = inner_shape, offset
    hf, wf = z_fine.shape
    validate_fine_halo(schedule, ratio_log2, step, offset, inner_shape,
                       (hf, wf))
    pyramid = combined_pyramid(z_fine, z_coarse, int(ratio_log2),
                               (int(coarse_offset[0]),
                                int(coarse_offset[1])), schedule)
    azim = np.asarray(azim, dtype=np.float64)
    tables = _sweep.horizon_shift_tables(schedule, azim, dx, dy, offset,
                                         u_xy=u_xy)
    z_inner = z_fine[off0:off0 + in0, off1:off1 + in1]
    planar = geom is None
    geom_t = None if planar else _sweep.geom_fields(geom, z_fine.device)
    if planar:
        z_org = z_inner + _sweep._f(ray_org_elev)
    else:
        z_org = z_inner + _sweep._f(ray_org_elev) * geom_t["mz"]
    hori, _ = _sweep.horizon_core(
        pyramid, z_org, z_inner, geom_t, tables,
        _sweep.sweep_trig(azim, u_xy), sched_meta=schedule.meta(),
        pads=schedule.pads, inner_shape=tuple(inner_shape), planar=planar,
        track_dist=False, outer_shape=(hf, wf))
    return _sweep.tie_clip(hori, math.radians(elev_ang_low_lim),
                           math.radians(elev_ang_up_lim))
