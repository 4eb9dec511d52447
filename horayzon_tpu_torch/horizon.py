# Copyright (c) 2026
# MIT License
"""Public horizon API: the counterpart of :mod:`horayzon_tpu.horizon`.

``horizon_gridded`` keeps the reference's signature (plus ``device``) and
its validation; it unpacks the vertex buffer and hands the planes to
:func:`gridded_planes`, which both pipelines call directly and which makes
the routing decision.  With default vectors the fused sweep
(:func:`horayzon_tpu_torch.ops.fused_sweep.horizon_sweep_fused`) runs
three branches: a regular planar grid, masked or not; the same with a
simplified outer TIN (``vert_simp``), which :func:`_tin_gridded`
rasterises to a coarse far field (on a CUDA device with the kernel R1,
:mod:`horayzon_tpu_torch.ops.tin_raster`) and sweeps over a combined
fine + coarse pyramid (:mod:`horayzon_tpu_torch.ops.multires`); and a
curved (irregular) grid, which :func:`_curved_gridded` planarises, sweeps
with the tilt ramp and reads back.  One thread owns one (cell, azimuth) in
the kernel, so the inner domain (or the curved run's lattice box) is swept
as it is, with no padding to tile multiples, and a mask needs no tile
chooser: the kernel skips the 32 x 8 blocks that hold no unmasked cell.

``engine="sweep"`` and non-default ``vec_norm`` / ``vec_north`` take the
reference's XLA engine (:func:`horayzon_tpu_torch.ops.sweep.
horizon_sweep`, plain torch on ``device``), as the reference does off a
TPU: non-default vectors always go to its general per-cell basis
(``engine="pallas"`` refuses them), a masked regular grid is swept over
the bounding box of its unmasked cells, a curved grid over its lattice box
with the general basis, and a TIN with the XLA multires engine.
``horizon_locations`` runs the per-location sweep
(:mod:`horayzon_tpu_torch.ops.locations`, plain torch, as the reference
runs it in XLA), on a curved mesh over its planarised lattice.
"""

import math
import time

import numpy as np
import torch

from horayzon_tpu_torch import regrid as _regrid
from horayzon_tpu_torch import terrain as _terrain
from horayzon_tpu_torch.ops import fused_sweep as _fused
from horayzon_tpu_torch.ops import locations as _locations
from horayzon_tpu_torch.ops import multires as _multires
from horayzon_tpu_torch.ops import planarize as _planarize
from horayzon_tpu_torch.ops import sweep as _sweep
from horayzon_tpu_torch.ops import tin_raster as _tin_raster
from horayzon_tpu_torch.utils import profiling as _profiling
from horayzon_tpu_torch.utils.profiling import span

_VALID_ALGOS = ("discrete_sampling", "binary_search", "guess_constant",
                "sweep")
_VALID_GEOM = ("triangle", "quad", "grid")


def azimuth_angles(azim_num):
    """Azimuth angles [radian], clockwise from North (horizon.pyx:190-196)."""
    return ((2.0 * np.pi) / azim_num * np.arange(azim_num)).astype(np.float32)


def _mask_bbox(mask):
    """Bounding box (r0, r1, c0, c1) of unmasked (== 1) cells; the whole
    domain if every cell is unmasked, a 1x1 box if none is (callers fill
    masked cells afterwards, so the value computed there is discarded)."""
    rows = np.flatnonzero(np.asarray(mask).any(axis=1))
    cols = np.flatnonzero(np.asarray(mask).any(axis=0))
    if rows.size == 0:
        return 0, 1, 0, 1
    return rows[0], rows[-1] + 1, cols[0], cols[-1] + 1


def horizon_gridded(
        vert_grid, dem_dim_0, dem_dim_1,
        vec_norm, vec_north,
        offset_0, offset_1,
        dist_search,
        azim_num=360,
        hori_acc=0.25,
        ray_algorithm="guess_constant",
        geom_type="grid",
        vert_simp=None, num_vert_simp=1,
        tri_ind_simp=None, num_tri_simp=1,
        elev_ang_low_lim=-15.0,
        mask=None,
        hori_fill=0.0,
        ray_org_elev=0.01,
        verbose=True,
        engine="auto",
        *, device="cuda"):
    """Horizon computation for a gridded domain.

    Signature and validation mirror ``horayzon_tpu.horizon.horizon_gridded``
    (``dist_search`` in kilometres).  ``device``: where the sweep runs, the
    card unless the caller asks for the CPU; a CUDA device runs kernel K1,
    the CPU the plain torch sweep.  ``engine``: "auto" and "pallas" select
    the fused sweep for default vectors; "sweep" the reference's XLA
    engine, plain torch on ``device``, which non-default vectors take
    whatever the engine ("pallas" refuses them with ``ValueError``).
    ``hori_fill`` applies to masked cells (mask values other than 1).

    Returns
    -------
    hori : tensor of float32, shape (in0, in1, azim_num) [radian], on
        ``device``
    azim : tensor of float32, shape (azim_num,) [radian], on ``device``
    """
    with span("hzt.horizon.check"):
        if engine not in ("auto", "sweep", "pallas"):
            raise ValueError("engine must be 'auto', 'sweep' or 'pallas'")
        # --- Validation (mirrors horizon.pyx:109-156) ---------------------
        vec_norm = np.asarray(vec_norm, dtype=np.float32)
        vec_north = np.asarray(vec_north, dtype=np.float32)
        if ((vec_norm.ndim != 3) or (vec_north.ndim != 3)
                or (vec_norm.shape != vec_north.shape)):
            raise ValueError("dimension (lengths) of vec_norm and/or "
                             "vec_north is/are erroneous")
        if ray_algorithm not in _VALID_ALGOS:
            raise ValueError("invalid input argument for ray_algorithm")
        if geom_type not in _VALID_GEOM:
            raise ValueError("invalid input argument for geom_type")
        x, y, z = _terrain.decompose_vert_grid(vert_grid, dem_dim_0,
                                               dem_dim_1)
    return gridded_planes(
        x, y, z, vec_norm, vec_north, (offset_0, offset_1),
        vec_norm.shape[:2], dist_search, azim_num=azim_num,
        hori_acc=hori_acc, elev_ang_low_lim=elev_ang_low_lim, mask=mask,
        hori_fill=hori_fill, ray_org_elev=ray_org_elev, verbose=verbose,
        engine=engine, vert_simp=vert_simp, num_vert_simp=num_vert_simp,
        tri_ind_simp=tri_ind_simp, num_tri_simp=num_tri_simp, device=device)


def gridded_planes(x, y, z, vec_norm, vec_north, offset, inner_shape,
                   dist_search, *, azim_num, hori_acc, elev_ang_low_lim,
                   mask=None, hori_fill=0.0, ray_org_elev=0.01, verbose=True,
                   engine="auto", vert_simp=None, num_vert_simp=1,
                   tri_ind_simp=None, num_tri_simp=1, grid=None,
                   device="cuda"):
    """:func:`horizon_gridded` on the outer (H, W) float32 planes ``x``,
    ``y``, ``z``, the inner block at ``offset`` of ``inner_shape``: its
    checks, messages and routes, below it and both pipelines.
    ``vec_norm`` and ``vec_north`` both None: the default planar vectors,
    built only where the curved route needs arrays.  ``grid``: the planes'
    :class:`~horayzon_tpu_torch.terrain.GridSpec` when the caller knows
    them regular (``x`` and ``y`` may be None), else
    ``terrain.detect_regular_grid`` tests them.  Counts the route taken
    (:data:`~horayzon_tpu_torch.utils.profiling.ROUTES`)."""
    with span("hzt.horizon.check"):
        if x is not None and not x.shape == y.shape == z.shape:
            # the refusal of auxiliary.rearrange_pad_buffer
            raise ValueError("Dimensions of input arguments are "
                             "erroneous/inconsistent")
        mask, masked = _check_planar(
            z.shape, offset, inner_shape, hori_acc=hori_acc, mask=mask,
            ray_org_elev=ray_org_elev)
        if grid is None:
            grid = _terrain.detect_regular_grid(x, y)
        if (vert_simp is None) != (tri_ind_simp is None):
            raise ValueError("vert_simp and tri_ind_simp must be provided "
                             "together")
        if vert_simp is not None and grid is None:
            raise ValueError("the simplified outer TIN (vert_simp) is only "
                             "supported on planar regular grids (reference "
                             "usage: gridded_planar_DEM_2m)")
        general = (grid is not None and vert_simp is None
                   and vec_norm is not None
                   and not _terrain.is_default_planar_vectors(vec_norm,
                                                              vec_north))
        if general and engine == "pallas":
            raise ValueError("engine='pallas' requires a planar regular grid "
                             "(default vec_norm and vec_north)")

    sweep_kw = dict(azim_num=azim_num, dist_search=dist_search * 1000.0,
                    hori_acc=hori_acc, elev_ang_low_lim=elev_ang_low_lim,
                    ray_org_elev=ray_org_elev)
    fin_kw = dict(mask=mask, masked=masked, hori_fill=hori_fill,
                  verbose=verbose, device=device)
    t0 = time.perf_counter()
    if vert_simp is not None:
        _profiling.count_route("tin")
        hori = _tin_gridded(z, grid, vert_simp, num_vert_simp, tri_ind_simp,
                            num_tri_simp, offset=offset,
                            inner_shape=inner_shape,
                            mask=mask if masked else None, device=device,
                            engine=engine, **sweep_kw)
    elif grid is None:
        _profiling.count_route("curved_tilt")
        if vec_norm is None:
            vec_norm, vec_north = (np.broadcast_to(
                np.float32(v), tuple(inner_shape) + (3,)).copy()
                for v in ((0, 0, 1), (0, 1, 0)))
        hori = _curved_gridded(x, y, z, vec_norm, vec_north, *offset,
                               mask=mask if masked else None,
                               device=device, engine=engine, **sweep_kw)
    elif general or engine == "sweep":
        _profiling.count_route("xla")
        hori = _xla_gridded(z, grid, vec_norm, vec_north, general,
                            offset=offset, inner_shape=inner_shape, mask=mask,
                            hori_fill=hori_fill, device=device, **sweep_kw)
    else:
        _profiling.count_route("planar")
        return _fused_planar(z, grid, offset=offset, inner_shape=inner_shape,
                             **fin_kw, **sweep_kw)
    return _finish(hori, t0, azim_num=azim_num, **fin_kw)


def _check_planar(dem_shape, offset, inner_shape, *, hori_acc, mask,
                  ray_org_elev):
    """The checks of :func:`gridded_planes` that do not need the planes
    (horizon.pyx:109-156), with the reference's messages and exception
    types: the inner block inside the DEM and not empty, ``hori_acc``,
    the mask, ``ray_org_elev``.  Returns ``(mask, masked)``: the uint8
    mask (all ones for None) and whether it masks any cell."""
    if ((offset[0] + inner_shape[0] > dem_shape[0])
            or (offset[1] + inner_shape[1] > dem_shape[1])):
        raise ValueError("inconsistency between input arguments "
                         "dem_dim_0, dem_dim_1, offset_0, offset_1 and "
                         "vec_norm")
    if min(inner_shape) <= 0:
        raise ValueError(
            "inner domain is empty (vec_norm has zero size) — the outer "
            "DEM is not larger than twice the search distance; widen the "
            "domain or reduce dist_search")
    if hori_acc > 10.0:
        raise ValueError("limit of hori_acc (10 degree) is exceeded")
    if mask is None:
        mask = np.ones(inner_shape, dtype=np.uint8)
    mask = np.asarray(mask)
    if mask.shape != tuple(inner_shape):
        raise ValueError("shape of mask is inconsistent with other input")
    if mask.dtype != np.uint8:
        raise TypeError("data type of mask must be 'uint8'")
    if ray_org_elev < 0.005:
        raise TypeError("minimal allowed value for 'ray_org_elev' is "
                        "0.005 m")
    return mask, bool(mask.min() == 0)


def _fused_planar(z, grid, *, offset, inner_shape, mask, masked, hori_fill,
                  verbose, device, **sweep_kw):
    """The fused sweep of a regular planar grid with default vectors, on
    arguments :func:`_check_planar` passed: ``z`` the (H, W) float32 outer
    heights to the device (as they are when C-contiguous and writable),
    K1 (or the plain sweep on the CPU), then :func:`_finish`.  ``sweep_kw``:
    :func:`~horayzon_tpu_torch.ops.fused_sweep.horizon_sweep_fused`'s
    settings.  Returns ``(hori, azim)``."""
    t0 = time.perf_counter()
    with span("hzt.horizon.upload"):
        z_dev = torch.from_numpy(np.require(z, np.float32, ("C", "W"))).to(
            device)
        mask_dev = torch.from_numpy(mask).to(device) if masked else None
    hori = _fused.horizon_sweep_fused(
        z_dev, dx=grid.dx, dy=grid.dy, offset=offset,
        inner_shape=inner_shape, mask=mask_dev, **sweep_kw)
    return _finish(hori, t0, mask=mask, masked=masked, hori_fill=hori_fill,
                   verbose=verbose, device=device,
                   azim_num=sweep_kw["azim_num"])


def _finish(hori, t0, *, mask, masked, hori_fill, verbose, device,
            azim_num):
    """``hori_fill`` into the masked cells and the ``verbose`` report (its
    time since ``t0``); returns ``(hori, azim)``."""
    if masked:
        with span("hzt.horizon.fill"):
            # the fill on the device (horayzon_tpu/horizon.py:568-570)
            keep = torch.from_numpy(mask == 1).to(hori.device)
            hori.masked_fill_(~keep[..., None], float(np.float32(hori_fill)))
    if verbose:
        with span("hzt.horizon.report"):
            if hori.is_cuda:
                torch.cuda.synchronize(hori.device)
            dt = time.perf_counter() - t0
            print(f"Horizon sweep: {mask.shape[0]}x{mask.shape[1]} cells, "
                  f"{azim_num} azimuths, {dt:.3f} s "
                  f"(incl. kernel build on first call)")
            # considered-fraction printout mirrors horizon_comp.cpp:685-695
            n_cells = int((mask == 1).sum())
            print(f"Number of grid cells for which horizon is computed: "
                  f"{n_cells} ({100.0 * n_cells / mask.size:.2f} % of the "
                  f"domain)")
    return hori, torch.from_numpy(azimuth_angles(azim_num)).to(device)


def _xla_gridded(z, grid, vec_norm, vec_north, general, *, offset,
                 inner_shape, mask, hori_fill, azim_num, dist_search,
                 hori_acc, elev_ang_low_lim, ray_org_elev, device="cuda"):
    """A regular grid on the XLA engine (``horayzon_tpu/horizon.py:
    544-567``): the sweep cropped to the bounding box of the unmasked
    cells, ``hori_fill`` outside it; with ``general`` the per-cell basis of
    ``vec_norm`` / ``vec_north`` and its domain-mean marching directions.
    Returns (in0, in1, azim_num) float32 on ``device``."""
    azim = azimuth_angles(azim_num)
    geom = u_xy = None
    if general:
        geom = _terrain.basis_fields(vec_norm, vec_north)
        u_xy = _terrain.mean_marching_directions(azim, vec_norm, vec_north)
    r0, r1, c0, c1 = (int(v) for v in _mask_bbox(mask))
    full = (r0, r1, c0, c1) == (0, inner_shape[0], 0, inner_shape[1])
    if geom is not None and not full:
        geom = {k: v[r0:r1, c0:c1] for k, v in geom.items()}
    hori_c, _ = _sweep.horizon_sweep(
        torch.from_numpy(np.ascontiguousarray(z)).to(device), dx=grid.dx,
        dy=grid.dy, offset=(offset[0] + r0, offset[1] + c0),
        inner_shape=(r1 - r0, c1 - c0), azim=azim, dist_search=dist_search,
        hori_acc=hori_acc, elev_ang_low_lim=elev_ang_low_lim,
        ray_org_elev=ray_org_elev, geom=geom, u_xy=u_xy)
    if full:
        return hori_c
    hori = torch.full(tuple(inner_shape) + (azim_num,),
                      float(np.float32(hori_fill)), dtype=torch.float32,
                      device=hori_c.device)
    hori[r0:r1, c0:c1] = hori_c
    return hori


def tin_ratio_log2(grid, fine_shape, vert_simp, num_vert_simp, tri_ind_simp,
                   num_tri_simp, *, offset, inner_shape, dist_search,
                   hori_acc):
    """log2 of the coarse / fine spacing ratio of a TIN run
    (``horayzon_tpu/horizon.py:608-645``): from the TIN's mean triangle
    footprint (two triangles per quad of coarse cells), clipped to 1..8,
    then reduced until the fine grid's halo covers every phase that reads
    a fine-derived level; raises the halo ``ValueError`` if even ratio 1
    does not fit.  ``dist_search`` in metres.

    The halo is that of the inner block as it is, as the reference checks
    it off a TPU.  On a TPU the reference's kernel route validates against
    the block padded to tile multiples (``horizon.py:621-649``), which can
    shrink the halo and with it the ratio: its ratio depends on the
    device, and the port's is the one it picks off a TPU."""
    tris = np.asarray(tri_ind_simp, dtype=np.int32).reshape(-1)
    n_tri = int(min(num_tri_simp, len(tris) // 3))
    vxy = np.asarray(vert_simp, dtype=np.float32).reshape(-1, 3)[
        :max(1, int(num_vert_simp))]
    bbox_cells = (max(np.ptp(vxy[:, 0]) / abs(grid.dx), 1.0)
                  * max(np.ptp(vxy[:, 1]) / abs(grid.dy), 1.0))
    cells_per_tri = max(bbox_cells / max(n_tri, 1), 2.0)
    ratio_log2 = int(np.clip(round(math.log2(math.sqrt(cells_per_tri
                                                       / 2.0))), 1, 8))
    step = min(abs(grid.dx), abs(grid.dy))
    schedule = _sweep.build_schedule(step, dist_search,
                                     _sweep.default_rel_err(hori_acc))
    while True:
        try:
            _multires.validate_fine_halo(schedule, ratio_log2, step, offset,
                                         inner_shape, fine_shape)
            return ratio_log2
        except ValueError:
            if ratio_log2 == 1:
                raise
            ratio_log2 -= 1


def _tin_gridded(z, grid, vert_simp, num_vert_simp, tri_ind_simp,
                 num_tri_simp, *, offset, inner_shape, azim_num, dist_search,
                 hori_acc, elev_ang_low_lim, ray_org_elev, mask=None,
                 device="cuda", engine="auto"):
    """Gridded horizon with a simplified outer TIN as the far field
    (``horayzon_tpu/horizon.py:585-681``): the TIN is rasterised onto a
    coarse lattice aligned with the fine grid at the ratio of
    :func:`tin_ratio_log2`, and the sweep runs on ``device`` over the
    combined fine + coarse pyramid: the fused sweep (the pyramid under
    ``hzt.tin.pyramid``), or with ``engine="sweep"`` the XLA multires
    engine (:func:`~horayzon_tpu_torch.ops.multires.
    horizon_sweep_multires`), which takes no mask.  The far field is
    built where the sweep runs: on a CUDA device the fine grid goes up
    (``hzt.tin.upload``) and the kernel R1 builds the coarse grid there
    (:func:`~horayzon_tpu_torch.ops.tin_raster.coarse_grid`, span
    ``hzt.tin.raster``); on the CPU the host copy
    (:func:`~horayzon_tpu_torch.ops.multires.coarse_grid_from_tin`, span
    ``hzt.tin.raster``), then both grids go to ``device``
    (``hzt.tin.upload``).  The two are bit-equal.  Counts the triangles
    (:func:`~horayzon_tpu_torch.utils.profiling.count_tin`).  Masked cells
    read values that the caller overwrites with its fill.  Returns (in0,
    in1, azim_num) float32 on ``device``."""
    on_card = torch.device(device).type == "cuda"
    if on_card:
        with span("hzt.tin.upload"):
            z_f = torch.from_numpy(np.ascontiguousarray(z)).to(device)
    with span("hzt.tin.raster"):
        tris = np.asarray(tri_ind_simp, dtype=np.int32).reshape(-1)
        tris = tris[:3 * int(min(num_tri_simp, len(tris) // 3))]
        verts = np.asarray(vert_simp, dtype=np.float32)
        ratio_log2 = tin_ratio_log2(
            grid, z.shape, verts, num_vert_simp, tris, num_tri_simp,
            offset=offset, inner_shape=inner_shape, dist_search=dist_search,
            hori_acc=hori_acc)
        if on_card:
            z_c, coarse_offset = _tin_raster.coarse_grid(
                verts, tris, grid=grid, fine_shape=z.shape, z_fine=z_f,
                ratio_log2=ratio_log2, dist_search=dist_search)
        else:
            z_coarse, coarse_offset = _multires.coarse_grid_from_tin(
                verts, tris, grid=grid, fine_shape=z.shape, z_fine=z,
                ratio_log2=ratio_log2, dist_search=dist_search)
        _profiling.count_tin(len(tris) // 3)
    if not on_card:
        with span("hzt.tin.upload"):
            z_f = torch.from_numpy(np.ascontiguousarray(z)).to(device)
            z_c = torch.from_numpy(z_coarse).to(device)
    kw = dict(ratio_log2=ratio_log2, coarse_offset=coarse_offset,
              dx=grid.dx, dy=grid.dy, offset=offset, inner_shape=inner_shape,
              dist_search=dist_search, hori_acc=hori_acc,
              elev_ang_low_lim=elev_ang_low_lim, ray_org_elev=ray_org_elev)
    if engine == "sweep":
        return _multires.horizon_sweep_multires(
            z_f, z_c, azim=azimuth_angles(azim_num), **kw)
    return _multires.horizon_sweep_multires_fused(
        z_f, z_c, azim_num=azim_num,
        mask=None if mask is None else torch.from_numpy(mask).to(device),
        **kw)


def _sqrt(t):
    """The correctly rounded square root of ``t``, as NumPy's and the
    card's: torch's own float64 one on the CPU is an ulp off for some
    values."""
    if t.device.type == "cpu":
        return torch.from_numpy(np.sqrt(t.numpy()))
    return torch.sqrt(t)


def curved_lattice(x, y, z, vec_norm, offset_0, offset_1, mask=None,
                   pg=None, *, device="cuda"):
    """Preparation of a curved run (``horayzon_tpu/horizon.py:684-815``):
    planarise the ENU mesh on ``device``
    (:func:`horayzon_tpu_torch.ops.planarize.planarize`: one kernel launch
    on a CUDA device, ``regrid.planarize`` on the CPU), box the inner
    cells' lattice positions (with a mask, the unmasked ones') with a
    one-cell margin, interpolate the normals onto the box and form the
    ramps ``A = n_x/n_z``, ``B = n_y/n_z`` on the lattice's device, in
    ``regrid._bilinear``'s and NumPy's float64 operations and order, and
    with a mask the lattice mask of the cells that an unmasked cell's
    read-back stencil touches.  ``pg``: the mesh's planarisation, when the
    caller has it already (its device is then the lattice's).

    Unlike the reference the box is not padded to tile multiples nor moved
    up/left at the lattice's edge (``horizon.py:729-747``): the kernel
    sweeps it as it is.  Returns a dict: ``pg`` (the
    :class:`~horayzon_tpu_torch.regrid.PlanarizedGrid` of tensors),
    ``box`` ``(i_lo, i_hi, j_lo, j_hi)``, ``norm_r`` (the box's unit
    normals, float64), ``ramp`` (A, B) float32 and ``lat_mask`` (uint8 or
    None), tensors on the lattice's device, and ``fi``, ``fj`` (the inner
    cells' lattice positions, NumPy arrays, from which the host forms the
    box and the read-back's weights)."""
    in0, in1 = vec_norm.shape[:2]
    if pg is None:
        with span("hzt.curved.planarize"):
            pg = _planarize.planarize(x, y, z, device=device)
    with span("hzt.curved.lattice"):
        dev = pg.z.device
        hr, wr = pg.grid.shape
        x_in = x[offset_0:offset_0 + in0, offset_1:offset_1 + in1]
        y_in = y[offset_0:offset_0 + in0, offset_1:offset_1 + in1]
        fi_in, fj_in = pg.to_regular_indices(x_in, y_in)
        if mask is not None and (mask == 1).any():
            sel = mask == 1
            fi_b, fj_b = fi_in[sel], fj_in[sel]
        else:
            fi_b, fj_b = fi_in, fj_in
        i_lo = max(int(np.floor(fi_b.min())) - 1, 0)
        i_hi = min(int(np.ceil(fi_b.max())) + 2, hr)
        j_lo = max(int(np.floor(fj_b.min())) - 1, 0)
        j_hi = min(int(np.ceil(fj_b.max())) + 2, wr)
        rin0, rin1 = i_hi - i_lo, j_hi - j_lo
        # pg.fi is never -0.0, so clamp agrees with np.clip to the bit
        fi_src = (pg.fi[i_lo:i_hi, j_lo:j_hi] - offset_0).clamp(0.0,
                                                               in0 - 1.0)
        fj_src = (pg.fj[i_lo:i_hi, j_lo:j_hi] - offset_1).clamp(0.0,
                                                               in1 - 1.0)
        vn = torch.from_numpy(np.ascontiguousarray(vec_norm)).to(dev)
        norm_r = _planarize.bilinear(vn.double(), fi_src, fj_src)
        # np.linalg.norm over the last axis: ((n0^2 + n1^2) + n2^2) ** 0.5
        n0, n1, n2 = norm_r.unbind(-1)
        norm_r = norm_r / _sqrt((n0 * n0 + n1 * n1) + n2 * n2)[..., None]
        ramp = ((norm_r[..., 0] / norm_r[..., 2]).float(),
                (norm_r[..., 1] / norm_r[..., 2]).float())
        lat_mask = None
        if mask is not None and (mask == 1).any():
            # a lattice cell is swept iff an unmasked cell's bilinear
            # read-back stencil touches it (horayzon_tpu/horizon.py:774-784)
            lat_mask = np.zeros((rin0, rin1), dtype=np.uint8)
            i0m = np.floor(np.clip(fi_b - i_lo, 0.0, rin0 - 1.0)).astype(
                np.int64)
            j0m = np.floor(np.clip(fj_b - j_lo, 0.0, rin1 - 1.0)).astype(
                np.int64)
            for di in (0, 1):
                for dj in (0, 1):
                    lat_mask[np.clip(i0m + di, 0, rin0 - 1),
                             np.clip(j0m + dj, 0, rin1 - 1)] = 1
        elif mask is not None:
            # no unmasked cell: nothing to sweep
            lat_mask = np.zeros((rin0, rin1), dtype=np.uint8)
        if lat_mask is not None:
            lat_mask = torch.from_numpy(lat_mask).to(dev)
    return dict(pg=pg, box=(i_lo, i_hi, j_lo, j_hi), norm_r=norm_r,
                ramp=ramp, lat_mask=lat_mask, fi=fi_in, fj=fj_in)


def read_back(hori_r, fi, fj):
    """Bilinear read-back of the lattice horizon ``hori_r`` (h, w, A) at
    lattice positions ``fi``, ``fj`` (in0, in1), on ``hori_r``'s device in
    float64 with ``regrid._bilinear``'s operations in its order (indices
    and weights on the host, as it forms them), cast to float32: bit-equal
    to ``_bilinear`` on the same lattice horizon."""
    h, w = hori_r.shape[:2]
    i0 = np.clip(np.floor(fi).astype(np.int64), 0, h - 2)
    j0 = np.clip(np.floor(fj).astype(np.int64), 0, w - 2)
    wi = np.clip(fi - i0, 0.0, 1.0)
    wj = np.clip(fj - j0, 0.0, 1.0)
    dev = hori_r.device

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    a = hori_r.double()
    i0t, j0t = t(i0), t(j0)
    terms = [t((1 - wi) * (1 - wj))[..., None] * a[i0t, j0t],
             t((1 - wi) * wj)[..., None] * a[i0t, j0t + 1],
             t(wi * (1 - wj))[..., None] * a[i0t + 1, j0t],
             t(wi * wj)[..., None] * a[i0t + 1, j0t + 1]]
    return (((terms[0] + terms[1]) + terms[2]) + terms[3]).float()


def _curved_gridded(x, y, z, vec_norm, vec_north, offset_0, offset_1, *,
                    azim_num, dist_search, hori_acc, elev_ang_low_lim,
                    ray_org_elev, mask=None, device="cuda", engine="auto"):
    """Curved-mesh gridded horizon (``horayzon_tpu/horizon.py:684-851``):
    :func:`curved_lattice` on ``device``, the sweep over the box there,
    then :func:`read_back` at the inner cells' positions.  The fused route
    sweeps with the tilt ramp (and the lattice mask), which it takes as
    tensors or NumPy arrays; with ``engine="sweep"`` the XLA engine sweeps
    the box with the general basis of the normals and norths interpolated
    onto it (``:834-842``).  Masked cells read values that the caller
    overwrites with its fill.  Returns (in0, in1, azim_num) float32 on
    ``device``."""
    lat = curved_lattice(x, y, z, vec_norm, offset_0, offset_1, mask,
                         device=device)
    pg, (i_lo, i_hi, j_lo, j_hi) = lat["pg"], lat["box"]
    rin0, rin1 = i_hi - i_lo, j_hi - j_lo
    _profiling.count_lattice(rin0 * rin1, lat["fi"].size)
    with span("hzt.curved.upload"):
        z_dev = torch.as_tensor(pg.z, device=device)
        if engine != "sweep":
            ramp = tuple(torch.as_tensor(r, device=device)
                         for r in lat["ramp"])
            lat_mask = (None if lat["lat_mask"] is None
                        else torch.as_tensor(lat["lat_mask"], device=device))
    if engine == "sweep":
        geom, u_xy = _box_basis(lat, vec_norm, vec_north, offset_0, offset_1,
                                azimuth_angles(azim_num))
        hori_r, _ = _sweep.horizon_sweep(
            z_dev, dx=pg.grid.dx, dy=pg.grid.dy, offset=(i_lo, j_lo),
            inner_shape=(rin0, rin1), azim=azimuth_angles(azim_num),
            dist_search=dist_search, hori_acc=hori_acc,
            elev_ang_low_lim=elev_ang_low_lim, ray_org_elev=ray_org_elev,
            geom=geom, u_xy=u_xy)
    else:
        hori_r = _fused.horizon_sweep_fused(
            z_dev, dx=pg.grid.dx, dy=pg.grid.dy, offset=(i_lo, j_lo),
            inner_shape=(rin0, rin1), azim_num=azim_num,
            dist_search=dist_search, hori_acc=hori_acc,
            elev_ang_low_lim=elev_ang_low_lim, ray_org_elev=ray_org_elev,
            tilt_ramp=ramp, mask=lat_mask)
    with span("hzt.curved.readback"):
        return read_back(hori_r, np.clip(lat["fi"] - i_lo, 0.0, rin0 - 1.0),
                         np.clip(lat["fj"] - j_lo, 0.0, rin1 - 1.0))


def _box_basis(lat, vec_norm, vec_north, offset_0, offset_1, azim):
    """The general basis on a curved run's lattice box
    (``horayzon_tpu/horizon.py:752-763``): the inner cells' normals and
    norths interpolated onto the box (float64), the norths made
    orthogonal to the normals, both unit and cast to float32, in NumPy on
    the host (the lattice's fields brought there once); returns
    ``(basis_fields, mean_marching_directions)``."""
    i_lo, i_hi, j_lo, j_hi = lat["box"]
    in0, in1 = vec_norm.shape[:2]
    pg = lat["pg"]
    fi_src = np.clip(pg.fi[i_lo:i_hi, j_lo:j_hi].cpu().numpy() - offset_0,
                     0.0, in0 - 1.0)
    fj_src = np.clip(pg.fj[i_lo:i_hi, j_lo:j_hi].cpu().numpy() - offset_1,
                     0.0, in1 - 1.0)
    norm_r = lat["norm_r"].cpu().numpy()
    north_r = _regrid._bilinear(np.asarray(vec_north, np.float64), fi_src,
                                fj_src)
    north_r -= np.sum(north_r * norm_r, axis=-1, keepdims=True) * norm_r
    north_r /= np.linalg.norm(north_r, axis=-1, keepdims=True)
    norm_r = norm_r.astype(np.float32)
    north_r = north_r.astype(np.float32)
    return (_terrain.basis_fields(norm_r, north_r),
            _terrain.mean_marching_directions(azim, norm_r, north_r))


def horizon_locations(
        vert_grid, dem_dim_0, dem_dim_1,
        coords, vec_norm, vec_north,
        dist_search,
        azim_num=360,
        hori_acc=0.25,
        ray_algorithm="binary_search",
        geom_type="grid",
        elev_ang_low_lim=-89.98,
        ray_org_elev=None,
        hori_dist_out=False,
        *, device="cuda"):
    """Horizon computation for arbitrary locations
    (``horayzon_tpu.horizon.horizon_locations``, reference horizon.pyx:218).

    Signature and validation mirror the reference's (``dist_search`` in
    kilometres).  The observer elevation is the heightfield sampled at the
    location's (x, y), lifted by ``ray_org_elev`` (one value or one per
    location) along its normal.  A curved (irregular) mesh is planarised
    on ``device`` (:func:`horayzon_tpu_torch.ops.planarize.planarize`);
    the locations keep their exact ENU coordinates and frames.  ``device``:
    where the sweep runs (:mod:`horayzon_tpu_torch.ops.locations`, plain
    torch), the card unless the caller asks for the CPU.

    Returns ``(hori, azim)`` or, with ``hori_dist_out``, ``(hori,
    hori_dist, azim)``: (L, azim_num) float32 [radian / metre] and
    (azim_num,) float32 [radian], tensors on ``device``.
    """
    coords = np.asarray(coords, dtype=np.float32)
    vec_norm = np.asarray(vec_norm, dtype=np.float32)
    vec_north = np.asarray(vec_north, dtype=np.float32)
    if (coords.ndim != 2) or (coords.shape[1] != 3) \
            or (coords.shape[0] != vec_norm.shape[0]):
        raise ValueError("'number of dimensions and/or dimension length(s) "
                         "of 'coords' incorrect")
    if vec_norm.shape != vec_north.shape or vec_norm.ndim != 2:
        raise ValueError("dimension (lengths) of vec_norm and/or vec_north "
                         "is/are erroneous")
    if ray_algorithm not in _VALID_ALGOS:
        raise ValueError("invalid input argument for ray_algorithm")
    if hori_acc > 10.0:
        raise ValueError("limit of hori_acc (10 degree) is exceeded")
    if ray_org_elev is None:
        ray_org_elev = np.array([0.01], dtype=np.float32)
    ray_org_elev = np.atleast_1d(np.asarray(ray_org_elev, dtype=np.float32))
    num_loc = coords.shape[0]
    if len(ray_org_elev) not in (1, num_loc):
        raise ValueError("length of array 'ray_org_elev' must be either one "
                         "or correspond to the number of locations")
    if ray_org_elev.min() < 0.005:
        raise TypeError("minimal allowed value for 'ray_org_elev' is 0.005 m")
    if len(ray_org_elev) == 1:
        ray_org_elev = np.repeat(ray_org_elev, num_loc)

    x, y, z = _terrain.decompose_vert_grid(vert_grid, dem_dim_0, dem_dim_1)
    grid = _terrain.detect_regular_grid(x, y)
    if grid is None:
        # the per-location sweep measures angles in each location's own
        # tangent frame, so it runs unchanged on the resampled lattice
        pg = _planarize.planarize(x, y, z, device=device)
        grid, z_dev = pg.grid, pg.z
    else:
        z_dev = torch.from_numpy(np.ascontiguousarray(z)).to(device)

    azim = azimuth_angles(azim_num)
    hori, hori_dist = _locations.horizon_locations_sweep(
        z_dev, grid, coords,
        vec_norm, vec_north, azim, dist_search * 1000.0, hori_acc,
        elev_ang_low_lim, ray_org_elev)
    azim = torch.from_numpy(azim).to(device)
    if hori_dist_out:
        return hori, hori_dist, azim
    return hori, azim
