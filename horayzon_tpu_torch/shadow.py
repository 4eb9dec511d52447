# Copyright (c) 2026
# MIT License
"""Shadow maps and shortwave-radiation correction factors in torch.

Counterpart of :mod:`horayzon_tpu.shadow` (the reference's
``horayzon/shadow.pyx`` + ``shadow_comp.cpp``): a :class:`Terrain` is
initialised once with the DEM and the per-cell vectors, then queried per
sun position or per sun track.  Ported: regular planar grids and curved
(irregular, e.g. lon/lat on the ellipsoid) meshes (``geom_type="grid"``),
``shadow``, ``sw_dir_cor`` and their ``*_batch`` forms, with or without
refraction, with masks and fill values, and the differentiable
``sw_dir_cor_soft``.  The occlusion test runs as one fused sweep over the
whole sun batch
(:func:`horayzon_tpu_torch.ops.shadow_sweep.shadow_metric_fused`: kernel K2
on a CUDA device, its plain torch version on the CPU), on the padded
max-mip pyramid and the pooled companions of its skips built once at
:meth:`Terrain.initialise`.  The queries only threshold the metric at 0,
so K2 runs its sign-exact skips there, as the reference's ``Terrain``
does; ``sw_dir_cor_soft`` takes the exact metric.  A curved mesh is
planarised onto a regular lattice (:func:`horayzon_tpu_torch.ops.
planarize.planarize`, on the terrain's device); the sweep runs over the
lattice box of the inner cells and its result is read back at each cell's
nearest lattice cell, while the per-cell classification (:func:`_classify`,
elementwise torch on the same device) stays at the original cells.
``sw_dir_cor_soft`` runs the metric's gradient path (K2-argmax and the
winner-replay backward K4 on the card).

``engine="sweep"`` and ``engine="scan"`` are the reference's XLA engines,
plain torch on the terrain's device, by design as the reference runs them
in XLA: the marching sweep (:func:`horayzon_tpu_torch.ops.sweep.
shadow_metric_core`, per-cell ray slopes) and the log-doubling scan
(:mod:`horayzon_tpu_torch.ops.shadow_scan`, the domain-mean slope), one
sun at a time as ``jax.lax.map`` runs them (:func:`_sun_step`), and
``sw_dir_cor_soft`` through the marching sweep by autograd
(:func:`_soft_sun_step`'s metric) on both.
"""

import math
import time

import numpy as np
import torch

from horayzon_tpu_torch import horizon as _horizon
from horayzon_tpu_torch import terrain as _terrain
from horayzon_tpu_torch.ops import fused_sweep as _fused
from horayzon_tpu_torch.ops import mip as _mip
from horayzon_tpu_torch.ops import planarize as _planarize
from horayzon_tpu_torch.ops import refraction as _refraction
from horayzon_tpu_torch.ops import shadow_scan as _scan
from horayzon_tpu_torch.ops import shadow_sweep as _ss
from horayzon_tpu_torch.ops import sweep as _sweep
from horayzon_tpu_torch.utils.profiling import span

_RAY_ORG_ELEV = 0.05  # hard-coded lift of the ray origin [m]
                      # (shadow_comp.cpp:388,497)


_F32 = np.float32


def _numpy(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def sun_dots(fields, sun_positions, refrac_cor):
    """``(dot_ns, dot_ts)`` (T, in0, in1) float32: each cell's unit vector
    toward each sun of ``sun_positions`` (T, 3), refracted if
    ``refrac_cor``, dotted with the cell's normal and tilt vectors
    (shadow_comp.cpp:421-447 / :541-559)."""
    dev = fields["x_in"].device
    sp = torch.from_numpy(np.ascontiguousarray(sun_positions,
                                               dtype=np.float32)).to(dev)
    sx = sp[:, 0, None, None] - fields["x_in"]
    sy = sp[:, 1, None, None] - fields["y_in"]
    sz = sp[:, 2, None, None] - fields["z_org"]
    mag = _ss.sqrt_rn(sx * sx + sy * sy + sz * sz)
    sun = torch.stack([sx / mag, sy / mag, sz / mag], dim=-1)
    if refrac_cor:
        sun = _refraction.refract_sun_vector(sun, fields["norm"],
                                             fields["elevation"])
    return (_refraction.dot3(fields["norm"], sun),
            _refraction.dot3(fields["tilt"], sun))


def _classify(fields, sun_positions, occluded, *, mode, refrac_cor,
              ang_max, metric=None, soft_tau=None, straight_through=True):
    """Per-cell illumination classification given the occlusion result
    (``horayzon_tpu.shadow._classify_one``, shadow_comp.cpp:449-484 /
    :561-596), batched over the (T, 3) ``sun_positions``.

    ``mode="shadow"``: uint8 codes 0 illuminated, 1 self-shaded, 2
    terrain-shaded, 3 masked.  ``mode="sw_dir_cor"``: the Mueller & Scherer
    (2005) factor ``dot_ts / max(dot_ns, cos(ang_max)) * surf_enl_fac``, 0
    where occluded or where the sun is within ``90 - ang_max`` degrees of
    the tilted plane, the fill value on masked cells.

    ``metric``/``soft_tau`` (sw_dir_cor): the soft occlusion
    ``sigmoid(metric / soft_tau)`` in place of the hard step (whose
    gradient is zero almost everywhere); with ``straight_through`` the
    value stays the hard one bit for bit and only the gradient is the
    sigmoid's (``horayzon_tpu/shadow.py:152-161``)."""
    with span("hzt.terrain.classify"):
        dot_ns, dot_ts = sun_dots(fields, sun_positions, refrac_cor)
        mask = fields["mask"]
        if mode == "shadow":
            def u8(v):
                return torch.tensor(v, dtype=torch.uint8, device=mask.device)
            code = torch.where(dot_ts > 0.0,
                               torch.where(occluded, u8(2), u8(0)), u8(1))
            return torch.where(mask, code, u8(3))
        dot_min = float(np.float32(math.cos(math.radians(ang_max))))
        # torch.maximum, not clamp_min: at an exact tie both halve the
        # gradient, as jnp.maximum does (clamp_min passes all of it)
        val = (dot_ts / torch.maximum(dot_ns, dot_ns.new_tensor(dot_min))) \
            * fields["surf_enl_fac"]
        if metric is not None and soft_tau is not None:
            # a tensor divisor: a CUDA tensor over a Python scalar is a
            # product with the scalar's reciprocal, which rounds twice
            tau = torch.tensor(np.float32(soft_tau), device=metric.device)
            occ_soft = torch.sigmoid(metric / tau)
            if straight_through:
                occ_eff = occ_soft + (torch.where(occluded, 1.0, 0.0)
                                      - occ_soft).detach()
            else:
                occ_eff = occ_soft
            val = val * (1.0 - occ_eff)
        else:
            val = torch.where(occluded, 0.0, val)
        out = torch.where(dot_ts > dot_min, val, 0.0)
        return torch.where(mask, out, fields["sw_dir_cor_fill"])


def sun_direction(sun, center, dxdy):
    """The host part of the XLA engines' per-sun set-up
    (``horayzon_tpu/shadow.py:69-78``), in float32 as XLA forms it: the
    unit horizontal direction ``(kx_u, ky_u)`` toward ``sun`` (3,) from
    the lattice centre, the marching direction ``u_cells`` (ui, uj) in
    cells per metre, the near-vertical flag and ``|k|``."""
    sun = np.asarray(sun, dtype=_F32)
    kx, ky = sun[0] - center[0], sun[1] - center[1]
    k_norm = np.sqrt(kx * kx + ky * ky)
    near_vertical = bool(k_norm < _F32(1.0e-6))
    den = np.maximum(k_norm, _F32(1.0e-6))
    kx_u = _F32(1.0) if near_vertical else kx / den
    ky_u = _F32(0.0) if near_vertical else ky / den
    u_cells = np.array([ky_u / dxdy[1], kx_u / dxdy[0]], dtype=_F32)
    return kx_u, ky_u, u_cells, near_vertical, k_norm


def ray_slope(sun, xr, yr, z_org_r, kx_u, ky_u):
    """The per-cell sun-ray slope ``m`` (c0, c1) of the XLA engines
    (``horayzon_tpu/shadow.py:64-83``): ``(sz / |s|) / max(s . k / |s|,
    1e-4)`` from each lattice cell's ray origin toward ``sun``."""
    sxr = float(sun[0]) - xr
    syr = float(sun[1]) - yr
    szr = float(sun[2]) - z_org_r
    mag = _ss.sqrt_rn(sxr * sxr + syr * syr + szr * szr)
    adv = (sxr * float(kx_u) + syr * float(ky_u)) / mag
    return (szr / mag) / torch.maximum(adv, adv.new_tensor(_F32(1.0e-4)))


def back_map(bi, bj, box_shape):
    """The nearest back-map of a curved mesh's cells onto the lattice box:
    ``bi``, ``bj`` (in0, in1) int64 box indices, and its inverse
    ``cells`` (box cells, k) int64: the flat indices of the original cells
    that read each box cell, in increasing order, padded with ``in0 *
    in1`` (a zero appended to the cotangent).  Built once on the host."""
    c0, c1 = box_shape
    flat = (bi.astype(np.int64) * c1 + bj).ravel()
    order = np.argsort(flat, kind="stable")
    counts = np.bincount(flat, minlength=c0 * c1)
    starts = np.cumsum(counts) - counts
    cells = np.full((c0 * c1, max(int(counts.max()), 1)), flat.size,
                    dtype=np.int64)
    cells[flat[order], np.arange(flat.size) - starts[flat[order]]] = order
    return bi.astype(np.int64), bj.astype(np.int64), cells


class _GatherCells(torch.autograd.Function):
    """``box[:, bi, bj]``: a (T, c0, c1) lattice-box field read at the
    original cells (``horayzon_tpu/shadow.py:118-121``).  The backward
    sums each box cell's cotangents over the inverse table ``cells``, one
    term after another in its fixed order, so it has no atomics and is
    bit-equal across runs on the card (autograd's own backward of the
    index is an accumulating ``index_put_``)."""

    @staticmethod
    def forward(ctx, box, bi, bj, cells):
        ctx.save_for_backward(cells)
        ctx.box_shape = tuple(box.shape)
        return box[:, bi, bj]

    @staticmethod
    def backward(ctx, g):
        (cells,) = ctx.saved_tensors
        t = g.shape[0]
        gf = torch.cat([g.reshape(t, -1), g.new_zeros((t, 1))], dim=1)
        acc = gf[:, cells[:, 0]]
        for k in range(1, cells.shape[1]):
            acc = acc + gf[:, cells[:, k]]
        return acc.reshape(ctx.box_shape), None, None, None


class Terrain:
    """Initialise-once / query-many terrain shadow engine.

    Mirrors ``horayzon_tpu.shadow.Terrain`` (the reference Terrain cdef
    class, shadow.pyx:17-199).  The queries return tensors on the device
    given to :meth:`initialise`."""

    def __init__(self):
        self._initialised = False

    def initialise(self, vert_grid, dem_dim_0, dem_dim_1,
                   offset_0, offset_1,
                   vec_tilt, vec_norm,
                   surf_enl_fac, elevation, mask,
                   geom_type="grid",
                   sw_dir_cor_fill=np.nan,
                   ang_max=89.0,
                   refrac_cor=False,
                   acc=0.25,
                   engine="auto",
                   *, device="cuda"):
        """Load DEM data and build the device-resident terrain state.

        Signature and validation mirror ``horayzon_tpu.shadow.Terrain.
        initialise`` (shadow.pyx:27-147); ``acc`` drives the sweep's sample
        density.  ``device``: where the terrain lives and the queries run,
        the card unless the caller asks for the CPU; a CUDA device runs
        kernel K2, the CPU its plain torch version.
        ``engine``: "auto" and "pallas" both run the fused sweep; "sweep"
        and "scan" the reference's XLA engines in plain torch on
        ``device`` (the marching sweep with per-cell ray slopes, the
        log-doubling scan with the domain-mean slope).  The inner block is
        swept as it is (one kernel thread per (cell, sun)), so it needs no
        room to pad to tile multiples.

        A curved (irregular) mesh is planarised on ``device`` (the
        kernel on a CUDA device, NumPy float64 on the CPU; its seconds are
        kept in ``planarize_s``), the lattice's fields come to the host
        once, and the sweep runs over the box of the inner cells' lattice
        positions (``offset``, ``comp_shape``), whose ray origins lift the
        lattice heights along the box's interpolated normals; the metric is
        read back at each cell's nearest lattice cell before the
        classification, which keeps each cell's own position, heights and
        vectors (``horayzon_tpu/shadow.py:309-353``)."""
        if engine not in ("auto", "sweep", "scan", "pallas"):
            raise ValueError(
                "engine must be 'auto', 'sweep', 'scan' or 'pallas'")
        vec_tilt = np.asarray(_numpy(vec_tilt), dtype=np.float32)
        vec_norm = np.asarray(_numpy(vec_norm), dtype=np.float32)
        surf_enl_fac = np.asarray(_numpy(surf_enl_fac), dtype=np.float32)
        elevation = np.asarray(_numpy(elevation), dtype=np.float32)
        mask = _numpy(mask)
        # --- Validation (mirrors shadow.pyx:86-133) -----------------------
        if ((offset_0 + vec_tilt.shape[0] > dem_dim_0)
                or (offset_1 + vec_tilt.shape[1] > dem_dim_1)):
            raise ValueError("inconsistency between input arguments "
                             "'dem_dim_0', 'dem_dim_1', 'offset_0', "
                             "'offset_1' and 'vec_norm'")
        if ((vec_tilt.ndim != 3) or (vec_norm.ndim != 3)
                or (vec_tilt.shape[2] != 3)
                or (vec_tilt.shape != vec_norm.shape)):
            raise ValueError("Inconsistent/incorrect shape of 'vec_tilt' "
                             "and/or 'vec_norm'")
        shp = vec_tilt.shape[:2]
        if (surf_enl_fac.shape != shp or elevation.shape != shp
                or mask.shape != shp):
            raise ValueError("Inconsistent/incorrect shape of "
                             "'surf_enl_fac', 'elevation' and/or 'mask'")
        if ((np.abs((vec_tilt ** 2).sum(axis=2) - 1.0).max() > 1.0e-5)
                or (np.abs((vec_norm ** 2).sum(axis=2) - 1.0).max()
                    > 1.0e-5)):
            raise ValueError("Vectors in 'vec_tilt' and/or 'vec_norm' are "
                             "not normalised")
        if geom_type not in ("triangle", "quad", "grid"):
            raise ValueError("invalid input argument for geom_type")
        if mask.dtype != np.uint8:
            raise TypeError("data type of mask must be 'uint8'")
        if (ang_max < 85.0) or (ang_max > 89.99):
            raise TypeError("'ang_max' must be in the range [85.0, 89.99]")
        self.engine = "pallas" if engine == "auto" else engine

        x, y, z = _terrain.decompose_vert_grid(_numpy(vert_grid), dem_dim_0,
                                               dem_dim_1)
        grid = _terrain.detect_regular_grid(x, y)
        in0, in1 = shp
        dev = torch.device(device)
        self.device = dev
        self.inner_shape = (in0, in1)
        self.ang_max = float(ang_max)
        self.refrac_cor = bool(refrac_cor)
        self.acc = float(acc)
        self._curved = grid is None

        # Per-cell fields of the classification, at the original cells
        sl_in = (slice(offset_0, offset_0 + in0),
                 slice(offset_1, offset_1 + in1))
        x_in = x[sl_in].astype(np.float32)
        y_in = y[sl_in].astype(np.float32)
        z_in = z[sl_in].astype(np.float32)
        z_org = z_in + _RAY_ORG_ELEV * vec_norm[..., 2]

        # Lattice fields of the sweep (horayzon_tpu/shadow.py:309-353)
        self.planarize_s = 0.0
        back = None
        if not self._curved:
            z_comp = z
            self.offset = (int(offset_0), int(offset_1))
            self.comp_shape = (in0, in1)
            z_inner_r, z_org_r, norm_r_z = z_in, z_org, vec_norm[..., 2]
        else:
            # planarise, box the inner cells' lattice positions with a
            # -1 / +2 margin and bring the normals onto the box
            t0 = time.perf_counter()
            pg = _planarize.planarize(x, y, z, device=dev)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            self.planarize_s = time.perf_counter() - t0
            lat = _horizon.curved_lattice(x, y, z, vec_norm, offset_0,
                                          offset_1, pg=pg)
            grid, z_comp = pg.grid, pg.z.cpu().numpy()
            i_lo, i_hi, j_lo, j_hi = lat["box"]
            self.offset = (i_lo, j_lo)
            self.comp_shape = (i_hi - i_lo, j_hi - j_lo)
            norm_r_z = lat["norm_r"][..., 2].cpu().numpy()
            z_inner_r = z_comp[i_lo:i_hi, j_lo:j_hi]
            z_org_r = (z_inner_r
                       + _RAY_ORG_ELEV * norm_r_z).astype(np.float32)
            # the nearest lattice cell of every original cell
            bi = np.clip(np.rint(lat["fi"] - i_lo).astype(np.int32), 0,
                         self.comp_shape[0] - 1)
            bj = np.clip(np.rint(lat["fj"] - j_lo).astype(np.int32), 0,
                         self.comp_shape[1] - 1)
            back = back_map(bi, bj, self.comp_shape)
        self.grid = grid
        comp_h, comp_w = z_comp.shape
        if self._curved:
            xr1 = grid.x0 + np.arange(j_lo, j_hi) * grid.dx
            yr1 = grid.y0 + np.arange(i_lo, i_hi) * grid.dy
            xr = np.broadcast_to(xr1[None, :], self.comp_shape)
            yr = np.broadcast_to(yr1[:, None], self.comp_shape)
        else:
            xr, yr = x_in, y_in

        # Sun directions are taken from the lattice's centre
        # (horayzon_tpu/shadow.py:372-375)
        x_axis = grid.x_axis()
        y_axis = grid.y_axis()
        self._center = (float(0.5 * (x_axis[0] + x_axis[-1])),
                        float(0.5 * (y_axis[0] + y_axis[-1])))
        self._grid_origin = (float(grid.x0), float(grid.y0))

        # Initialise-once: the padded max-mip pyramid of the outer grid
        # (the reference builds its BVH once here, shadow_comp.cpp:318-380)
        self._z_outer = torch.from_numpy(
            np.ascontiguousarray(z_comp, dtype=np.float32)).to(dev)
        self.plan = _ss.plan_shadow(tuple(self._z_outer.shape),
                                    inner_shape=self.comp_shape,
                                    offset=self.offset, dx=grid.dx,
                                    dy=grid.dy, hori_acc=self.acc)
        self._levels = _mip.padded_levels(self._z_outer, self.plan["pads"])
        # and the pooled companions behind K2's skips (the reference keeps
        # them as _pallas_pooled)
        self._pooled = (_fused.skip_inputs(self._levels, self.plan)
                        if self.engine == "pallas" else None)
        # the XLA engines' schedule (not split at the safe halo), scan
        # parameters and lattice centre (horayzon_tpu/shadow.py:359-375)
        diag = math.hypot(comp_w * abs(grid.dx), comp_h * abs(grid.dy))
        step = min(abs(grid.dx), abs(grid.dy))
        self.schedule = _sweep.build_schedule(step, diag,
                                              _sweep.default_rel_err(acc))
        self._s_phases = _sweep.shadow_s_phases(self.schedule)
        self.scan_meta = _scan.scan_meta(diag, step)
        self._center32 = np.array(
            [*self._center, float(np.mean(np.asarray(z_org_r, _F32)))],
            dtype=_F32)

        def on_dev(a, dtype=torch.float32):
            return torch.from_numpy(np.ascontiguousarray(a)).to(
                device=dev, dtype=dtype)

        self._fields = {
            "x_in": on_dev(x_in), "y_in": on_dev(y_in),
            "z_org": on_dev(z_org),
            "norm": on_dev(vec_norm), "tilt": on_dev(vec_tilt),
            "surf_enl_fac": on_dev(surf_enl_fac),
            "elevation": on_dev(elevation),
            "mask": on_dev(mask == 1, torch.bool),
            "sw_dir_cor_fill": float(np.float32(sw_dir_cor_fill)),
            "z_org_r": on_dev(z_org_r), "z_inner_r": on_dev(z_inner_r),
            "norm_r_z": on_dev(norm_r_z),
            "xr": on_dev(xr), "yr": on_dev(yr),
        }
        self._back = (None if back is None else
                      tuple(on_dev(a, torch.int64) for a in back))
        self._initialised = True
        num_gc = int((mask == 1).sum())
        print(f"Considered grid cells (number): {num_gc}")
        if refrac_cor:
            print("Account for atmospheric refraction")

    # ------------------------------------------------------------------
    def _check(self, sun_position):
        if not self._initialised:
            raise RuntimeError("Terrain not initialised")
        sun_position = np.asarray(_numpy(sun_position), dtype=np.float32)
        if sun_position.ndim == 1:
            if sun_position.size != 3:
                raise ValueError("array 'sun_position' has incorrect shape")
        elif sun_position.ndim != 2 or sun_position.shape[1] != 3:
            raise ValueError("array 'sun_position' has incorrect shape")
        return sun_position

    def _metric(self, sun_positions, plain=False):
        """The occlusion metric (T, c0, c1) over the swept block (the inner
        block, or a curved mesh's lattice box) for a (T, 3) sun track and
        the (T,) near-vertical flags of the sun table (the sun straight
        above the domain centre: no horizontal marching direction).  The
        queries only threshold it at 0, so on the card K2 runs its
        sign-exact arm (``exact_metric=False``, as
        ``horayzon_tpu/shadow.py:494-505`` asks): the sign is exact, the
        value is not.  ``plain``: the plain torch sweep (the exact metric)
        on the terrain's device in place of kernel K2.  The XLA engines
        run :meth:`_xla_metric`."""
        if self.engine != "pallas":
            f = self._fields
            return self._xla_metric(sun_positions, f["z_org_r"],
                                    f["z_inner_r"], self._levels,
                                    scan=self.engine == "scan")
        with span("hzt.terrain.sun_table"):
            table, near_vert = _ss.shadow_sun_table(
                sun_positions, self._center, self.grid.dx, self.grid.dy)
        f = self._fields
        kw = dict(offset=self.offset, inner_shape=self.comp_shape,
                  dx=self.grid.dx, dy=self.grid.dy,
                  grid_origin=self._grid_origin, hori_acc=self.acc,
                  pyramid=self._levels)
        if plain:
            metric = _ss.shadow_metric_plain(self._z_outer, f["z_org_r"],
                                             f["z_inner_r"], table, **kw)
        else:
            metric = _ss.shadow_metric_fused(
                self._z_outer, f["z_org_r"], f["z_inner_r"], table,
                pooled=self._pooled, exact_metric=False, **kw)
        return metric, near_vert

    def _xla_metric(self, sun_positions, z_org_r, z_inner_r, levels,
                    scan=False):
        """The metric (T, c0, c1) of the XLA engines and the (T,)
        near-vertical flags, one sun after another (``_sun_step``,
        ``horayzon_tpu/shadow.py:48-104``): the marching sweep
        (:func:`horayzon_tpu_torch.ops.sweep.shadow_metric_core`) over the
        padded ``levels`` with per-cell ray slopes from ``z_org_r``, or
        with ``scan`` the log-doubling scan with the domain-mean slope.
        Differentiable by autograd through ``levels`` and ``z_org_r``."""
        c = self._center32
        dxdy = np.array([self.grid.dx, self.grid.dy], dtype=_F32)
        f = self._fields
        metrics, near_vert = [], []
        for sun in np.asarray(sun_positions, dtype=_F32):
            kx_u, ky_u, u_cells, nv, k_norm = sun_direction(sun, c, dxdy)
            if scan:
                num_doublings, pad, step = self.scan_meta
                m_mean = (sun[2] - c[2]) / np.maximum(k_norm, _F32(1e-6))
                metric = _scan.shadow_scan_core(
                    self._z_outer, z_org_r, m_mean, u_cells, step,
                    num_doublings=num_doublings, pad=pad, offset=self.offset,
                    inner_shape=self.comp_shape)
            else:
                m_slope = ray_slope(sun, f["xr"], f["yr"], z_org_r, kx_u,
                                    ky_u)
                metric = _sweep.shadow_metric_core(
                    levels, z_org_r, z_inner_r, m_slope, u_cells,
                    self._s_phases, sched_meta=self.schedule.meta(),
                    offset=self.offset, inner_shape=self.comp_shape,
                    outer_shape=tuple(self._z_outer.shape))
            metrics.append(metric)
            near_vert.append(nv)
        return torch.stack(metrics), np.array(near_vert, dtype=bool)

    def at_cells(self, box):
        """A (T, c0, c1) field of the swept block at the original cells,
        (T, in0, in1): itself on a planar grid; on a curved mesh its value
        at each cell's nearest lattice cell, differentiable with a
        backward that is bit-equal across runs (:class:`_GatherCells`)."""
        if self._back is None:
            return box
        return _GatherCells.apply(box, *self._back)

    def _run(self, sun_position, mode, plain=False):
        """Batched occlusion through the fused sweep, then classification
        (``horayzon_tpu.shadow.Terrain._run_pallas``)."""
        with span("hzt.terrain.sun_table"):
            sun_position = self._check(sun_position)
            single = sun_position.ndim == 1
            sp = np.atleast_2d(sun_position)
        metric, near_vert = self._metric(sp, plain)
        with span("hzt.terrain.occluded"):
            lit = ~torch.from_numpy(near_vert).to(metric.device)
            occluded = self.at_cells((metric > 0.0) & lit[:, None, None])
        out = _classify(self._fields, sp, occluded, mode=mode,
                        refrac_cor=self.refrac_cor, ang_max=self.ang_max)
        return out[0] if single else out

    # ------------------------------------------------------------------
    def shadow(self, sun_position, shadow_buffer=None):
        """Shadow mask for one sun position (shadow.pyx:149-170): uint8,
        0 illuminated, 1 self-shaded, 2 terrain-shaded, 3 masked.  A NumPy
        ``shadow_buffer`` is filled with it."""
        with span("hzt.terrain.query"):
            out = self._run(sun_position, "shadow")
            if shadow_buffer is not None:
                with span("hzt.terrain.readback"):
                    shadow_buffer[:] = out.cpu().numpy()
            return out

    def sw_dir_cor(self, sun_position, sw_dir_cor_buffer=None):
        """Shortwave correction factor for one sun position
        (shadow.pyx:172-199; Mueller & Scherer 2005).  A NumPy
        ``sw_dir_cor_buffer`` is filled with it."""
        with span("hzt.terrain.query"):
            out = self._run(sun_position, "sw_dir_cor")
            if sw_dir_cor_buffer is not None:
                with span("hzt.terrain.readback"):
                    sw_dir_cor_buffer[:] = out.cpu().numpy()
            return out

    def shadow_batch(self, sun_positions):
        """Shadow masks (T, in0, in1) for a (T, 3) sun track in one
        sweep."""
        with span("hzt.terrain.query"):
            return self._run(sun_positions, "shadow")

    def sw_dir_cor_batch(self, sun_positions):
        """Correction factors (T, in0, in1) for a (T, 3) sun track in one
        sweep."""
        with span("hzt.terrain.query"):
            return self._run(sun_positions, "sw_dir_cor")

    def sw_dir_cor_soft(self, sun_position, elevation=None, soft_tau=1.0,
                        straight_through=True):
        """Differentiable shortwave correction factor (soft occlusion) of
        ``horayzon_tpu.shadow.Terrain.sw_dir_cor_soft`` on the fused sweep
        (``_soft_pallas``, ``horayzon_tpu/shadow.py:588-627``), or on the
        ``"sweep"`` and ``"scan"`` engines through the marching sweep, one
        sun at a time, with torch autograd (``_soft_sun_step``,
        ``:171-220``).

        The hard occlusion step becomes ``sigmoid(clearance / soft_tau)``
        (``soft_tau`` in metres of signed clearance).  With
        ``straight_through`` (default) the values equal :meth:`sw_dir_cor`
        bit for bit and only the gradient uses the sigmoid;
        ``straight_through=False`` gives the fully soft value.

        ``elevation``: the (H, W) outer heights to differentiate
        through, a tensor on the terrain's device (default: the stored
        heights); on a curved mesh the planarised lattice, of the shape of
        ``_z_outer``, not the mesh.  The ray origins ``z_inner + 0.05 *
        n_z`` of the swept block are rebuilt from it, so gradients flow
        through the clearance metric (K2-argmax and the winner-replay
        backward K4 on the card), the ray slopes and, on a planar grid, the
        sun vectors of the classification.  On a curved mesh the
        classification keeps each cell's heights and vectors at their
        :meth:`initialise` values, as the reference does
        (``horayzon_tpu/shadow.py:617-620``), and the metric is read back at
        the cells' nearest lattice cells (:meth:`at_cells`).  The result
        carries a ``grad_fn`` when ``elevation`` requires grad.  Single or
        batch sun positions, as :meth:`sw_dir_cor` and
        :meth:`sw_dir_cor_batch`."""
        sun_position = self._check(sun_position)
        single = sun_position.ndim == 1
        sp = np.atleast_2d(sun_position)
        z = self._z_outer if elevation is None else elevation
        if (not isinstance(z, torch.Tensor)
                or z.device != self._z_outer.device
                or tuple(z.shape) != tuple(self._z_outer.shape)):
            what = (" (the planarised lattice of the curved mesh)"
                    if self._curved else "")
            raise ValueError(f"elevation must be a tensor of shape "
                             f"{tuple(self._z_outer.shape)}{what} on "
                             f"{self._z_outer.device}")
        (o0, o1), (c0, c1) = self.offset, self.comp_shape
        z_inner_r = z[o0:o0 + c0, o1:o1 + c1]
        z_org_r = z_inner_r + _RAY_ORG_ELEV * self._fields["norm_r_z"]
        own = z is self._z_outer and not z.requires_grad
        if self.engine != "pallas":
            # both XLA engines take the marching sweep here, as the
            # reference's _soft_sun_step does
            levels = (self._levels if own
                      else _mip.padded_levels(z, self.schedule.pads))
            metric, near_vert = self._xla_metric(sp, z_org_r, z_inner_r,
                                                 levels)
        else:
            table, near_vert = _ss.shadow_sun_table(
                sp, self._center, self.grid.dx, self.grid.dy)
            metric = _ss.shadow_metric_fused(
                z, z_org_r, z_inner_r, table, offset=self.offset,
                inner_shape=self.comp_shape, dx=self.grid.dx,
                dy=self.grid.dy, grid_origin=self._grid_origin,
                hori_acc=self.acc, pyramid=self._levels if own else None,
                pooled=self._pooled if own else None)
        nv = torch.from_numpy(near_vert).to(metric.device)[:, None, None]
        occluded = self.at_cells((metric > 0.0) & ~nv)
        metric = self.at_cells(torch.where(nv, -1.0e30, metric))
        fields = (self._fields if self._curved
                  else dict(self._fields, z_org=z_org_r))
        out = _classify(fields, sp, occluded, mode="sw_dir_cor",
                        refrac_cor=self.refrac_cor, ang_max=self.ang_max,
                        metric=metric, soft_tau=soft_tau,
                        straight_through=straight_through)
        return out[0] if single else out
