# Copyright (c) 2026
# MIT License
"""Shadow maps and shortwave-radiation correction factors in torch.

Counterpart of :mod:`horayzon_tpu.shadow` (the reference's
``horayzon/shadow.pyx`` + ``shadow_comp.cpp``): a :class:`Terrain` is
initialised once with the DEM and the per-cell vectors, then queried per
sun position or per sun track.  Ported: the regular planar grid
(``geom_type="grid"``), ``shadow``, ``sw_dir_cor`` and their ``*_batch``
forms, with or without refraction, with masks and fill values, and the
differentiable ``sw_dir_cor_soft``.  The occlusion test runs as one fused
sweep over the whole sun batch
(:func:`horayzon_tpu_torch.ops.shadow_sweep.shadow_metric_fused`: kernel K2
on a CUDA device, its plain torch version on the CPU), on the padded
max-mip pyramid and the pooled companions of its skips built once at
:meth:`Terrain.initialise`.  The queries only threshold the metric at 0,
so K2 runs its sign-exact skips there, as the reference's ``Terrain``
does; ``sw_dir_cor_soft`` takes the exact metric.  The per-cell
classification (:func:`_classify`) is elementwise torch on the same
device.  ``sw_dir_cor_soft`` runs the metric's gradient path (K2-argmax
and the winner-replay backward K4 on the card).  Curved (irregular) meshes
and the XLA engines are not ported yet and raise ``NotImplementedError``
naming their item in ROADMAP.md's Queue 1.
"""

import math

import numpy as np
import torch

from horayzon_tpu_torch import terrain as _terrain
from horayzon_tpu_torch.ops import fused_sweep as _fused
from horayzon_tpu_torch.ops import mip as _mip
from horayzon_tpu_torch.ops import refraction as _refraction
from horayzon_tpu_torch.ops import shadow_sweep as _ss

_RAY_ORG_ELEV = 0.05  # hard-coded lift of the ray origin [m]
                      # (shadow_comp.cpp:388,497)


def _not_ported(what, item):
    return NotImplementedError(
        f"shadow.Terrain: {what} is not ported to horayzon_tpu_torch yet "
        f"(ROADMAP.md Queue 1, item {item})")


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
    dot_ns, dot_ts = sun_dots(fields, sun_positions, refrac_cor)
    mask = fields["mask"]
    if mode == "shadow":
        def u8(v):
            return torch.tensor(v, dtype=torch.uint8, device=mask.device)
        code = torch.where(dot_ts > 0.0,
                           torch.where(occluded, u8(2), u8(0)), u8(1))
        return torch.where(mask, code, u8(3))
    dot_min = float(np.float32(math.cos(math.radians(ang_max))))
    val = (dot_ts / torch.clamp_min(dot_ns, dot_min)) \
        * fields["surf_enl_fac"]
    if metric is not None and soft_tau is not None:
        occ_soft = torch.sigmoid(metric / float(np.float32(soft_tau)))
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
        and "scan" are not ported yet.  The inner block is swept as it is
        (one kernel thread per (cell, sun)), so it needs no room to pad to
        tile multiples."""
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
        if engine in ("sweep", "scan"):
            raise _not_ported(f"engine={engine!r}", 10)

        x, y, z = _terrain.decompose_vert_grid(_numpy(vert_grid), dem_dim_0,
                                               dem_dim_1)
        grid = _terrain.detect_regular_grid(x, y)
        if grid is None:
            raise _not_ported("a curved (irregular) mesh, which needs "
                              "regrid.planarize,", 7)
        in0, in1 = shp
        dev = torch.device(device)
        self.device = dev
        self.inner_shape = (in0, in1)
        self.ang_max = float(ang_max)
        self.refrac_cor = bool(refrac_cor)
        self.acc = float(acc)
        self.grid = grid
        self.offset = (int(offset_0), int(offset_1))
        self.comp_shape = (in0, in1)

        sl_in = (slice(offset_0, offset_0 + in0),
                 slice(offset_1, offset_1 + in1))
        x_in = x[sl_in].astype(np.float32)
        y_in = y[sl_in].astype(np.float32)
        z_in = z[sl_in].astype(np.float32)
        z_org = z_in + _RAY_ORG_ELEV * vec_norm[..., 2]

        # Sun directions are taken from the domain centre
        # (horayzon_tpu/shadow.py:372-375)
        x_axis = grid.x_axis()
        y_axis = grid.y_axis()
        self._center = (float(0.5 * (x_axis[0] + x_axis[-1])),
                        float(0.5 * (y_axis[0] + y_axis[-1])))
        self._grid_origin = (float(grid.x0), float(grid.y0))

        # Initialise-once: the padded max-mip pyramid of the outer grid
        # (the reference builds its BVH once here, shadow_comp.cpp:318-380)
        self._z_outer = torch.from_numpy(
            np.ascontiguousarray(z, dtype=np.float32)).to(dev)
        self.plan = _ss.plan_shadow(tuple(self._z_outer.shape),
                                    inner_shape=self.comp_shape,
                                    offset=self.offset, dx=grid.dx,
                                    dy=grid.dy, hori_acc=self.acc)
        self._levels = _mip.padded_levels(self._z_outer, self.plan["pads"])
        # and the pooled companions behind K2's skips (the reference keeps
        # them as _pallas_pooled)
        self._pooled = _fused.skip_inputs(self._levels, self.plan)

        def on_dev(a, dtype=torch.float32):
            return torch.from_numpy(np.ascontiguousarray(a)).to(
                device=dev, dtype=dtype)

        self._fields = {
            "x_in": on_dev(x_in), "y_in": on_dev(y_in),
            "z_org": on_dev(z_org), "z_inner": on_dev(z_in),
            "norm": on_dev(vec_norm), "tilt": on_dev(vec_tilt),
            "surf_enl_fac": on_dev(surf_enl_fac),
            "elevation": on_dev(elevation),
            "mask": on_dev(mask == 1, torch.bool),
            "sw_dir_cor_fill": float(np.float32(sw_dir_cor_fill)),
        }
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
        """The occlusion metric (T, in0, in1) for a (T, 3) sun track and
        the (T,) near-vertical flags of the sun table (the sun straight
        above the domain centre: no horizontal marching direction).  The
        queries only threshold it at 0, so on the card K2 runs its
        sign-exact arm (``exact_metric=False``, as
        ``horayzon_tpu/shadow.py:494-505`` asks): the sign is exact, the
        value is not.  ``plain``: the plain torch sweep (the exact metric)
        on the terrain's device in place of kernel K2."""
        table, near_vert = _ss.shadow_sun_table(
            sun_positions, self._center, self.grid.dx, self.grid.dy)
        f = self._fields
        kw = dict(offset=self.offset, inner_shape=self.comp_shape,
                  dx=self.grid.dx, dy=self.grid.dy,
                  grid_origin=self._grid_origin, hori_acc=self.acc,
                  pyramid=self._levels)
        if plain:
            metric = _ss.shadow_metric_plain(self._z_outer, f["z_org"],
                                             f["z_inner"], table, **kw)
        else:
            metric = _ss.shadow_metric_fused(
                self._z_outer, f["z_org"], f["z_inner"], table,
                pooled=self._pooled, exact_metric=False, **kw)
        return metric, near_vert

    def _run(self, sun_position, mode, plain=False):
        """Batched occlusion through the fused sweep, then classification
        (``horayzon_tpu.shadow.Terrain._run_pallas``)."""
        sun_position = self._check(sun_position)
        single = sun_position.ndim == 1
        sp = np.atleast_2d(sun_position)
        metric, near_vert = self._metric(sp, plain)
        lit = ~torch.from_numpy(near_vert).to(metric.device)
        occluded = (metric > 0.0) & lit[:, None, None]
        out = _classify(self._fields, sp, occluded, mode=mode,
                        refrac_cor=self.refrac_cor, ang_max=self.ang_max)
        return out[0] if single else out

    # ------------------------------------------------------------------
    def shadow(self, sun_position, shadow_buffer=None):
        """Shadow mask for one sun position (shadow.pyx:149-170): uint8,
        0 illuminated, 1 self-shaded, 2 terrain-shaded, 3 masked.  A NumPy
        ``shadow_buffer`` is filled with it."""
        out = self._run(sun_position, "shadow")
        if shadow_buffer is not None:
            shadow_buffer[:] = out.cpu().numpy()
        return out

    def sw_dir_cor(self, sun_position, sw_dir_cor_buffer=None):
        """Shortwave correction factor for one sun position
        (shadow.pyx:172-199; Mueller & Scherer 2005).  A NumPy
        ``sw_dir_cor_buffer`` is filled with it."""
        out = self._run(sun_position, "sw_dir_cor")
        if sw_dir_cor_buffer is not None:
            sw_dir_cor_buffer[:] = out.cpu().numpy()
        return out

    def shadow_batch(self, sun_positions):
        """Shadow masks (T, in0, in1) for a (T, 3) sun track in one
        sweep."""
        return self._run(sun_positions, "shadow")

    def sw_dir_cor_batch(self, sun_positions):
        """Correction factors (T, in0, in1) for a (T, 3) sun track in one
        sweep."""
        return self._run(sun_positions, "sw_dir_cor")

    def sw_dir_cor_soft(self, sun_position, elevation=None, soft_tau=1.0,
                        straight_through=True):
        """Differentiable shortwave correction factor (soft occlusion) of
        ``horayzon_tpu.shadow.Terrain.sw_dir_cor_soft`` on the fused sweep
        (``_soft_pallas``, ``horayzon_tpu/shadow.py:588-627``).

        The hard occlusion step becomes ``sigmoid(clearance / soft_tau)``
        (``soft_tau`` in metres of signed clearance).  With
        ``straight_through`` (default) the values equal :meth:`sw_dir_cor`
        bit for bit and only the gradient uses the sigmoid;
        ``straight_through=False`` gives the fully soft value.

        ``elevation``: the (H, W) outer lattice heights to differentiate
        through, a tensor on the terrain's device (default: the stored
        heights).  The ray origins ``z_inner + 0.05 * vec_norm_z`` are
        rebuilt from it, so gradients flow through the clearance metric
        (K2-argmax and the winner-replay backward K4 on the card), the ray
        slopes and the sun vectors of the classification.  The result
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
            raise ValueError(f"elevation must be a tensor of shape "
                             f"{tuple(self._z_outer.shape)} on "
                             f"{self._z_outer.device}")
        (o0, o1), (c0, c1) = self.offset, self.comp_shape
        z_inner = z[o0:o0 + c0, o1:o1 + c1]
        z_org = z_inner + _RAY_ORG_ELEV * self._fields["norm"][..., 2]
        table, near_vert = _ss.shadow_sun_table(
            sp, self._center, self.grid.dx, self.grid.dy)
        own = z is self._z_outer and not z.requires_grad
        metric = _ss.shadow_metric_fused(
            z, z_org, z_inner, table, offset=self.offset,
            inner_shape=self.comp_shape, dx=self.grid.dx, dy=self.grid.dy,
            grid_origin=self._grid_origin, hori_acc=self.acc,
            pyramid=self._levels if own else None,
            pooled=self._pooled if own else None)
        nv = torch.from_numpy(near_vert).to(metric.device)[:, None, None]
        occluded = (metric > 0.0) & ~nv
        metric = torch.where(nv, -1.0e30, metric)
        out = _classify(dict(self._fields, z_org=z_org), sp, occluded,
                        mode="sw_dir_cor", refrac_cor=self.refrac_cor,
                        ang_max=self.ang_max, metric=metric,
                        soft_tau=soft_tau,
                        straight_through=straight_through)
        return out[0] if single else out
