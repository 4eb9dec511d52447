# Copyright (c) 2026
# MIT License
"""Public horizon API: the counterpart of :mod:`horayzon_tpu.horizon`.

``horizon_gridded`` keeps the reference's signature (plus ``device``) and
its validation, and runs the planar, unmasked, default-vector branch
through :func:`horayzon_tpu_torch.ops.fused_sweep.horizon_sweep_fused`.
The other branches are not ported yet and raise ``NotImplementedError``
naming their item in ROADMAP.md's Queue 1.  One thread owns one
(cell, azimuth) in the kernel, so the inner domain is swept as it is, with
no padding to tile multiples.
"""

import time

import numpy as np
import torch

from horayzon_tpu_torch import terrain as _terrain
from horayzon_tpu_torch.ops import fused_sweep as _fused

_VALID_ALGOS = ("discrete_sampling", "binary_search", "guess_constant",
                "sweep")
_VALID_GEOM = ("triangle", "quad", "grid")


def azimuth_angles(azim_num):
    """Azimuth angles [radian], clockwise from North (horizon.pyx:190-196)."""
    return ((2.0 * np.pi) / azim_num * np.arange(azim_num)).astype(np.float32)


def _not_ported(what, item):
    return NotImplementedError(
        f"horizon_gridded: {what} is not ported to horayzon_tpu_torch yet "
        f"(ROADMAP.md Queue 1, item {item})")


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
    the CPU the plain torch sweep.  ``engine``
    "auto" and "pallas" both select the fused sweep; the XLA-style "sweep"
    engine is not ported.  ``hori_fill`` applies to masked cells, and masks
    with zeros are not ported yet.

    Returns
    -------
    hori : tensor of float32, shape (in0, in1, azim_num) [radian], on
        ``device``
    azim : tensor of float32, shape (azim_num,) [radian], on ``device``
    """
    if engine not in ("auto", "sweep", "pallas"):
        raise ValueError("engine must be 'auto', 'sweep' or 'pallas'")
    # --- Validation (mirrors horizon.pyx:109-156) -------------------------
    vec_norm = np.asarray(vec_norm, dtype=np.float32)
    vec_north = np.asarray(vec_north, dtype=np.float32)
    if ((offset_0 + vec_norm.shape[0] > dem_dim_0)
            or (offset_1 + vec_norm.shape[1] > dem_dim_1)):
        raise ValueError("inconsistency between input arguments dem_dim_0, "
                         "dem_dim_1, offset_0, offset_1 and vec_norm")
    if vec_norm.size == 0:
        raise ValueError(
            "inner domain is empty (vec_norm has zero size) — the outer "
            "DEM is not larger than twice the search distance; widen the "
            "domain or reduce dist_search")
    if ((vec_norm.ndim != 3) or (vec_north.ndim != 3)
            or (vec_norm.shape != vec_north.shape)):
        raise ValueError("dimension (lengths) of vec_norm and/or vec_north "
                         "is/are erroneous")
    if ray_algorithm not in _VALID_ALGOS:
        raise ValueError("invalid input argument for ray_algorithm")
    if geom_type not in _VALID_GEOM:
        raise ValueError("invalid input argument for geom_type")
    if hori_acc > 10.0:
        raise ValueError("limit of hori_acc (10 degree) is exceeded")
    if mask is None:
        mask = np.ones((vec_norm.shape[0], vec_norm.shape[1]), dtype=np.uint8)
    mask = np.asarray(mask)
    if mask.shape != vec_norm.shape[:2]:
        raise ValueError("shape of mask is inconsistent with other input")
    if mask.dtype != np.uint8:
        raise TypeError("data type of mask must be 'uint8'")
    if ray_org_elev < 0.005:
        raise TypeError("minimal allowed value for 'ray_org_elev' is 0.005 m")

    x, y, z = _terrain.decompose_vert_grid(vert_grid, dem_dim_0, dem_dim_1)
    grid = _terrain.detect_regular_grid(x, y)
    inner_shape = (vec_norm.shape[0], vec_norm.shape[1])
    azim = azimuth_angles(azim_num)

    if (vert_simp is None) != (tri_ind_simp is None):
        raise ValueError("vert_simp and tri_ind_simp must be provided "
                         "together")
    if vert_simp is not None:
        raise _not_ported("the simplified outer TIN (vert_simp)", 11)
    if grid is None:
        raise _not_ported("a curved (irregular) grid", 7)
    if not _terrain.is_default_planar_vectors(vec_norm, vec_north):
        raise _not_ported("non-default vec_norm/vec_north", 10)
    if mask.min() == 0:
        raise _not_ported("a mask with zeros", 5)
    if engine == "sweep":
        raise _not_ported("engine='sweep'", 10)

    t0 = time.perf_counter()
    z_dev = torch.from_numpy(np.ascontiguousarray(z)).to(device)
    hori = _fused.horizon_sweep_fused(
        z_dev, dx=grid.dx, dy=grid.dy, offset=(offset_0, offset_1),
        inner_shape=inner_shape, azim_num=azim_num,
        dist_search=dist_search * 1000.0, hori_acc=hori_acc,
        elev_ang_low_lim=elev_ang_low_lim, ray_org_elev=ray_org_elev)
    if verbose:
        if hori.is_cuda:
            torch.cuda.synchronize(hori.device)
        dt = time.perf_counter() - t0
        print(f"Horizon sweep: {inner_shape[0]}x{inner_shape[1]} cells, "
              f"{azim_num} azimuths, {dt:.3f} s "
              f"(incl. kernel build on first call)")
        # considered-fraction printout mirrors horizon_comp.cpp:685-695
        print(f"Number of grid cells for which horizon is computed: "
              f"{mask.size} (100.00 % of the domain)")
    return hori, torch.from_numpy(azim).to(device)
