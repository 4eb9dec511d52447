# Copyright (c) 2026
# MIT License
"""Horizon sweep for arbitrary point locations, in plain torch.

Counterpart of :mod:`horayzon_tpu.ops.locations` (the reference's
``horizon_locations_comp``, horizon_comp.cpp:828-1094), which runs in XLA
outside any Pallas kernel: batched gathers from the heightfield's max-mip
pyramid, shapes (L, A, M) per phase of the schedule, rather than the
shifted reads of the gridded sweep.  Every float32 operation is done in
the order the JAX source writes it, on the device of the heightfield; a
hand kernel is left for when it is measured faster.
"""

import math

import numpy as np
import torch

from horayzon_tpu_torch.ops import mip as _mip
from horayzon_tpu_torch.ops import sweep as _sweep
from horayzon_tpu_torch.ops.replay import sqrt_rn

_NEG = float(np.float32(-3.0e38))

#: Memory guard for the dense (L, A, M) phase temporaries, as the
#: reference's (``horayzon_tpu/ops/locations.py:30``): locations are
#: processed in chunks so that no gather array exceeds this many float32
#: elements (32 Mi elements = 128 MiB an array).
MAX_GATHER_ELEMS = 32 * 2 ** 20


def _f32(v):
    """A Python scalar rounded to float32, as XLA rounds a weak-typed
    constant against a float32 array."""
    return float(np.float32(v))


def _bilinear_gather(z, fi, fj):
    """Bilinear sample of the (H, W) tensor ``z`` at fractional indices
    (any shape), ``horayzon_tpu/ops/locations.py:33-46``."""
    h, w = z.shape
    i0 = torch.clamp(torch.floor(fi).to(torch.int32), 0, h - 2)
    j0 = torch.clamp(torch.floor(fj).to(torch.int32), 0, w - 2)
    wi = torch.clamp(fi - i0, 0.0, 1.0)
    wj = torch.clamp(fj - j0, 0.0, 1.0)
    i0, j0 = i0.long(), j0.long()
    v00 = z[i0, j0]
    v01 = z[i0, j0 + 1]
    v10 = z[i0 + 1, j0]
    v11 = z[i0 + 1, j0 + 1]
    top = (1 - wj) * v00 + wj * v01
    bot = (1 - wj) * v10 + wj * v11
    return (1 - wi) * top + wi * bot


def _locations_core(levels, s_phases, coords, basis, ray_org_elev, trig, *,
                    phases, grid_meta, elev_bounds):
    """The (L, A) horizon and distance of one chunk of locations
    (``horayzon_tpu/ops/locations.py:51-114``): per phase of the schedule
    the (L, A, M) samples, their elevation-angle ratios in each location's
    tangent frame, and the running maximum with the distance of its first
    winner."""
    x0, y0, dx, dy, h_num, w_num = grid_meta
    x0, y0 = _f32(x0), _f32(y0)
    # the spacings as tensors on the device: torch divides a CUDA tensor
    # by a Python scalar as a product with its reciprocal, which is not
    # the correctly rounded quotient that XLA and the CPU form
    dx, dy = (torch.tensor(_f32(v), device=coords.device) for v in (dx, dy))
    lo, hi = (_f32(v) for v in elev_bounds)
    sin_a, cos_a = trig               # (A,)
    east, north, norm = basis         # (L, 3) each

    # Per-(loc, azim) in-plane direction u and horizontal marching direction
    u3 = (sin_a[None, :, None] * east[:, None, :]
          + cos_a[None, :, None] * north[:, None, :])       # (L, A, 3)
    u_xy = u3[..., :2]
    mag = sqrt_rn(u_xy[..., 0:1] * u_xy[..., 0:1]
                  + u_xy[..., 1:2] * u_xy[..., 1:2])
    u_xy = u_xy / torch.clamp_min(mag, _f32(1e-12))

    # Observer surface elevation: heightfield sample at the location
    fi_loc = (coords[:, 1] - y0) / dy
    fj_loc = (coords[:, 0] - x0) / dx
    z_terr = _bilinear_gather(levels[0], fi_loc, fj_loc)    # (L,)
    z_org = z_terr + ray_org_elev * norm[:, 2]              # (L,)

    a_n = (u_xy[..., 0] * norm[:, None, 0]
           + u_xy[..., 1] * norm[:, None, 1])               # (L, A)
    a_u = u_xy[..., 0] * u3[..., 0] + u_xy[..., 1] * u3[..., 1]
    nz = norm[:, None, 2]
    uz = u3[..., 2]

    best_ratio = torch.full(u_xy.shape[:2], _NEG, dtype=torch.float32,
                            device=coords.device)
    best_s = torch.zeros(u_xy.shape[:2], dtype=torch.float32,
                         device=coords.device)
    i_lim, j_lim = _f32(h_num - 1.001), _f32(w_num - 1.001)
    eps = _f32(1e-6)
    for s, (_, level, *_rest) in zip(s_phases, phases):
        zl = levels[level]
        k = 2 ** level
        px = coords[:, None, None, 0] + s[None, None, :] * u_xy[..., 0:1]
        py = coords[:, None, None, 1] + s[None, None, :] * u_xy[..., 1:2]
        fi = (py - y0) / dy
        fj = (px - x0) / dx
        valid = ((fi >= 0.0) & (fi <= i_lim) & (fj >= 0.0) & (fj <= j_lim))
        if level == 0:
            h = _bilinear_gather(zl, fi, fj)
        else:
            hl, wl = zl.shape
            ii = torch.clamp(torch.div(torch.floor(fi).to(torch.int32), k,
                                       rounding_mode="floor"), 0, hl - 1)
            jj = torch.clamp(torch.div(torch.floor(fj).to(torch.int32), k,
                                       rounding_mode="floor"), 0, wl - 1)
            h = zl[ii.long(), jj.long()]
        dh = h - z_org[:, None, None]
        num = s[None, None, :] * a_n[..., None] + dh * nz[..., None]
        den = s[None, None, :] * a_u[..., None] + dh * uz[..., None]
        ratio = torch.where(
            den > eps, num / torch.clamp_min(den, eps),
            torch.where(num > 0.0, -_NEG, _NEG))
        ratio = torch.where(valid, ratio, _NEG)
        idx = torch.argmax(ratio, dim=-1)       # the first maximum
        r_max = torch.gather(ratio, -1, idx[..., None])[..., 0]
        s_max = s[idx]
        upd = r_max > best_ratio
        best_s = torch.where(upd, s_max, best_s)
        best_ratio = torch.maximum(best_ratio, r_max)

    # arctan and cos rounded once from float64, on the CPU and the card
    # alike (XLA's float32 ones are within an ulp of these)
    hori = torch.clamp(torch.atan(best_ratio.double()).float(), lo, hi)
    dist = best_s / torch.clamp_min(torch.cos(hori.double()).float(), eps)
    return hori, dist


def horizon_locations_sweep(z, grid, coords, vec_norm, vec_north, azim,
                            dist_search_m, hori_acc, elev_ang_low_lim,
                            ray_org_elev, elev_ang_up_lim=89.98,
                            rel_err=None):
    """Per-location horizon and distance to the horizon
    (``horayzon_tpu.ops.locations.horizon_locations_sweep``).

    ``z`` the (H, W) float32 heightfield tensor of the regular ``grid``
    (its device is where the sweep runs); ``coords`` (L, 3), ``vec_norm``
    and ``vec_north`` (L, 3) NumPy; ``azim`` (A,) [radian];
    ``ray_org_elev`` one value or L.  Locations are processed in chunks
    that keep every (L, A, M) gather within :data:`MAX_GATHER_ELEMS`, the
    tail chunk padded by repeating its last location.

    Returns (hori (L, A) float32 [radian], dist (L, A) float32 [metre]):
    ``dist`` is the distance to the winning sample over ``cos(hori)``, as
    the reference reports it (MIGRATION.md)."""
    z = torch.as_tensor(z).to(torch.float32)
    dev = z.device
    step = min(abs(grid.dx), abs(grid.dy))
    if rel_err is None:
        rel_err = _sweep.default_rel_err(hori_acc)
    schedule = _sweep.build_schedule(step, dist_search_m, rel_err)
    levels = _mip.build_pyramid(z, schedule.num_levels)

    def on_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)
                                ).to(dev)

    east = np.cross(vec_north, vec_norm)
    basis_np = tuple(np.asarray(b, dtype=np.float32)
                     for b in (east, vec_north, vec_norm))
    azim = np.asarray(azim, dtype=np.float64)
    trig = (on_dev(np.sin(azim)), on_dev(np.cos(azim)))
    h, w = z.shape
    s_phases = tuple(on_dev(s) for s in schedule.s_values)
    coords = np.asarray(coords, dtype=np.float32)
    ray_org_elev = np.atleast_1d(np.asarray(ray_org_elev, dtype=np.float32))
    kw = dict(phases=schedule.meta(),
              grid_meta=(grid.x0, grid.y0, grid.dx, grid.dy, h, w),
              elev_bounds=(math.radians(elev_ang_low_lim),
                           math.radians(elev_ang_up_lim)))

    num_loc = coords.shape[0]
    chunk = chunk_size(schedule, len(azim))
    if num_loc <= chunk:
        return _locations_core(levels, s_phases, on_dev(coords),
                               tuple(on_dev(b) for b in basis_np),
                               on_dev(ray_org_elev), trig, **kw)

    if len(ray_org_elev) == 1:
        ray_org_elev = np.repeat(ray_org_elev, num_loc)
    hori_parts, dist_parts = [], []
    for lo_i in range(0, num_loc, chunk):
        hi_i = min(lo_i + chunk, num_loc)
        pad = chunk - (hi_i - lo_i)

        def tail_pad(a):
            return np.concatenate(
                [a[lo_i:hi_i], np.repeat(a[hi_i - 1:hi_i], pad, axis=0)]) \
                if pad else a[lo_i:hi_i]

        hori_c, dist_c = _locations_core(
            levels, s_phases, on_dev(tail_pad(coords)),
            tuple(on_dev(tail_pad(b)) for b in basis_np),
            on_dev(tail_pad(ray_org_elev)), trig, **kw)
        hori_parts.append(hori_c[:hi_i - lo_i])
        dist_parts.append(dist_c[:hi_i - lo_i])
    return torch.cat(hori_parts, dim=0), torch.cat(dist_parts, dim=0)


def chunk_size(schedule, num_azim):
    """Locations per chunk of :func:`horizon_locations_sweep` for a sweep
    ``schedule`` (``sweep.build_schedule``) and ``num_azim`` azimuths."""
    m_max = max(len(s) for s in schedule.s_values)
    return max(1, MAX_GATHER_ELEMS // max(num_azim * m_max, 1))
