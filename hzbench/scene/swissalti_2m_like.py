"""The scene of the swissALTI3D 2 m deployment with a simplified outer TIN
(upstream ``examples/horizon/gridded_planar_DEM_2m.py``): a 2 m fine grid
around the inner domain and a TIN of the outer domain as the far field.

The terrain is the synthetic model of ``examples/torch/horizon/
gridded_planar_dem_2m.py:85-105`` at commit 87af39b: gaussian bumps over
the coarse extent (the fine grid plus the search distance on each side,
in cells of ``coarse_ratio`` fine cells; centres uniform over it, sigma
uniform from ``sigma_min_cells`` to the extent over
``sigma_max_divisor``, amplitudes uniform in ``amp_m``); the fine grid is
the coarse window under it, each coarse cell repeated ``coarse_ratio``
times along each axis, plus ``noise_m`` times standard normal noise.  The
bumps are drawn from the seed and the DEM's number, evaluated on the
device in float64, and the noise is drawn there by a generator seeded
from both.

The TIN stands in for ``hmm``'s output: a regular one through the same
bumps (no noise) at ``tin.spacing_m`` vertex spacing, two triangles a
quad, over the fine grid's extent plus ``tin.margin_km`` on each side,
made on the device.  Its density is chosen, not derived from an error
budget (the configuration's ``assumed``).

The scene: ``x``, ``y`` (float32 axes of the fine grid's cell centres, y
descending, as LV95 from the fine grid's south-west ``corner``), ``z``
the (H, W) float32 fine grid on the device, ``vert_simp`` (flat float32
x, y, z) and ``tri_ind_simp`` (flat int32) on the device, ``domain``
(the inner cells' centres, as ``PlanarPipeline`` slices them),
``offset`` and ``inner_shape`` of the inner block, ``dx``, ``dy``, and
the configuration's sweep settings.
"""

import math

import numpy as np
import torch

from hzbench import scenes


def _bumps(cfg, seed, dem, n_coarse):
    """(centre row, centre column, sigma, amplitude) of each bump, in
    coarse cells and metres."""
    b = cfg["bumps"]
    rng = scenes.rng_for(seed, 0, dem)
    n = int(b["count"])
    cy = rng.uniform(0.0, n_coarse, n)
    cx = rng.uniform(0.0, n_coarse, n)
    sig = rng.uniform(float(b["sigma_min_cells"]),
                      n_coarse / float(b["sigma_max_divisor"]), n)
    amp = rng.uniform(*b["amp_m"], n)
    return cy, cx, sig, amp


def _height(bumps, rows, cols):
    """The bumps' sum at coarse coordinates ``rows``, ``cols`` (float64
    tensors of one shape)."""
    z = torch.zeros_like(rows)
    for cy, cx, sig, amp in zip(*bumps):
        z += float(amp) * torch.exp(-(((rows - float(cy)) ** 2
                                       + (cols - float(cx)) ** 2)
                                      / (2.0 * float(sig) ** 2)))
    return z


def make(cfg, seed, device, dem=0):
    dx = float(cfg["dx"])
    r = int(cfg["bumps"]["coarse_ratio"])
    n_in, halo = int(cfg["inner_cells"]), int(cfg["halo_cells"])
    n_fine = n_in + 2 * halo
    if n_fine % r:
        raise ValueError("the fine grid must hold whole coarse cells")
    dist_m = float(cfg["dist_search_km"]) * 1000.0
    n_coarse = int(math.ceil((n_fine * dx + 2.0 * dist_m) / (r * dx)))
    fo_c = (n_coarse - n_fine // r) // 2
    bumps = _bumps(cfg, seed, dem, n_coarse)
    f64 = dict(dtype=torch.float64, device=device)

    # the coarse window under the fine grid, repeated, plus the noise
    q = torch.arange(fo_c, fo_c + n_fine // r, **f64)
    window = _height(bumps, q[:, None].expand(-1, q.numel()),
                     q[None, :].expand(q.numel(), -1)).to(torch.float32)
    z = window.repeat_interleave(r, 0).repeat_interleave(r, 1)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(scenes.rng_for(seed, 5, dem).integers(2 ** 62)))
    noise = torch.randn(z.shape, generator=gen, dtype=torch.float32,
                        device=device)
    z = z + float(cfg["bumps"]["noise_m"]) * noise

    # cell centres; coarse coordinate c of a point: its coarse cell's
    # centre lies at the integer c, cell fo_c over fine cells [0, r)
    x0, y0 = float(cfg["corner"]["x"]), float(cfg["corner"]["y"])
    y_top = y0 + n_fine * dx
    k = np.arange(n_fine, dtype=np.float64)
    x = (x0 + (k + 0.5) * dx).astype(np.float32)
    y = (y_top - (k + 0.5) * dx).astype(np.float32)

    # the TIN: vertices every spacing over the extent plus the margin
    t = cfg["tin"]
    step = float(t["spacing_m"])
    margin = float(t["margin_km"]) * 1000.0
    nv = int(math.ceil((n_fine * dx + 2.0 * margin) / step)) + 1
    s = torch.arange(nv, **f64) * step
    vx = (x0 - margin) + s
    vy = (y_top + margin) - s
    rows = ((y_top - vy) / (r * dx) + fo_c - 0.5)[:, None].expand(-1, nv)
    cols = ((vx - x0) / (r * dx) + fo_c - 0.5)[None, :].expand(nv, -1)
    vz = _height(bumps, rows, cols)
    verts = torch.stack([vx[None, :].expand(nv, -1),
                         vy[:, None].expand(-1, nv), vz], dim=-1)
    ii, jj = torch.meshgrid(torch.arange(nv - 1, device=device),
                            torch.arange(nv - 1, device=device),
                            indexing="ij")
    a = (ii * nv + jj).reshape(-1)
    tris = torch.cat([torch.stack([a, a + 1, a + nv], -1),
                      torch.stack([a + 1, a + nv + 1, a + nv], -1)])

    domain = {"x_min": float(x[halo]), "x_max": float(x[halo + n_in - 1]),
              "y_min": float(y[halo + n_in - 1]), "y_max": float(y[halo])}
    return dict(z=z.contiguous(), x=x, y=y, dx=float(x[1] - x[0]),
                dy=float(y[1] - y[0]),
                vert_simp=verts.reshape(-1).to(torch.float32),
                tri_ind_simp=tris.reshape(-1).to(torch.int32),
                domain=domain, offset=(halo, halo), inner_shape=(n_in, n_in),
                dist_search_km=float(cfg["dist_search_km"]),
                dist_search_m=dist_m, azim_num=int(cfg["azim_num"]),
                hori_acc=float(cfg["hori_acc"]),
                elev_ang_low_lim=float(cfg["elev_ang_low_lim"]))
