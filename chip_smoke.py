#!/usr/bin/env python3
# Copyright (c) 2026
# MIT License
"""Smoke run of horayzon_tpu_torch on one CUDA card (an H100).

    python3 chip_smoke.py

Phases, each of which ends the run with a nonzero exit on failure:

1. environment: torch, CUDA, the card, its name and power limit;
2. build: kernels K1 and K2 with their argmax variants
   (csrc/horizon_sweep.cu, one template), K3 and K4
   (csrc/horizon_replay_bwd.cu, one template) and K5 (csrc/read_floor.cu),
   one nvcc each for sm_90a, in parallel;
3. K1 against its plain torch version on the card, on three small cases;
4. the main path, ``PlanarPipeline.run`` at the bench headline shape
   (25 m grid, 2048^2 outer, 1024^2 inner, 32 azimuths, 20 km search),
   timed with CUDA events, with output checks and a cropped comparison
   against the plain version; then K1 and the plain sweep timed alone;
5. K1's argmax variant and K3 against their plain versions on the small
   cases, one whose d1 range ends in a single step and a contention scene
   (a tall spike at the centre of a flat 256^2 grid, whose winners crowd
   onto a few cells); K3 run twice, bit-equal to its plain version and
   across the runs, each level's fixed-point words and precision bound
   printed;
6. the gradient path at the bench's gradient row (``bench.py:470-486``):
   forward and loss + ``backward()`` timed, the gradient checked and
   compared across two runs; K1-argmax and K3 timed alone against their
   plain versions;
7. a central finite-difference check of the gradient on the card;
8. the trainer: ``TerrainFit`` at the defaults of
   ``examples/horizon/terrain_fit_gradient.py``, held to its checks;
A. K2 (the shadow sweep, with its value-exact skips) against its plain
   torch version on the card, bit-equal, on the small cases of
   ``tests/test_torch_shadow.py``; K2 with its sign-exact arm bit-equal to
   the plain sweep that skips where the plain model of its votes does
   (``shadow_sweep.metric_model``), with the exact metric's sign;
B. the bench's shadow row (``bench.py:420-446``): K2 alone at the 2048^2 /
   1024^2 shape with a 16-sun track, timed with CUDA events, and the plain
   version once on the same inputs, bit-equal on the full output; the
   share of samples K2's skips pass over (its counters beside the plain
   model's, which they must equal);
C. the shadow main path, ``shadow.Terrain`` at the defaults of
   ``examples/shadow/gridded_planar_dem_artificial.py`` (hemisphere, 800^2
   at 100 m, 600^2 inner, 181 suns at 30 degrees): ``sw_dir_cor_batch`` and
   ``shadow_batch`` (K2 sign-exact) timed and held to the example's
   analytic check, the codes of all 181 suns against those from the plain
   exact metric; K2 alone on the 181 suns, sign-exact and exact, each
   bit-equal to its plain model, with its skip shares;
D. K2-argmax and the shadow replay K4 against their plain versions on
   phase A's cases (K4 run twice), bit-equal;
E. the bench's shadow-gradient row (``bench.py:521-543``): loss
   ``mean(sigmoid(metric / 2))`` at phase B's shape and track, forward and
   loss + ``backward()`` timed, ``z.grad`` checked and compared across two
   runs; K2-argmax (with its skip shares) and K4 timed alone against their
   plain versions;
F. the shadow gradient's main path, ``Terrain.sw_dir_cor_soft`` on phase
   C's terrain and 181 suns: the straight-through value against
   ``sw_dir_cor_batch``, ``mean().backward()`` timed, peak memory,
   K2-argmax (with its skip shares) and K4 alone on the 181-sun record,
   K2-argmax and K4 against their plain versions on 4 suns, then the kink
   and central-difference check of ``tests/test_grad.py:155-210`` on a
   small case;
G. K1's mask and tilt-ramp variants (tilt, mask, both; plain and argmax)
   against their plain versions on phase 5's cases, bit-equal; an
   all-masked mask (no launch); a scattered mask that leaves whole blocks
   unlaunched (their pre-filled values); the z and ramp gradients through
   the ramp and a mask against the plain path, and central differences;
H. masked planar runs at the bench shape: ``horizon_gridded(mask=...,
   hori_fill=-9)`` with the three masks of ``bench.py:377-397`` (a disc of
   20% considered, the island, scattered patches), wall time (median of 5
   after a warm-up) and speedup over the dense run, unmasked cells
   bit-equal to it; K1-mask alone and its plain version on the island;
I. curved: ``bench.py:60-197``'s curved masked scene (1024^2 lon/lat at
   3 arcsec on the sphere, 512^2 inner, 10 km, the 8% island) dense and
   masked through ``horizon_gridded`` (one run each: each planarises the
   mesh on the host), unmasked cells bit-equal, the lattice sweeps timed
   alone; then ``CurvedPipeline.run`` at the defaults of
   ``examples/horizon/gridded_curved_dem.py`` (900^2 at 0.0009 degree,
   WGS84, 20 km, 120 azimuths) with its wall split into host
   planarisation, K1-tilt and read-back, SVF range and peak memory;
   K1-tilt against its plain version there;
J. K5, the read floor (csrc/read_floor.cu): every mode and source against
   its plain version on a small window, bit-equal; then its own main path,
   ``read_floor.time_modes`` (what ``tools/read_floor_torch.py`` runs), at
   K1's bench cell (1024^2 cells, 32 first-quadrant directions, 246 steps)
   on a 2048^2 and a 5120^2 window, one line per mode and window, and
   ``stream`` alone on a 16384^2 window (1 GiB: device memory's read rate);
   the ``bilinear`` L2 mode against its plain version at the bench window;
K. multires: on two small scenes K1, K1-argmax and K3 over the combined
   fine + coarse pyramid against their plain versions (bit-equal, K3 also
   across two runs) and both gradients against the
   CPU path; then ``horizon_sweep_multires_fused`` at the defaults of
   ``examples/horizon/gridded_planar_dem_2m.py`` (2 m grid, fine 5120^2,
   inner 1024^2, 20 km, 60 azimuths, ratio 16): wall, K1 alone, range
   checks, peak memory; on a 128^2 crop of that pyramid (every sixth
   azimuth) K1's run and a K1-argmax launch bit-equal to the plain argmax
   sweep, and K3 on the crop's winners bit-equal to the plain backward
   over the eight combined levels and across two runs; the
   gradient step ``mean(h^2).backward()`` timed, both gradients finite,
   nonzero and equal across two runs; ``horizon_gridded(vert_simp=...)``
   once on a mid-size scene against the full-resolution run;
L. curved shadows: ``shadow.Terrain`` at the defaults of
   ``examples/shadow/gridded_curved_dem_srtm.py`` (700^2 lon/lat at 0.0012
   degree around (-36.3, -54.35), WGS84, 20 bumps, the inner domain 0.2
   degree in from each side in lon and 0.15 in lat, ``slope_vector_meth``
   tilt on the card, refraction, 25 hourly suns of 2026-01-15): initialise
   wall split into host planarisation and the rest, ``sw_dir_cor_batch``
   and ``shadow_batch`` (K2 sign-exact over the lattice box, read back at
   the cells) median of 3, peak memory, the codes of all 25 suns equal to
   those from the plain exact metric, K2 alone with its skip counters
   equal to the plain model's, ``sw_dir_cor_soft`` + ``backward()`` timed
   (straight-through value bit-equal, the lattice gradient finite,
   nonzero and bit-equal across runs), K2-argmax and K4 on 4 suns
   bit-equal to their plain versions;
M. per-location horizons: ``horizon_locations`` at the defaults of
   ``examples/horizon/locations_curved_dem.py`` (700^2 at 0.0012 degree
   around (8, 46.5), WGS84, 25 bumps, its 3 named locations, 20 km, 360
   azimuths, ``hori_dist_out``), then at 10,000 locations drawn (seed 0)
   from the inner 0.3 degree: wall split into planarisation and sweep,
   chunks, peak memory, 64 of them against the CPU path;
N. the reference's XLA engines, plain torch on the card by design:
   ``horizon_gridded`` with non-default vectors (``vec_norm`` from the
   terrain's own slope, ``vec_north`` orthogonal to it: the general
   per-cell basis) at the bench cell, wall, azimuth chunk and peak memory,
   and the same call on a 64^2 block on the card and the CPU; the planar
   ``engine="sweep"`` at the same cell beside the fused route and the
   largest angle between the two estimators; ``Terrain(engine="sweep")``
   and ``Terrain(engine="scan")`` on the bench's shadow row (16 suns) with
   the wall per sun and the share of codes equal to the fused engine's,
   both engines on a 512^2 crop on the card and the CPU; the XLA
   ``horizon_sweep_multires`` at phase K's 2 m scene beside
   ``horizon_sweep_multires_fused``; then K2-mask
   (``shadow_metric_fused(mask=...)``) on phase H's island and disc over
   the 16 suns, both arms: live blocks bit-equal to the dense K2, the rest
   -3e38, bit-equal to its plain version on the island, its time against
   the dense K2 (CUDA events, mean of 10) and its skip shares and bound;
O. sharded (``horayzon_tpu_torch.parallel``), the shards of a mesh of
   ``cuda:0`` slots run in turn on the card: the main path, with the shard
   counts, is ``horizon_sweep_fused_sharded`` at the bench cell and its
   gradient row on a (4, 2) mesh, ``shadow_metric_fused_sharded`` at row
   B and its gradient on (8, 1), ``horizon_sweep_multires_fused_sharded``
   at phase K's 2 m cell on (4, 2); each bit-equal to its single-device
   call (angles, metric, gradients), K3's and K4's shard variants
   bit-equal to the single K3 / K4 on the same record; the summed shards'
   times beside the single launch's (CUDA events), the fine bytes a
   multires tile holds beside the replicated levels; the two sharded XLA
   engines on a 256^2 crop equal to their single-device calls; then two
   processes (``--pair-worker``, gloo, a (2, 2) mesh on ``cuda:0``),
   each holding one tile's slots, the assembled angles and gradient
   bit-equal to the single launch (NCCL needs a card per process and is
   not exercised);
P. streaming, profiling and the example workflows
   (``horayzon_tpu_torch.utils``, ``examples/torch/``): the main path,
   with K1's count, is ``TiledHorizonRunner.run`` at the bench cell in
   four 512^2 tiles on the fused route, each tile bit-equal to
   ``horizon_sweep_fused`` on the tile and the cube against the single
   launch, then a kill in the second tile and a resume; with K2's count,
   ``SunTrackRunner.run`` at phase C's 181 suns in chunks of 32,
   bit-equal to one ``sw_dir_cor_batch`` call, then a kill and a resume;
   ``profiling.time_sweep`` on K1 at the bench cell beside phase 4's CUDA
   events, and one ``profiler_trace``; then the port's versions of four
   workflows no other phase runs and ``examples/torch/verify_drive.py``,
   each a subprocess at its defaults that must exit 0 with its printed
   checks met.  Tiles, chunks, the trace and the outputs go to the
   gitignored ``build/smoke_p/`` and are deleted;
9. one JSON line of all fourteen kernels (launches on its main path,
   error against its plain version, its time and the plain version's,
   its bound and ``library_ms`` null; the four shard rows ``*-shard``:
   launches on phase O's path, error against the single launch, the
   summed shards' time, the single launch's as ``single_ms``, its plain
   version and bound; K1 and K2 also ``launches_by_path``, with phase
   P's runners), then the result line
   ``{"ok": true, "device": {...}}``.  K5 is on no user path of the
   library: its launches are those of its own entry, the timing run of
   phase J.

Phases 4, 6, H, I and K also launch K1 (or K1-argmax) once with its
counters set and print the share of samples its value-exact skips passed
over, per section, and its time beside two bounds: that of the work this
run's data needs (the samples taken, from the counters, with the skip
tests; the ``bound_ms`` of the ``kernels`` line) and the full schedule's
(``skip_report``); phases B, C, E and F do the same for K2 and K2-argmax,
beside the plain model's counts.

TF32 is switched off for matmuls and cuDNN, so nothing here runs in
reduced precision.  Imports nothing of JAX.
"""

import json
import os
import shutil
import socket
import subprocess
import sys
import time

import numpy as np
import torch

from horayzon_tpu_torch import (auxiliary, direction, horizon, parallel,
                                regrid, shadow, sun_position, topo_param,
                                transform)
from horayzon_tpu_torch.models import (CurvedPipeline, PlanarPipeline,
                                       terrain_fit)
from horayzon_tpu_torch.ops import _build, fused_sweep, locations, mip
from horayzon_tpu_torch.ops import multires, read_floor, replay
from horayzon_tpu_torch.ops import shadow_sweep, sweep
from horayzon_tpu_torch.parallel import shard
from horayzon_tpu_torch.utils import profiling, streaming

#: Horizon-angle tolerance [rad] of K1 against the plain version.
TOL = 1.0e-5
#: Gradients on the card against the CPU path, relative to max |.| of each
#: (the arctan chain around the replay may differ by an ulp).  K3 and K4
#: themselves are bit-equal to their plain versions: both round the same
#: terms to the same fixed-point grid and sum them exactly.
BWD_RTOL = 1.0e-5
KERNEL_SOURCE = "horayzon_tpu_torch/csrc/horizon_sweep.cu"
REPLACES = "horayzon_tpu/ops/pallas_sweep.py:157"
BWD_SOURCE = "horayzon_tpu_torch/csrc/horizon_replay_bwd.cu"
BWD_REPLACES = "horayzon_tpu/ops/pallas_sweep.py:1705"
SHADOW_REPLACES = "horayzon_tpu/ops/pallas_sweep.py:2885"
SHADOW_BWD_REPLACES = "horayzon_tpu/ops/pallas_sweep.py:2470"
MASK_REPLACES = "horayzon_tpu/ops/pallas_sweep.py:196"
SHADOW_MASK_REPLACES = "horayzon_tpu/ops/pallas_sweep.py:2765"
TILT_REPLACES = "horayzon_tpu/ops/pallas_sweep.py:219"
#: The shard_off variants: pallas_forward_fn, shadow_forward_fn,
#: backward_replay_fn and shadow_backward_replay_fn with a shard's offsets
#: (launched per shard by horayzon_tpu/parallel/shard.py).
SHARD_REPLACES = "horayzon_tpu/ops/pallas_sweep.py:1396"
SHADOW_SHARD_REPLACES = "horayzon_tpu/ops/pallas_sweep.py:2794"
BWD_SHARD_REPLACES = "horayzon_tpu/ops/pallas_sweep.py:2238"
SHADOW_BWD_SHARD_REPLACES = "horayzon_tpu/ops/pallas_sweep.py:2399"
READ_FLOOR_SOURCE = "horayzon_tpu_torch/csrc/read_floor.cu"
READ_FLOOR_REPLACES = "tools/read_floor.py:53"
KERNELS = ("horizon_sweep", "horizon_replay_bwd", "read_floor")
#: Peaks of one H100 SXM (NVIDIA's data sheet): float32 operations outside
#: the tensor cores per second, HBM bytes per second.
PEAK_F32_OPS = 67.0e12
PEAK_HBM_BYTES = 3.35e12


def make_terrain(h, w, seed=0):
    """The bench's synthetic DEM (bench.py make_terrain): 24 gaussian
    bumps of 100-800 m on a flat plane."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    z = np.zeros((h, w), dtype=np.float64)
    for _ in range(24):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        sig = rng.uniform(6.0, h / 6.0)
        z += rng.uniform(100, 800) * np.exp(
            -(((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sig ** 2)))
    return z.astype(np.float32)


def check(cond, what):
    if not cond:
        raise SystemExit(f"FAIL: {what}")
    print(f"  ok: {what}")


def small_cases():
    """(name, z, kwargs) of the kernel-vs-plain phase."""
    spike_halo, spike_inner = 256, 64
    z_sp = np.zeros((spike_inner + 2 * spike_halo,) * 2, dtype=np.float32)
    z_sp[spike_halo - 96, spike_halo + 32] = 500.0
    return [
        # 32-cell halo: masked d2 and d1 steps run
        ("bumps96_inner32_d2500", make_terrain(96, 96, seed=3),
         dict(offset=(32, 32), inner_shape=(32, 32), azim_num=4,
              dist_search=2500.0)),
        # far spike caught only by the mip phases' reads
        ("spike_inner64_d6000", z_sp,
         dict(offset=(spike_halo, spike_halo),
              inner_shape=(spike_inner, spike_inner), azim_num=4,
              dist_search=6000.0)),
        ("bumps768_inner256_a7_d6000", make_terrain(768, 768, seed=1),
         dict(offset=(256, 256), inner_shape=(256, 256), azim_num=7,
              dist_search=6000.0)),
    ]


def odd_case():
    """A plan whose d1 range ends in a single step (n_dense - nx = 17):
    a masked pair run and a masked trailing single."""
    return ("bumps96_inner32_d825", make_terrain(96, 96, seed=3),
            dict(offset=(32, 32), inner_shape=(32, 32), azim_num=5,
                 dist_search=825.0))


def variant_fields(shape, seed):
    """A tilt ramp (A, B) of a few milliradians and a mask (an island plus
    scattered cells, leaving whole 32 x 8 blocks unlaunched) for phase G."""
    rng = np.random.default_rng(seed)
    ramp = tuple(rng.uniform(-2e-3, 2e-3, shape).astype(np.float32)
                 for _ in range(2))
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    mask = ((((yy - 0.4 * shape[0]) / (0.3 * shape[0])) ** 2
             + ((xx - 0.6 * shape[1]) / (0.2 * shape[1])) ** 2)
            <= 1.0).astype(np.uint8)
    mask[::7, ::5] = 1
    return ramp, mask


def bench_mask_set(inner, mask_frac=0.8):
    """bench.py:377-397's three masks of the inner domain: a disc of
    ``1 - mask_frac`` considered, the compact island (about 7.7%), 40
    scattered patches (seed 7)."""
    yy, xx = np.mgrid[0:inner, 0:inner]
    r_disc = np.sqrt((1.0 - mask_frac) * inner * inner / np.pi)
    disc = ((yy - inner * 0.45) ** 2 + (xx - inner * 0.55) ** 2
            <= r_disc ** 2).astype(np.uint8)
    island = ((((yy - inner * 0.5) / (inner * 0.22)) ** 2
               + ((xx - inner * 0.5) / (inner * 0.11)) ** 2)
              <= 1.0).astype(np.uint8)
    rng = np.random.default_rng(7)
    scattered = np.zeros((inner, inner), dtype=np.uint8)
    for _ in range(40):
        cy1, cx1 = rng.uniform(0, inner), rng.uniform(0, inner)
        rr = rng.uniform(18.0, 46.0)
        scattered |= ((yy - cy1) ** 2 + (xx - cx1) ** 2
                      <= rr ** 2).astype(np.uint8)
    return {"disc": disc, "island": island, "scattered": scattered}


def curved_bench_scene(n_c=1024, dlat=0.000833, in_c=512):
    """bench.py:66-96's curved masked scene: ``n_c``^2 lon/lat cells of
    ``dlat`` degree around (7, 45) on the sphere, 24 bumps (seed 6), ENU
    mesh, unit vectors, and the island mask of its ``in_c``^2 inner
    domain (the bench: 1024^2 at 0.000833 degree, 512^2 inner)."""
    lat0, lon0 = 45.0, 7.0
    lat = lat0 + (np.arange(n_c)[::-1] - n_c / 2) * dlat
    lon = lon0 + (np.arange(n_c) - n_c / 2) * dlat
    lon2, lat2 = np.meshgrid(lon, lat)
    rng = np.random.default_rng(6)
    elev = np.zeros_like(lon2)
    for _ in range(24):
        clon = rng.uniform(lon.min(), lon.max())
        clat = rng.uniform(lat.min(), lat.max())
        sig = rng.uniform(0.01, 0.1)
        elev += rng.uniform(200, 1400) * np.exp(
            -(((lon2 - clon) ** 2 + (lat2 - clat) ** 2) / (2 * sig ** 2)))
    elev = elev.astype(np.float32)
    trans = transform.TransformerEcef2enu(lon0, lat0, "sphere")
    xe, ye, ze = transform.lonlat2ecef(lon2, lat2, elev, "sphere")
    x, y, z = transform.ecef2enu(xe, ye, ze, trans)
    vn_ecef = direction.surf_norm(lon2, lat2)
    vno_ecef = direction.north_dir(xe, ye, ze, vn_ecef, "sphere")
    yy, xx = np.mgrid[0:in_c, 0:in_c]
    mask = ((((yy - in_c * 0.5) / (in_c * 0.22)) ** 2
             + ((xx - in_c * 0.5) / (in_c * 0.11)) ** 2) <= 1.0
            ).astype(np.uint8)
    return (x, y, z, transform.ecef2enu_vector(vn_ecef, trans),
            transform.ecef2enu_vector(vno_ecef, trans), mask)


def srtm_like_scene(n_s=900, dlat=0.0009, pad=0.25):
    """``examples/horizon/gridded_curved_dem.py``'s default terrain
    (``synthetic_srtm_like``: ``n_s``^2 cells of ``dlat`` degree around
    (8, 46.5), 30 bumps, seed 0; the example: 900^2 at 0.0009 degree) and
    its inner domain (``pad`` degree in from each edge; the example: 0.25)."""
    rng = np.random.default_rng(0)
    lat = 46.5 + (np.arange(n_s)[::-1] - n_s / 2) * dlat
    lon = 8.0 + (np.arange(n_s) - n_s / 2) * dlat
    lon2, lat2 = np.meshgrid(lon, lat)
    z = np.zeros_like(lon2)
    for _ in range(30):
        clon, clat = rng.uniform(lon.min(), lon.max()), \
            rng.uniform(lat.min(), lat.max())
        sig = rng.uniform(0.01, 0.08)
        z += rng.uniform(300, 2500) * np.exp(
            -(((lon2 - clon) ** 2 + (lat2 - clat) ** 2) / (2 * sig ** 2)))
    domain = {"lon_min": float(lon.min()) + pad,
              "lon_max": float(lon.max()) - pad,
              "lat_min": float(lat.min()) + pad,
              "lat_max": float(lat.max()) - pad}
    return lon, lat, z.astype(np.float32), domain


def shadow_small_cases():
    """(name, z, offset, inner, dx, dy, grid origin, suns relative to the
    domain centre) of the K2-vs-plain phase: tests/test_torch_shadow.py's
    cases (tests/test_pallas.py:153-181, dx != dy, a far spike only the mip
    phases read, a sun below the horizon and one straight above)."""
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:128, 0:128]
    z128 = np.zeros((128, 128))
    for _ in range(6):
        cy, cx = rng.uniform(0, 128), rng.uniform(0, 128)
        sig = rng.uniform(4.0, 32.0)
        z128 += rng.uniform(0.2, 1.0) * 400.0 * np.exp(
            -(((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sig ** 2)))
    z128 = z128.astype(np.float32)
    z_sp = np.zeros((256, 256), dtype=np.float32)
    z_sp[2, 250] = 500.0
    return [
        ("bumps128_inner64", z128, (32, 32), (64, 64), 25.0, -25.0,
         (0.0, 0.0), [(2.0e5, 1.0e5, 2.0e4), (-1.5e5, -0.5e5, 1.2e4),
                      (0.3e5, -2.0e5, 3.0e4)]),
        ("bumps96x160_dxdy", make_terrain(96, 160, seed=2), (12, 10),
         (64, 128), 25.0, -30.0, (1000.0, 5.0e5),
         [(2.0e5, 1.0e5, 1.5e4), (-1.0e5, 2.0e5, 1.0e4),
          (-2.0e5, -0.4e5, 2.0e4), (0.5e5, -2.0e5, 0.8e4)]),
        ("spike256_inner32", z_sp, (216, 8), (32, 32), 25.0, -25.0,
         (0.0, 0.0), [(2.1e5, 2.1e5, 6.0e3), (2.0e5, 2.2e5, 8.0e3),
                      (-2.0e5, 1.0e5, 6.0e3)]),
        ("below_and_vertical", z128, (32, 32), (64, 64), 25.0, -25.0,
         (0.0, 0.0), [(1.0e5, 0.0, -1.0e6), (0.0, 0.0, 2.0e4)]),
    ]


def shadow_inputs(zt, offset, inner, dx, dy, origin, rel):
    """z_org, z_inner, sun table and keyword arguments of
    ``shadow_metric_fused`` for suns at ``rel`` from the domain centre."""
    h, w = zt.shape
    cx = origin[0] + 0.5 * (w - 1) * dx
    cy = origin[1] + 0.5 * (h - 1) * dy
    suns = np.array([[cx + a, cy + b, c] for a, b, c in rel],
                    dtype=np.float32)
    table, _ = shadow_sweep.shadow_sun_table(suns, (cx, cy), dx, dy)
    z_inner = zt[offset[0]:offset[0] + inner[0],
                 offset[1]:offset[1] + inner[1]].contiguous()
    z_org = z_inner + float(np.float32(0.05))
    return z_org, z_inner, table, dict(offset=offset, inner_shape=inner,
                                       dx=dx, dy=dy, grid_origin=origin)


def hemisphere_terrain(dx=100.0):
    """``Terrain.initialise`` arguments of
    ``examples/shadow/gridded_planar_dem_artificial.py`` at its defaults: a
    hemisphere of radius 9.5 km in a 40 km domain, 10 km halo."""
    dom = np.array([10000, 20000, 10000], dtype=np.float32)
    x = np.linspace(-(dom.sum() - dx / 2), dom.sum() - dx / 2,
                    int(dom.sum() / dx) * 2, dtype=np.float32)
    y = x[::-1].copy()
    xx, yy = np.meshgrid(x, y)
    halo = int(dom[2] / dx)
    sl_in = (slice(halo, -halo), slice(halo, -halo))
    elevation = np.zeros(xx.shape, dtype=np.float32)
    m = int(dom[1:].sum() / dx)
    sl_mod = (slice(m, -m), slice(m, -m))
    with np.errstate(invalid="ignore"):
        elevation[sl_mod] = np.sqrt((dom[0] * 0.95) ** 2 - xx[sl_mod] ** 2
                                    - yy[sl_mod] ** 2)
    elevation[np.isnan(elevation)] = 0.0
    in_shape = elevation[sl_in].shape
    vec_norm = np.zeros(in_shape + (3,), dtype=np.float32)
    vec_norm[..., 2] = 1.0
    sl1 = (slice(halo - 1, xx.shape[0] - halo + 1),
           slice(halo - 1, xx.shape[1] - halo + 1))
    vec_tilt = np.ascontiguousarray(topo_param.slope_plane_meth(
        xx[sl1], yy[sl1], elevation[sl1])[1:-1, 1:-1].numpy())
    surf = topo_param.surface_enlargement_factor(vec_norm, vec_tilt).numpy()
    return (auxiliary.rearrange_pad_buffer(xx, yy, elevation),
            elevation.shape[0], elevation.shape[1], halo, halo, vec_tilt,
            vec_norm, surf, np.ascontiguousarray(elevation[sl_in]),
            np.ones(in_shape, dtype=np.uint8))


def event_ms(fn):
    """Milliseconds of one ``fn()`` between CUDA events, and its result."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop), out


def rel_err(got, want):
    """max |got - want| over max |want| (0 when both are 0)."""
    scale = want.abs().max().item()
    diff = (got - want).abs().max().item()
    return diff / scale if scale > 0.0 else diff


def cuda_ms(fn, reps):
    """Mean milliseconds of ``fn()`` over ``reps`` runs, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound(moved, ops):
    """``(bound_ms, bound_by)``: the least time the card could take to move
    ``moved`` bytes (each input read once, each output written once) and do
    ``ops`` float32 operations, at the peaks above."""
    t_b, t_o = moved / PEAK_HBM_BYTES, ops / PEAK_F32_OPS
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def tensor_bytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


#: Float32 operations per lane of the skip tests in csrc/horizon_sweep.cu,
#: K1's (False) and K2's value-exact ones (True): a d1 chunk's (d1_skip,
#: d1_skip_shadow; its box taken at its least, 4 pooled cells), a mip
#: test's fixed part and each sample slot a lane forms in it (mip_skip,
#: mip_skip_shadow; one pooled cell a slot).
D1_TEST_OPS = {False: 47, True: 49}
MIP_TEST_OPS = {False: 15, True: 17}
MIP_SLOT_OPS = {False: 9, True: 10}


def sweep_bound(sargs, shadow, argmax, counts=None):
    """Bound of one sweep launch (K1, K2 or an argmax variant) on the
    inputs ``sargs`` = (z_org, z_inner, levels, table, plan, shape[,
    tilt_ramp, mask]).  The float32 operations per (cell, row) are counted
    from csrc/horizon_sweep.cu: 18 per bilinear read, 4 per point
    candidate, 37 (K1) or 28 (K2) per parabola with its coefficients, 11
    per mip sample, 15 for K2's ray slope, 1 for the argmax's emit divide
    and 4 for the tilt ramp; every input is read and every output written
    once (the masked ones by the pre-fill).

    Without ``counts`` every sample of the full schedule is counted for
    every swept cell (with a mask the unmasked cells).  ``counts``: the
    kernel's counters from a launch on the same inputs
    (``fused_sweep.COUNTER_FIELDS``); then only the work this run's data
    needs is counted: the samples taken, the re-read of h1 after each
    skipped d1 chunk (at least one per 32 samples skipped), and the skip
    tests every warp makes, one per d1 chunk (K1: the safe pairs'; K2:
    safe and masked) and one per mip phase (:data:`D1_TEST_OPS`,
    :data:`MIP_TEST_OPS`, :data:`MIP_SLOT_OPS`).  The chunk tests inside a
    phase that runs are left out, since the counters do not say how many
    ran, so this stays a lower bound."""
    z_org, z_inner, levels, table, plan, _ = sargs[:6]
    ramp, mask = (tuple(sargs[6:8]) + (None, None))[:2]
    nx, ns1, n_dense = plan["nx"], plan["ns1"], plan["n_dense"]
    phases = plan["phases_meta"][1:]
    n_mip = sum(ph[1] for ph in phases)
    quads = nx + sum((hi - lo + 1) // 2
                     for lo, hi in ((nx, ns1), (ns1, n_dense)) if hi > lo)
    quad_ops = 28 if shadow else 37
    per_cell = (18 * (nx + n_dense) + 4 * n_dense + quad_ops * quads
                + 11 * n_mip + (15 if shadow else 0) + (1 if argmax else 0)
                + (4 if ramp is not None else 0))
    swept = z_org.numel() if mask is None else int((mask != 0).sum())
    moved = (tensor_bytes(z_org, z_inner, *levels) + table.nbytes
             + table.shape[0] * z_org.numel() * 4 * (3 if argmax else 1))
    if ramp is not None:
        moved += tensor_bytes(*ramp)
    if mask is not None:
        moved += tensor_bytes(mask)
    ops = table.shape[0] * swept * per_cell
    if counts is not None:
        d1_s, mip_s = counts["d1_skipped"], counts["mip_skipped"]
        ops -= d1_s * (18 + 4 + quad_ops / 2) + mip_s * 11
        ops += 18 * d1_s / 32
        def d1_tests(lo, hi):
            """The tested chunks of the d1 pairs of steps [lo, hi)."""
            return sum(1 for q0 in range(0, max(hi - lo, 0) // 2,
                                         fused_sweep.D1_CHUNK_PAIRS)
                       if lo + 2 * q0 >= 1)

        n_d1 = d1_tests(nx, ns1) + (d1_tests(ns1, n_dense) if shadow else 0)
        tests = (D1_TEST_OPS[shadow] * n_d1
                 + sum(MIP_TEST_OPS[shadow] + MIP_SLOT_OPS[shadow] * n / 32
                       for _, n, _, _ in phases))
        ops += table.shape[0] * swept * tests
    return bound(moved, ops)


def skip_report(what, sargs, argmax, ms, card, launch=None, model=None):
    """One launch of K1 (``argmax``: K1-argmax) on ``sargs`` with its
    counters set, or of ``launch(counters)`` (K2, :func:`k2_counted`):
    print the share of samples its skips passed over, per section, and its
    time beside the bound of the work this run's data needs and the full
    schedule's bound (:func:`sweep_bound` with and without the counters).
    ``model``: the count dict of ``shadow_sweep.metric_model`` on the same
    inputs and mode, printed per section and held equal to the counters.
    Returns the bound of the work needed, ``(bound_ms, bound_by)``."""
    plan, mask = sargs[4], (tuple(sargs[6:8]) + (None, None))[1]
    shadow = launch is not None
    counters = torch.zeros(len(fused_sweep.COUNTER_FIELDS),
                           dtype=torch.int64, device=sargs[0].device)
    if launch is None:
        fused_sweep._ratio_cuda(*sargs, emit_argmax=argmax,
                                counters=counters)
    else:
        launch(counters)
    got = dict(zip(fused_sweep.COUNTER_FIELDS, counters.tolist()))
    swept = sargs[0].numel() if mask is None else int((mask != 0).sum())
    n_mip = sum(ph[1] for ph in plan["phases_meta"][1:])
    per_cell = 2 * plan["nx"] + (plan["n_dense"] - plan["nx"]) + n_mip
    total = swept * sargs[3].shape[0] * per_cell
    taken = 1.0 - (got["d1_skipped"] + got["mip_skipped"]) / total
    print(f"  {what} skips (its counters): {skip_shares(got)}; "
          f"{taken:.4f} of all {total} samples taken")
    if model is not None:
        print(f"  {what} skips (the plain model): {skip_shares(model)}")
        check(all(got[f] == model[f] for f in fused_sweep.COUNTER_FIELDS),
              f"{what}: the kernel's four counters equal the plain model's")
    full = sweep_bound(sargs, shadow, argmax)
    need = sweep_bound(sargs, shadow, argmax, got)
    print(f"  {what}: {ms:.3f} ms against the bound of the work this run "
          f"needs (samples taken, re-reads, skip tests) {need[0]:.3f} ms "
          f"({need[1]}), {ms / need[0]:.2f}x that; the full schedule's "
          f"bound {full[0]:.3f} ms ({full[1]})  [{card}]")
    return need


def k2_counted(sargs, origin, **kw):
    """``launch(counters)`` of K2 on ``sargs`` for :func:`skip_report`;
    ``kw``: ``emit_argmax``, ``exact_metric``, ``pooled``."""
    return lambda counters: shadow_sweep._metric_cuda(
        *sargs, grid_origin=origin, counters=counters, **kw)


def skip_shares(counts):
    """The share of samples skipped per section of a count dict: the
    kernels' counters (``fused_sweep.COUNTER_FIELDS``: K1's d1 pairs are
    the safe ones, K2's also the masked ones), or
    ``shadow_sweep.metric_model``'s with K2's masked pairs apart."""
    d1_t, d1_s = counts["d1_taken"], counts["d1_skipped"]
    parts = [f"d1 pairs {d1_s / max(d1_t + d1_s, 1):.4f} of {d1_t + d1_s}"]
    if "masked_d1_taken" in counts:
        m_t, m_s = counts["masked_d1_taken"], counts["masked_d1_skipped"]
        s_t, s_s = d1_t - m_t, d1_s - m_s
        parts += [f"safe {s_s / max(s_t + s_s, 1):.4f} of {s_t + s_s}",
                  f"masked {m_s / max(m_t + m_s, 1):.4f} of {m_t + m_s}"]
    mip_t, mip_s = counts["mip_taken"], counts["mip_skipped"]
    parts.append(f"mip {mip_s / max(mip_t + mip_s, 1):.4f} of "
                 f"{mip_t + mip_s} skipped")
    return ", ".join(parts)


def replay_bound(g, ids, aux, plan, cots, zcot, shadow):
    """Bound of one replay launch (K3 or K4) for the winners this record
    holds (the work depends on the data: only winners contribute).
    Operations counted from csrc/horizon_replay_bwd.cu, whose two winner
    passes (the level maxima, the scatter) both decode every winner: per
    pass a point's distance and coefficient 3 (K4: 1), a parabola's
    coefficients 20 (K4: 18), a mip winner's distance, rounding and
    coefficient 9 (K4: 7); in the scatter a level-0 sample's corners 8 and
    each term's product and rounding to the grid 4 (a float64 multiply and
    rint counted as one operation each); each winner's z_org term 3 and,
    for K4, dm/dz_org 16 per (cell, sun).  Bytes: g, ids, aux (and z_org,
    the sun table) read, the level cotangents and zcot written."""
    n2 = 2 * plan["n_dense"]
    dense = ids < n2
    n_point = int((dense & (ids % 2 == 0)).sum())
    n_quad = int((dense & (ids % 2 == 1) & (aux > 1e-3)).sum())
    n_mip = int(((ids >= n2) & (ids < replay.ID_NONE)).sum())
    sample = 8 + 4 * 4
    point, quad, mip_w = ((1, 18, 7) if shadow else (3, 20, 9))
    ops = (n_point * (2 * point + sample + 3)
           + n_quad * (2 * quad + 3 * sample + 3)
           + n_mip * (2 * mip_w + 4 + 3)
           + (16 * ids.numel() if shadow else 0))
    # the (rows, 2) shift table; K4 also the (rows, 8) sun table and z_org
    moved = tensor_bytes(g, ids, aux, *cots, zcot) + ids.shape[0] * 8
    if shadow:
        moved += ids.shape[0] * 32 + tensor_bytes(zcot)
    return bound(moved, ops)


def print_levels(name):
    """Each level's fixed-point accumulation in the last replay run: the
    plan's bound 2**c_bits on the terms per target, one or two int64 words,
    the largest |coefficient| and the rounding bound per target."""
    for lvl, c_bits, words, m, bnd in replay.level_report():
        print(f"  {name}: level {lvl}: c_bits {c_bits}, {words} word(s), "
              f"max |coefficient| {m:.4e}, precision bound {bnd:.3e}")


def check_replay(name, what, runs, want):
    """Two runs of kernel ``what`` (K3 or K4), each ``cots + [zcot]``,
    bit-equal to each other and to the plain version's ``want``.  Returns
    the largest abs difference to the plain version."""
    got, again = runs
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"{name}: two {what} runs bit-equal")
    err = max((a - b).abs().max().item() for a, b in zip(got, want))
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          f"{name}: {what} bit-equal to its plain version ({len(got)} "
          f"outputs, largest difference {err:.1e})")
    return err


def check_shadow_argmax(name, args, origin):
    """K2-argmax on ``args`` (the inputs of ``shadow_sweep._metric_cuda``)
    against K2 and the plain argmax sweep: the metric, the winner ids and D
    bit-equal to the plain version's (the same float32 operations in the
    same order, as phase 5 holds K1-argmax, and value-exact skips), the
    metric also to K2's.  Returns (max abs metric difference, the plain
    version's ms)."""
    met, ids, aux = shadow_sweep._metric_cuda(*args, grid_origin=origin,
                                              emit_argmax=True)
    k2 = shadow_sweep._metric_cuda(*args, grid_origin=origin)
    plain_ms, (p_met, p_ids, p_aux) = event_ms(
        lambda: shadow_sweep._metric_plain(*args, grid_origin=origin,
                                           emit_argmax=True))
    err = (met - p_met).abs().max().item()
    n2 = 2 * args[4]["n_dense"]
    print(f"  {name}: max |metric_K2a - metric_plain| = {err:.3e} m; "
          f"{int((ids != p_ids).sum())} ids and {int((aux != p_aux).sum())} D "
          f"differ; {int(((ids < n2) & (ids % 2 == 1)).sum())} parabola and "
          f"{int((ids >= n2).sum())} mip winners of {ids.numel()}")
    check(torch.equal(met, k2) and torch.equal(met, p_met),
          f"{name}: K2-argmax metric bit-equal to K2's and to the plain "
          f"argmax sweep's")
    check(torch.equal(ids, p_ids) and torch.equal(aux, p_aux),
          f"{name}: winner ids and D bit-equal to the plain argmax sweep's")
    return err, plain_ms


def check_shadow_replay(name, args, origin, g, record=None):
    """K4 against the plain shadow replay on the K2-argmax ``record``
    ``(ids, aux)`` of ``args`` (run here when None) for the metric
    cotangent ``g``: two K4 runs bit-equal to each other and to the plain
    version.  Returns (max abs difference, the plain version's ms)."""
    z_org, table, plan = args[0], args[3], args[4]
    if record is None:
        record = shadow_sweep._metric_cuda(*args, grid_origin=origin,
                                           emit_argmax=True)[1:]
    ids, aux = record
    bargs = (tuple(args[5]), g, ids, aux, plan)
    shadow = (table, z_org, origin)
    runs = [replay._bwd_cuda(*bargs, shadow=shadow) for _ in range(2)]
    plain_ms, (p_cots, p_dzo) = event_ms(
        lambda: replay.backward_replay_plain(*bargs, shadow=shadow))
    check(runs[0][1].abs().max().item() > 0.0,
          f"{name}: the ray origins' cotangent is nonzero")
    err = check_replay(name, "K4", [c + [z] for c, z in runs],
                       p_cots + [p_dzo])
    return err, plain_ms


def kink_check(dev):
    """The winner-replay gradient of the shadow metric against finite
    differences (tests/test_grad.py:155-210) on a small case: the metric
    is a running max whose races are decided at centimetre scale, so at the
    four cells with the largest gradient the one-sided slopes bracket the
    analytic value and the central difference converges toward it."""
    _, z_s, off, inner, dx, dy, origin, _ = shadow_small_cases()[0]
    zk = torch.from_numpy(z_s).to(dev)
    _, _, table, kw = shadow_inputs(zk, off, inner, dx, dy, origin,
                                    [(3.0e5, -2.0e5, 1.5e4)])
    lift = float(np.float32(0.05))

    def loss(zz):
        z_i = zz[off[0]:off[0] + inner[0], off[1]:off[1] + inner[1]]
        met = shadow_sweep.shadow_metric_fused(zz, z_i + lift, z_i, table,
                                               **kw)
        return torch.sum(met[0].double())

    zg = zk.clone().requires_grad_(True)
    loss(zg).backward()
    g = zg.grad
    check(bool(torch.isfinite(g).all()) and g.abs().max().item() > 0.0,
          "kink case: gradient finite and nonzero")

    def value(zz):
        with torch.no_grad():
            return float(loss(zz))

    l0 = value(zk)
    for idx in torch.argsort(g.abs().flatten(), descending=True)[:4].tolist():
        ci, cj = divmod(idx, zk.shape[1])
        an = float(g[ci, cj])
        e = torch.zeros_like(zk)
        e[ci, cj] = float(np.sign(an)) or 1.0
        fwd = (value(zk + 0.25 * e) - l0) / 0.25
        bwd = (l0 - value(zk - 0.25 * e)) / 0.25
        an_s = abs(an)
        slack = 0.05 * (abs(fwd) + abs(bwd)) + 1e-6
        fds = [(value(zk + h * e) - value(zk - h * e)) / (2 * h)
               for h in (0.5, 0.05)]
        check(bwd - slack <= an_s <= fwd + slack
              and abs(fds[1] - an_s) < abs(fds[0] - an_s) + slack,
              f"kink case at {(ci, cj)}: one-sided slopes {bwd:.4f} <= "
              f"{an_s:.4f} <= {fwd:.4f}, central differences {fds[0]:.4f}, "
              f"{fds[1]:.4f}")


def phase_g(dev):
    """Phase G: K1's mask and tilt-ramp variants against their plain
    versions on the card.  Returns the largest |kernel - plain| of the raw
    ratios on unmasked cells."""
    print("== G. K1's mask and tilt-ramp variants against their plain "
          "versions on the card")
    var_err = 0.0
    for name, z, kw in small_cases() + [odd_case()]:
        zs = torch.from_numpy(z).to(dev)
        kw = dict(kw, dx=25.0, dy=-25.0, hori_acc=0.25)
        ramp, mask = variant_fields(kw["inner_shape"], seed=len(name))
        for variant in ("tilt", "mask", "tilt+mask"):
            vargs = fused_sweep.sweep_args(
                zs, **kw, tilt_ramp=ramp if "tilt" in variant else None,
                mask=mask if "mask" in variant else None)
            raw = fused_sweep._ratio_cuda(*vargs)
            a_raw, ids, aux = fused_sweep._ratio_cuda(*vargs,
                                                      emit_argmax=True)
            p_raw, p_ids, p_aux = fused_sweep._ratio_plain(*vargs,
                                                           emit_argmax=True)
            torch.cuda.synchronize()
            keep = torch.ones_like(ids, dtype=torch.bool)
            if "mask" in variant:
                keep = (vargs[7] != 0).expand_as(ids)
            var_err = max(var_err, (raw - p_raw)[keep].abs().max().item())
            check(torch.equal(raw, p_raw) and torch.equal(raw, a_raw),
                  f"{name}, {variant}: raw bit-equal to the plain version "
                  f"and to the argmax variant's")
            check(torch.equal(ids, p_ids) and torch.equal(aux, p_aux)
                  and bool((ids[~keep] == replay.ID_NONE).all()),
                  f"{name}, {variant}: ids and D bit-equal to the plain "
                  f"argmax sweep's, masked ids ID_NONE "
                  f"({int((~keep).sum())} masked (cell, azimuth))")
    z, kw = small_cases()[0][1:]
    zs = torch.from_numpy(z).to(dev)
    kw = dict(kw, dx=25.0, dy=-25.0, hori_acc=0.25)
    n0 = (fused_sweep.KERNEL_LAUNCHES, fused_sweep.MASK_KERNEL_LAUNCHES)
    empty = fused_sweep.horizon_sweep_fused(
        zs, mask=np.zeros(kw["inner_shape"], np.uint8), **kw)
    check((fused_sweep.KERNEL_LAUNCHES,
           fused_sweep.MASK_KERNEL_LAUNCHES) == n0
          and bool((empty == np.float32(np.radians(-15.0))).all()),
          "all-masked: no launch, the lower limit everywhere")
    sparse = np.zeros(kw["inner_shape"], np.uint8)
    sparse[9, 3] = 1
    sparse[30:, 20:] = 1
    blocks = fused_sweep.live_blocks(torch.from_numpy(sparse))
    vargs = fused_sweep.sweep_args(zs, mask=sparse, **kw)
    raw, ids, aux = fused_sweep._ratio_cuda(*vargs, emit_argmax=True)
    p_raw, p_ids, p_aux = fused_sweep._ratio_plain(*vargs, emit_argmax=True)
    keep = (vargs[7] != 0).expand_as(ids)
    check(blocks.tolist() == [[1, 0], [3, 0]] and torch.equal(raw, p_raw)
          and torch.equal(ids, p_ids) and torch.equal(aux, p_aux)
          and bool((raw[~keep] == 3.0e38).all())
          and bool((ids[~keep] == replay.ID_NONE).all())
          and bool((aux[~keep] == 1.0).all()),
          "scattered mask: 2 of 4 blocks launched; the others hold 3e38, "
          "ID_NONE and D 1, bit-equal to the plain version")
    # the gradient through the ramp and the mask against the plain path
    name, z, kw = odd_case()
    kw = dict(kw, dx=25.0, dy=-25.0, hori_acc=0.25)
    ramp, mask = variant_fields(kw["inner_shape"], seed=4)

    def var_loss(zz, ra, rb):
        h = fused_sweep.horizon_sweep_fused(zz, tilt_ramp=(ra, rb),
                                            mask=mask, **kw)
        w = torch.from_numpy(mask != 0).to(zz.device)[..., None]
        return torch.mean(torch.where(w, h, 0.0).double() ** 2)

    grads = []
    for d in (dev, torch.device("cpu")):
        leaves = [torch.from_numpy(a).to(d).requires_grad_(True)
                  for a in (z,) + ramp]
        grads.append(torch.autograd.grad(var_loss(*leaves), leaves))
    errs = [rel_err(a.cpu(), b) for a, b in zip(*grads)]
    check(max(errs) <= BWD_RTOL and min(b.abs().max().item()
                                        for b in grads[1]) > 0.0,
          f"{name}: z and ramp gradients (K1-argmax with ramp and mask, K3) "
          f"within rtol {BWD_RTOL} of the plain path "
          f"({', '.join(f'{e:.1e}' for e in errs)})")
    z_d = torch.from_numpy(z).to(dev)
    ra, rb = (torch.from_numpy(r).to(dev) for r in ramp)
    yy, xx = np.mgrid[0:z.shape[0], 0:z.shape[1]]
    v = torch.from_numpy(np.exp(-((yy - 40.32) ** 2 + (xx - 49.92) ** 2)
                                / (2 * 15.36 ** 2)).astype(np.float32)).to(dev)
    with torch.no_grad():
        fd = (var_loss(z_d + 0.1 * v, ra, rb)
              - var_loss(z_d - 0.1 * v, ra, rb)).item() / 0.2
        fd_r = (var_loss(z_d, ra + 1e-4, rb + 1e-4)
                - var_loss(z_d, ra - 1e-4, rb - 1e-4)).item() / 2e-4
    an = float((grads[0][0].double() * v.double()).sum())
    an_r = float((grads[0][1] + grads[0][2]).double().sum())
    check(an != 0.0 and abs(fd - an) <= 2e-2 * abs(an)
          and abs(fd_r - an_r) <= 1e-3 * abs(an_r),
          f"{name}: directional derivatives {an:.6e} (z, smooth bump) and "
          f"{an_r:.6e} (ramp) against central differences {fd:.6e}, "
          f"{fd_r:.6e}")
    return var_err


def wall_runs(fn, runs):
    """Median, min and max seconds of ``runs`` calls of ``fn`` after a
    warm-up, each ended by a synchronise; and the last result."""
    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(runs):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return float(np.median(walls)), min(walls), max(walls), out


def phase_h(dev, zt, x, y, halo, azim_num, dist_km, k1_ms, card, runs):
    """Phase H: masked planar ``horizon_gridded`` on ``zt`` with the bench
    masks.  Returns the K1-mask row's numbers (launches, error, ms, plain
    ms, bound)."""
    print("== H. masked planar horizon_gridded at the bench shape")
    n, inner = zt.shape[0], zt.shape[0] - 2 * halo
    dx = float(x[1] - x[0])
    x2, y2 = np.meshgrid(x, y)
    vert_grid = auxiliary.rearrange_pad_buffer(x2, y2, zt.cpu().numpy())
    del x2, y2
    vn = np.zeros((inner, inner, 3), np.float32)
    vn[..., 2] = 1.0
    vno = np.zeros((inner, inner, 3), np.float32)
    vno[..., 1] = 1.0
    hz_kw = dict(dist_search=dist_km, azim_num=azim_num, hori_acc=0.25,
                 hori_fill=-9.0, verbose=False, device=dev)

    def gridded(mask=None):
        return horizon.horizon_gridded(vert_grid, n, n, vn, vno, halo, halo,
                                       mask=mask, **hz_kw)[0]

    dense_wall, dmin, dmax, dense = wall_runs(gridded, runs)
    print(f"  dense horizon_gridded: median {dense_wall:.4f} s wall of "
          f"{runs} (min {dmin:.4f}, max {dmax:.4f}); K1 alone {k1_ms:.3f} ms"
          f"  [{card}]")
    rows, launches = {}, 0
    for mname, mask in bench_mask_set(inner).items():
        fused_sweep.MASK_KERNEL_LAUNCHES = 0
        m_wall, m_min, m_max, got = wall_runs(lambda: gridded(mask), runs)
        launches += fused_sweep.MASK_KERNEL_LAUNCHES
        keep = torch.from_numpy(mask == 1).to(dev)
        check(torch.equal(got[keep], dense[keep])
              and bool((got[~keep] == -9.0).all()),
              f"{mname}: unmasked cells bit-equal to the dense run, masked "
              f"cells the fill")
        del got
        mvargs = fused_sweep.sweep_args(
            zt, dx=dx, dy=-dx, offset=(halo, halo),
            inner_shape=(inner, inner), azim_num=azim_num,
            dist_search=dist_km * 1000.0, mask=mask)
        fused_sweep._ratio_cuda(*mvargs)
        m_ms = cuda_ms(lambda: fused_sweep._ratio_cuda(*mvargs), 10)
        n_live = fused_sweep.live_blocks(mvargs[7]).shape[0]
        n_blk = (-(-inner // fused_sweep.BLOCK_ROWS)
                 * -(-inner // fused_sweep.BLOCK_COLS))
        rows[mname] = (m_ms, mvargs)
        print(f"  {mname}: {mask.mean():.4f} considered, {n_live / n_blk:.4f}"
              f" of the 32x8 blocks live; horizon_gridded median "
              f"{m_wall:.4f} s wall (min {m_min:.4f}, max {m_max:.4f}), "
              f"{dense_wall / m_wall:.3f}x the dense run; K1-mask alone "
              f"{m_ms:.3f} ms, {k1_ms / m_ms:.3f}x faster than K1; per "
              f"live block {m_ms / (k1_ms * n_live / n_blk):.3f}x K1's "
              f"time per block  [{card}]")
    check(launches == 3 * (runs + 1),
          f"masked path launched K1-mask ({launches} launches in "
          f"{3 * (runs + 1)} runs)")
    mask_ms, mvargs = rows["island"]
    plain_ms, p_raw = event_ms(lambda: fused_sweep._ratio_plain(*mvargs))
    raw = fused_sweep._ratio_cuda(*mvargs)
    keep = (mvargs[7] != 0).expand_as(raw)
    err = (raw - p_raw)[keep].abs().max().item()
    check(torch.equal(raw, p_raw), "island: K1-mask bit-equal to the plain "
          "version on the full output")
    print(f"  K1-mask on the island: plain version {plain_ms:.1f} ms  "
          f"[{card}]")
    bnd = skip_report("K1-mask (island)", mvargs, False, mask_ms, card)
    return launches, err, mask_ms, plain_ms, bnd


def lattice_args(lat, dev, azim_num, dist_m):
    """``sweep_args`` of the tilt-ramp sweep over a curved run's lattice
    box (:func:`horizon.curved_lattice`'s result)."""
    i_lo, i_hi, j_lo, j_hi = lat["box"]
    return fused_sweep.sweep_args(
        torch.from_numpy(lat["pg"].z).to(dev), dx=lat["pg"].grid.dx,
        dy=lat["pg"].grid.dy, offset=(i_lo, j_lo),
        inner_shape=(i_hi - i_lo, j_hi - j_lo), azim_num=azim_num,
        dist_search=dist_m, tilt_ramp=lat["ramp"], mask=lat["lat_mask"])


def phase_i(dev, azim_num, card, bench_scene, c_off, c_in, srtm_scene):
    """Phase I: the curved masked scene ``bench_scene`` (inner ``c_in``^2
    at ``c_off``) dense and masked, then ``CurvedPipeline.run`` on
    ``srtm_scene``.  Returns the K1-tilt row's numbers (launches, error,
    ms, plain ms, bound)."""
    print("== I. curved: bench.py's curved masked scene and CurvedPipeline")
    cx, cy, cz, c_norm, c_north, c_mask = bench_scene
    sl = (slice(c_off, c_off + c_in),) * 2
    c_grid = auxiliary.rearrange_pad_buffer(cx, cy, cz)
    c_kw = dict(dist_search=10.0, azim_num=azim_num, hori_acc=0.25,
                hori_fill=-9.0, verbose=False, device=dev)

    def curved(mask=None):
        t0 = time.perf_counter()
        out = horizon.horizon_gridded(c_grid, cx.shape[0], cx.shape[1],
                                      c_norm[sl], c_north[sl], c_off, c_off,
                                      mask=mask, **c_kw)[0]
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    # each horizon_gridded call planarises the mesh on the host (seconds at
    # 1024^2), so each runs once; the lattice sweeps are timed alone below
    c_dense_s, c_dense = curved()
    c_mask_s, c_masked = curved(c_mask)
    keep = torch.from_numpy(c_mask == 1).to(dev)
    check(torch.equal(c_masked[keep], c_dense[keep])
          and bool((c_masked[~keep] == -9.0).all())
          and bool(torch.isfinite(c_dense).all()),
          "curved island: unmasked cells bit-equal to the dense run, "
          "masked cells the fill")
    del c_dense, c_masked
    t0 = time.perf_counter()
    lat_d = horizon.curved_lattice(cx, cy, cz, c_norm[sl], c_off, c_off)
    plan_s = time.perf_counter() - t0
    lat_m = horizon.curved_lattice(cx, cy, cz, c_norm[sl], c_off, c_off,
                                   c_mask, pg=lat_d["pg"])
    sweeps = []
    for lat in (lat_d, lat_m):
        cargs = lattice_args(lat, dev, azim_num, 10000.0)
        fused_sweep._ratio_cuda(*cargs)
        sweeps.append(cuda_ms(lambda: fused_sweep._ratio_cuda(*cargs), 5))
    print(f"  lattice {lat_d['pg'].grid.shape}, dense box {lat_d['box']}, "
          f"masked box {lat_m['box']} with {lat_m['lat_mask'].mean():.4f} "
          f"of its cells swept; {c_mask.mean():.4f} of the inner cells "
          f"considered")
    print(f"  horizon_gridded (one run each): dense {c_dense_s:.3f} s, "
          f"masked {c_mask_s:.3f} s wall ({c_dense_s / c_mask_s:.3f}x), "
          f"of which planarisation and ramps {plan_s:.3f} s; K1-tilt alone "
          f"(mean of 5): dense box {sweeps[0]:.3f} ms, masked box "
          f"{sweeps[1]:.3f} ms, {sweeps[0] / sweeps[1]:.3f}x  [{card}]")
    del lat_d, lat_m

    lon_p, lat_p, elev_p, dom_p = srtm_scene
    pipe = CurvedPipeline(lon_p, lat_p, elev_p, dom_p, dist_search=20.0,
                          azim_num=120, ellps="WGS84", device=dev)
    t0 = time.perf_counter()
    pipe.build_geometry()
    geo_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_sweep.TILT_KERNEL_LAUNCHES = 0
    t0 = time.perf_counter()
    out = pipe.run()
    torch.cuda.synchronize()
    pipe_s = time.perf_counter() - t0
    launches = fused_sweep.TILT_KERNEL_LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    check(launches == 1, f"CurvedPipeline.run launched K1-tilt "
          f"({launches} launches in 1 run)")
    hori, svf = out["hori"], out["svf"]
    check(hori.is_cuda and hori.shape[2] == 120
          and bool(torch.isfinite(hori).all())
          and bool(torch.isfinite(svf).all()) and svf.min().item() > 0.0
          and svf.max().item() <= 1.0 + 1e-3,
          f"CurvedPipeline: hori {tuple(hori.shape)} finite, svf in "
          f"(0, 1.001]: [{svf.min().item():.4f}, {svf.max().item():.4f}]")
    # the run's parts, again, one by one
    t0 = time.perf_counter()
    lat_c = horizon.curved_lattice(pipe.x, pipe.y, pipe.z, pipe.vec_norm,
                                   pipe.offset_0, pipe.offset_1)
    plan_c_s = time.perf_counter() - t0
    targs = lattice_args(lat_c, dev, 120, 20000.0)
    fused_sweep._ratio_cuda(*targs)
    tilt_ms = cuda_ms(lambda: fused_sweep._ratio_cuda(*targs), 5)
    plain_ms, p_raw = event_ms(lambda: fused_sweep._ratio_plain(*targs))
    raw = fused_sweep._ratio_cuda(*targs)
    err = (raw - p_raw).abs().max().item()
    check(torch.equal(raw, p_raw), "K1-tilt bit-equal to the plain version "
          "on the pipeline's lattice box")
    i_lo, i_hi, j_lo, j_hi = lat_c["box"]
    hori_r = fused_sweep._angles(raw, pipe.elev_ang_low_lim, 89.98)
    fi = np.clip(lat_c["fi"] - i_lo, 0.0, i_hi - i_lo - 1.0)
    fj = np.clip(lat_c["fj"] - j_lo, 0.0, j_hi - j_lo - 1.0)
    rb_ms, back = event_ms(lambda: horizon.read_back(hori_r, fi, fj))
    check(torch.equal(back, hori), "the parts give the pipeline's horizon")
    print(f"  CurvedPipeline.run at gridded_curved_dem.py's defaults "
          f"(900^2 at 0.0009 deg, WGS84, 20 km, 120 azimuths; inner "
          f"{tuple(hori.shape[:2])}, lattice box {lat_c['box']}): "
          f"{pipe_s:.3f} s wall (geometry beforehand {geo_s:.3f} s); parts: "
          f"host planarisation and ramps {plan_c_s:.3f} s, K1-tilt "
          f"{tilt_ms:.3f} ms, read-back {rb_ms:.3f} ms; peak "
          f"{peak / 2**20:.1f} MiB allocated; svf "
          f"[{svf.min().item():.4f}, {svf.max().item():.4f}]  [{card}]")
    print(f"  K1-tilt: plain version {plain_ms:.1f} ms  [{card}]")
    bnd = skip_report("K1-tilt", targs, False, tilt_ms, card)
    return launches, err, tilt_ms, plain_ms, bnd


def seeded_window(n, dev, seed=0):
    """(n, n) float32 standard normals made on the card from ``seed``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((n, n), generator=gen, device=dev,
                       dtype=torch.float32)


def phase_j(dev, card):
    """K5.  Returns its row of the kernels line: (launches, max abs error,
    ms, plain ms, bound) of the ``bilinear`` L2 mode at the bench window."""
    print("== J. K5 (the read floor) against its plain versions, then timed")
    win_s = seeded_window(224, dev, seed=1)[:160].contiguous()
    trig_s = read_floor.first_quadrant_trig(5)
    kw = dict(cells=(20, 70), n_steps=37, offset=(8, 32), chunk=8)
    err = 0.0
    for mode, source in read_floor.MEASURED:
        n0 = read_floor.KERNEL_LAUNCHES
        got = read_floor.read_floor(win_s, trig_s, mode, source=source, **kw)
        want = read_floor.read_floor_plain(win_s, trig_s, mode,
                                           source=source, **kw)
        torch.cuda.synchronize()
        err = max(err, (got - want).abs().max().item())
        check(read_floor.KERNEL_LAUNCHES == n0 + 1
              and torch.equal(got, want),
              f"K5 {mode}/{source}: launched once, bit-equal to its plain "
              f"version (20 x 70 cells, 5 directions, 37 steps, chunk 8)")
    cells, a_num, n_steps, chunk, iters = (1024, 1024), 32, 246, 32, 10
    trig = read_floor.first_quadrant_trig(a_num)
    rows, ld = read_floor.strip_layout("bilinear", trig, n_steps, n_steps)
    print(f"  a block's strip for all {n_steps} steps: {rows} x {ld} cells = "
          f"{rows * ld * 4 / 1024:.0f} KB (over the "
          f"{read_floor.MAX_SMEM_BYTES / 1024:.0f} KB a block can have); "
          f"staged per chunk of {chunk} steps")
    # K5's own main path: the tool's timing run on both windows
    read_floor.KERNEL_LAUNCHES = 0
    timed = {}
    for n in (2048, 5120):
        win = seeded_window(n, dev)
        print(f"  window {n}^2 ({win.numel() * 4 / 2**20:.0f} MiB), "
              f"{cells[0]}^2 cells x {a_num} directions x {n_steps} steps, "
              f"mean of {iters} launches  [{card}]")
        for row in read_floor.time_modes(win, cells=cells, a_num=a_num,
                                         n_steps=n_steps, chunk=chunk,
                                         iters=iters):
            timed[(n, row["mode"], row["source"])] = row
            print(f"    {read_floor.format_row(row)}")
        win.max()
        lib_ms = cuda_ms(win.max, iters)
        print(f"    torch max over the window (one pass, never called by "
              f"the port): {lib_ms:.4f} ms, "
              f"{win.numel() * 4 / lib_ms / 1e9:.3f} TB/s")
        if n == 2048:
            bench_win = win
    # stream alone on a window twenty times L2: device memory's read rate
    # (the 105 MB window's row still mixes L2 hits in)
    n = 16384
    win = seeded_window(n, dev)
    print(f"  window {n}^2 ({win.numel() * 4 / 2**20:.0f} MiB), stream alone"
          f"  [{card}]")
    (row,) = read_floor.time_modes(win, cells=cells, a_num=a_num,
                                   n_steps=n_steps, iters=iters,
                                   pairs=(("stream", "l2"),))
    print(f"    {read_floor.format_row(row)}")
    lib_ms = cuda_ms(win.max, iters)
    print(f"    torch max over the window (one pass, never called by the "
          f"port): {lib_ms:.4f} ms, "
          f"{win.numel() * 4 / lib_ms / 1e9:.3f} TB/s")
    check(row["tb_per_s"] * 1e12 <= PEAK_HBM_BYTES,
          f"stream on the {n}^2 window reads {row['tb_per_s']:.3f} TB/s, "
          f"within device memory's {PEAK_HBM_BYTES / 1e12:.2f} TB/s (the "
          f"5120^2 window's {timed[(5120, 'stream', 'l2')]['tb_per_s']:.3f} "
          f"TB/s is a mix with L2)")
    del win
    launches = read_floor.KERNEL_LAUNCHES
    check(launches == (2 * len(read_floor.MEASURED) + 1) * (iters + 1),
          f"K5's timing run launched it {launches} times")
    got = read_floor.read_floor(bench_win, trig, "bilinear", cells=cells,
                                n_steps=n_steps)
    plain_ms, want = event_ms(lambda: read_floor.read_floor_plain(
        bench_win, trig, "bilinear", cells=cells, n_steps=n_steps))
    err = max(err, (got - want).abs().max().item())
    check(torch.equal(got, want), "K5 bilinear/l2 bit-equal to its plain "
          "version at the bench window")
    w = read_floor.work("bilinear", cells, a_num, n_steps)
    bnd = bound(tensor_bytes(bench_win, got) + trig.nbytes, w["ops"])
    ms = timed[(2048, "bilinear", "l2")]["ms"]
    print(f"  K5 bilinear/l2 at the 2048^2 window: {ms:.3f} ms; plain torch "
          f"version {plain_ms:.1f} ms; bound {bnd[0]:.3f} ms ({bnd[1]})  "
          f"[{card}]")
    alu = timed[(2048, "alu", "l2")]["tops_per_s"] * 1e12
    print(f"  float32 ceiling as the kernels are built (--fmad=false): "
          f"{alu / 1e12:.2f} T op/s against the data sheet's "
          f"{PEAK_F32_OPS / 1e12:.0f} TFLOP/s")
    return (launches, err, ms, plain_ms, bnd), alu


def multires_small_scenes():
    """(name, z_fine, z_coarse, kwargs) of the two scenes of
    tests/test_torch_multires.py on the bench's terrain generator: ratio 4
    with a 96-cell halo, and ratio 2 with dx != |dy|, an odd fine shape
    and the inner block off centre."""
    def pool(z, r):
        h, w = z.shape
        return z[:h - h % r, :w - w % r].reshape(h // r, r, w // r, r).max(
            axis=(1, 3))

    halo_full = int(4000.0 / 25.0) + 16
    full = make_terrain(32 + 2 * halo_full, 32 + 2 * halo_full, seed=9)
    i0 = halo_full - 96
    full2 = make_terrain(400, 400, seed=17)
    return [
        ("r2_halo96", np.ascontiguousarray(full[i0:i0 + 224, i0:i0 + 224]),
         pool(full, 4),
         dict(ratio_log2=2, coarse_offset=(i0, i0), dx=25.0, dy=-25.0,
              offset=(96, 96), inner_shape=(32, 32), dist_search=4000.0,
              hori_acc=2.0, azim_num=8)),
        ("r1_dxdy_odd", np.ascontiguousarray(full2[100:233, 100:241]),
         pool(full2, 2),
         dict(ratio_log2=1, coarse_offset=(100, 100), dx=25.0, dy=-30.0,
              offset=(50, 54), inner_shape=(32, 32), dist_search=3000.0,
              hori_acc=2.0, azim_num=8))]


def multires_args(zf, zc, kw):
    """The sweep's inputs over the combined pyramid of ``zf``, ``zc``
    (tensors on one device) for the multires keywords ``kw``."""
    geo = {k: kw[k] for k in ("dx", "dy", "offset", "inner_shape",
                              "dist_search", "hori_acc")}
    levels = multires.multires_levels(zf, zc, ratio_log2=kw["ratio_log2"],
                                      coarse_offset=kw["coarse_offset"],
                                      **geo)
    return fused_sweep.sweep_args(zf, pyramid=levels,
                                  azim_num=kw["azim_num"], **geo)


def multires_2m_scene(inner=1024, halo_fine=2048, ratio_log2=4,
                      dist_km=20.0, dx=2.0):
    """The synthetic scene of examples/horizon/gridded_planar_dem_2m.py
    (:82-103, seed 2): 30 gaussian mountains over the coarse extent, the
    fine grid the coarse window repeated plus 3 m of 2 m-scale noise."""
    r = 2 ** ratio_log2
    n_fine = inner + 2 * halo_fine
    rng = np.random.default_rng(2)
    n_coarse = int(np.ceil((n_fine * dx + 2 * dist_km * 1000.0) / (r * dx)))
    yy, xx = np.mgrid[0:n_coarse, 0:n_coarse].astype(np.float64)
    zc = np.zeros((n_coarse, n_coarse))
    for _ in range(30):
        cy, cx = rng.uniform(0, n_coarse, 2)
        sig = rng.uniform(10, n_coarse / 6)
        zc += rng.uniform(200, 2000) * np.exp(
            -(((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sig ** 2)))
    z_coarse = zc.astype(np.float32)
    fo_c = (n_coarse - n_fine // r) // 2
    window = z_coarse[fo_c:fo_c + n_fine // r, fo_c:fo_c + n_fine // r]
    z_fine = np.repeat(np.repeat(window, r, 0), r, 1)
    z_fine = (z_fine + 3.0 * rng.standard_normal(z_fine.shape).astype(
        np.float32)).astype(np.float32)
    kw = dict(ratio_log2=ratio_log2, coarse_offset=(fo_c * r, fo_c * r),
              dx=dx, dy=-dx, offset=(halo_fine, halo_fine),
              inner_shape=(inner, inner), dist_search=dist_km * 1000.0,
              hori_acc=0.25, azim_num=60)
    return z_fine, z_coarse, kw


def tin_scene(dx=25.0, n_fine=1024, inner=512, dist_km=10.0, pool=8):
    """A mid-size TIN run: the bench's terrain over the full search
    extent, the fine window around the inner block, and a TIN through the
    ``pool`` x max-pooled terrain (two triangles per quad), as
    tests/test_multires.py:104-169 builds its own."""
    halo_full = int(dist_km * 1000.0 / dx) + 16
    halo_fine = (n_fine - inner) // 2
    n_full = inner + 2 * halo_full
    full = make_terrain(n_full, n_full, seed=13)
    x = np.arange(n_full, dtype=np.float64) * dx
    y = -np.arange(n_full, dtype=np.float64) * dx
    i0 = halo_full - halo_fine
    h = n_full - n_full % pool
    pooled = full[:h, :h].reshape(h // pool, pool, h // pool, pool).max(
        axis=(1, 3))
    nc = pooled.shape[0]
    xv, yv = np.meshgrid(x[:nc * pool:pool] - i0 * dx,
                         y[:nc * pool:pool] + i0 * dx)
    verts = np.stack([xv, yv, pooled.astype(np.float64)],
                     axis=-1).reshape(-1, 3).astype(np.float32)
    jj, ii = np.meshgrid(np.arange(nc - 1), np.arange(nc - 1))
    a = (ii * nc + jj).ravel()
    tris = np.concatenate([
        np.stack([a, a + 1, a + nc], -1),
        np.stack([a + 1, a + nc + 1, a + nc], -1)]).astype(np.int32).ravel()

    def vert_grid(xa, ya, za):
        x2, y2 = np.meshgrid(xa, ya)
        return auxiliary.rearrange_pad_buffer(
            x2.astype(np.float32), y2.astype(np.float32),
            za.astype(np.float32))

    vec_norm = np.zeros((inner, inner, 3), np.float32)
    vec_norm[..., 2] = 1.0
    vec_north = np.zeros((inner, inner, 3), np.float32)
    vec_north[..., 1] = 1.0
    sl = slice(i0, i0 + n_fine)
    return dict(
        full=(vert_grid(x, y, full), n_full, n_full, vec_norm, vec_north,
              halo_full, halo_full, dist_km),
        fine=(vert_grid(x[sl] - i0 * dx, y[sl] + i0 * dx, full[sl, sl]),
              n_fine, n_fine, vec_norm, vec_north, halo_fine, halo_fine,
              dist_km),
        tin=dict(vert_simp=verts.ravel(), num_vert_simp=len(verts),
                 tri_ind_simp=tris, num_tri_simp=len(tris) // 3))


def phase_k(dev, card):
    """Multires.  Returns the max abs errors of K1-argmax's raw ratios and
    of K3's cotangents against their plain versions on the crop of the 2 m
    cell's pyramid."""
    print("== K. multires: the combined fine + coarse pyramid")
    for name, zf_np, zc_np, kw in multires_small_scenes():
        zf = torch.from_numpy(zf_np).to(dev)
        zc = torch.from_numpy(zc_np).to(dev)
        sargs = multires_args(zf, zc, kw)
        plan, trig, levels = sargs[4], sargs[3], sargs[2]
        print(f"  {name}: {len(levels)} levels, the first "
              f"{kw['ratio_log2']} from the fine grid {tuple(zf.shape)}, "
              f"pads {plan['pads']}")
        raw, ids, aux = fused_sweep._ratio_cuda(*sargs, emit_argmax=True)
        raw_k1 = fused_sweep._ratio_cuda(*sargs)
        p_raw, p_ids, p_aux = fused_sweep._ratio_plain(*sargs,
                                                       emit_argmax=True)
        torch.cuda.synchronize()
        check(torch.equal(raw_k1, p_raw) and torch.equal(raw, p_raw),
              f"{name}: K1 and K1-argmax on the combined pyramid bit-equal "
              f"to the plain sweep")
        n2 = 2 * plan["n_dense"]
        check(torch.equal(ids, p_ids) and torch.equal(aux, p_aux),
              f"{name}: ids and aux equal ({int((ids >= n2).sum())} of "
              f"{ids.numel()} winners on mip levels)")
        g = torch.from_numpy(np.random.default_rng(7).normal(
            size=tuple(raw.shape)).astype(np.float32)).to(dev)
        bargs = (tuple(zf.shape), g, ids, aux, plan,
                 replay.horizon_shifts(trig, plan))
        runs = [replay._bwd_cuda(*bargs) for _ in range(2)]
        p_cots, p_zcot = replay.backward_replay_plain(*bargs)
        torch.cuda.synchronize()
        check([tuple(c.shape) for c in runs[0][0]]
              == [tuple(t.shape) for t in levels],
              f"{name}: K3's cotangents have the combined levels' shapes")
        check_replay(name, "K3", [c + [z] for c, z in runs],
                     p_cots + [p_zcot])
        # both gradients through the entry, the card against the CPU path
        grads = []
        for d in (dev, "cpu"):
            tf = torch.from_numpy(zf_np).to(d).requires_grad_(True)
            tc = torch.from_numpy(zc_np).to(d).requires_grad_(True)
            h = multires.horizon_sweep_multires_fused(tf, tc, **kw)
            grads.append([t.cpu() for t in torch.autograd.grad(
                torch.mean(h ** 2), (tf, tc))])
        errs = [rel_err(a, b) for a, b in zip(*grads)]
        check(max(errs) <= BWD_RTOL and all(
            b.abs().max().item() > 0.0 for b in grads[1]),
              f"{name}: d/dz_fine and d/dz_coarse on the card within rtol "
              f"{BWD_RTOL} of the CPU path ({errs[0]:.1e}, {errs[1]:.1e})")

    print("  the defaults of examples/horizon/gridded_planar_dem_2m.py")
    t0 = time.perf_counter()
    zf_np, zc_np, kw = multires_2m_scene()
    print(f"  scene made on the host in {time.perf_counter() - t0:.1f} s: "
          f"fine {zf_np.shape} at {kw['dx']:g} m, coarse {zc_np.shape} at "
          f"{kw['dx'] * 2 ** kw['ratio_log2']:g} m")
    zf = torch.from_numpy(zf_np).to(dev)
    zc = torch.from_numpy(zc_np).to(dev)
    in0, in1 = kw["inner_shape"]
    a_num = kw["azim_num"]

    def forward():
        return multires.horizon_sweep_multires_fused(zf, zc, **kw)

    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    forward()
    torch.cuda.synchronize()
    peak_f = torch.cuda.max_memory_allocated()
    fused_sweep.KERNEL_LAUNCHES = 0
    wall, w_min, w_max, hori = wall_runs(forward, 3)
    # the warm-up of wall_runs is a run of the main path too
    k1_launches = fused_sweep.KERNEL_LAUNCHES - 1
    print(f"  horizon_sweep_multires_fused, {in0}x{in1} x {a_num} azimuths: "
          f"median {wall:.4f} s wall of 3 (min {w_min:.4f}, max "
          f"{w_max:.4f}), {in0 * in1 * a_num / wall:.4e} "
          f"(cell*azimuth)/s; peak {peak_f / 2**20:.1f} MiB allocated "
          f"({base / 2**20:.1f} MiB before the call)  [{card}]")
    check(k1_launches == 3, f"the multires path launched K1 once per run "
          f"({k1_launches} in 3 runs)")
    check(tuple(hori.shape) == (in0, in1, a_num) and hori.is_cuda
          and bool(torch.isfinite(hori).all()), "hori shape, device, finite")
    lo, hi = np.radians(-15.0), np.radians(89.98)
    check(hori.min().item() >= lo - 1e-6 and hori.max().item() <= hi + 1e-6
          and hori.max().item() > 0.0,
          f"hori within the elevation limits: [{hori.min().item():.4f}, "
          f"{hori.max().item():.4f}] rad, mean "
          f"{np.degrees(hori.mean().item()):.2f} deg")
    sargs = multires_args(zf, zc, kw)
    plan = sargs[4]
    n_mip = sum(ph[1] for ph in plan["phases_meta"][1:])
    samples = plan["nx"] * 2 + (plan["n_dense"] - plan["nx"]) + n_mip
    raw = fused_sweep._ratio_cuda(*sargs)
    k1_ms = cuda_ms(lambda: fused_sweep._ratio_cuda(*sargs), 5)
    print(f"  K1 alone on the combined pyramid ({len(sargs[2])} levels, "
          f"level 0 {tensor_bytes(sargs[2][0]) / 1e6:.0f} MB, {samples} "
          f"samples per (cell, azimuth), {n_mip} of them mip reads): "
          f"{k1_ms:.3f} ms, {1e9 * k1_ms / (in0 * in1 * a_num * samples):.3f}"
          f" ps per sample  [{card}]")
    check(torch.equal(fused_sweep._angles(raw.clone(), -15.0, 89.98), hori),
          "the entry's angles are K1's on the combined pyramid")
    skip_report("K1 (multires)", sargs, False, k1_ms, card)
    # a 128^2 crop, every sixth azimuth: K1's full run, then K1-argmax and
    # K3 launched on the crop, each against its plain version over this
    # pyramid (level 0 beyond L2, eight combined levels)
    off = kw["offset"][0] + in0 // 2 - 64
    geo = {k: kw[k] for k in ("dx", "dy", "dist_search", "hori_acc")}
    crop = fused_sweep.sweep_args(zf, pyramid=sargs[2], offset=(off, off),
                                  inner_shape=(128, 128), azim_num=a_num,
                                  **geo)
    crop = crop[:3] + (crop[3][::6],) + crop[4:]
    c_plan, c_trig = crop[4], crop[3]
    p_raw, p_ids, p_aux = fused_sweep._ratio_plain(*crop, emit_argmax=True)
    c0 = off - kw["offset"][0]
    got = raw[::6, c0:c0 + 128, c0:c0 + 128]
    err = (torch.atan(got) - torch.atan(p_raw)).abs().max().item()
    check(err <= TOL, f"128^2 crop, 10 azimuths, against the plain sweep: "
          f"{err:.3e} rad (bit-equal: {torch.equal(got, p_raw)})")
    c_raw, c_ids, c_aux = fused_sweep._ratio_cuda(*crop, emit_argmax=True)
    torch.cuda.synchronize()
    am_err = (c_raw - p_raw).abs().max().item()
    n2 = 2 * c_plan["n_dense"]
    n_fine_mip = sum(ph[1] for ph in c_plan["phases_meta"][1:]
                     if ph[0] < kw["ratio_log2"])
    check(torch.equal(c_raw, p_raw) and torch.equal(c_ids, p_ids)
          and torch.equal(c_aux, p_aux),
          f"K1-argmax on the crop: raw, ids and aux bit-equal to the plain "
          f"argmax sweep ({int((c_ids >= n2).sum())} of {c_ids.numel()} "
          f"winners on mip levels, {int((c_ids >= n2 + n_fine_mip).sum())} "
          f"on coarse-derived ones)")
    g = torch.from_numpy(np.random.default_rng(7).normal(
        size=tuple(c_raw.shape)).astype(np.float32)).to(dev)
    c_bargs = (tuple(zf.shape), g, c_ids, c_aux, c_plan,
               replay.horizon_shifts(c_trig, c_plan))
    runs = [replay._bwd_cuda(*c_bargs) for _ in range(2)]
    p_cots, p_zcot = replay.backward_replay_plain(*c_bargs)
    torch.cuda.synchronize()
    check([tuple(c.shape) for c in runs[0][0]]
          == [tuple(t.shape) for t in sargs[2]],
          f"K3 on the crop: cotangents have the {len(p_cots)} combined "
          f"levels' shapes")
    reached = [lvl for lvl, c in enumerate(p_cots)
               if c.abs().max().item() > 0.0]
    check(0 in reached and max(reached) >= kw["ratio_log2"],
          f"K3 on the crop: levels {reached} receive cotangent, fine and "
          f"coarse-derived")
    bwd_err = check_replay("K3 on the crop", "K3",
                           [c + [z] for c, z in runs], p_cots + [p_zcot])
    print_levels("the crop")
    del (c_raw, c_ids, c_aux, p_ids, p_aux, g, c_bargs, runs, p_cots,
         p_zcot)
    del raw, p_raw, got, hori

    def grad_step():
        tf = zf.clone().requires_grad_(True)
        tc = zc.clone().requires_grad_(True)
        h = multires.horizon_sweep_multires_fused(tf, tc, **kw)
        torch.mean(h ** 2).backward()
        return tf.grad, tc.grad

    torch.cuda.reset_peak_memory_stats()
    event_ms(grad_step)
    peak_g = torch.cuda.max_memory_allocated()
    fused_sweep.ARGMAX_KERNEL_LAUNCHES = 0
    replay.KERNEL_LAUNCHES = 0
    steps = [event_ms(grad_step) for _ in range(2)]
    am_launches = fused_sweep.ARGMAX_KERNEL_LAUNCHES
    k3_launches = replay.KERNEL_LAUNCHES
    (ms_a, (gf, gc)), (ms_b, (gf2, gc2)) = steps
    print(f"  mean(h^2) + backward(): {ms_a:.2f} and {ms_b:.2f} ms between "
          f"CUDA events ({min(ms_a, ms_b) / (1e3 * wall):.3f} x the forward "
          f"wall); peak {peak_g / 2**20:.1f} MiB allocated  [{card}]")
    check(am_launches == 2 and k3_launches == 2,
          f"the gradient step launched K1-argmax ({am_launches}) and K3 "
          f"({k3_launches}) once per step in 2 steps")
    for what, g_ in (("z_fine", gf), ("z_coarse", gc)):
        check(bool(torch.isfinite(g_).all()) and g_.abs().max().item() > 0.0,
              f"{what}.grad finite and nonzero (max |g| "
              f"{g_.abs().max().item():.3e}, "
              f"{int((g_ != 0).sum())} cells)")
    check(torch.equal(gf, gf2) and torch.equal(gc, gc2),
          "both gradients bit-equal across two steps")
    del gf, gc, gf2, gc2, steps
    am = fused_sweep._ratio_cuda(*sargs, emit_argmax=True)
    am_ms = cuda_ms(lambda: fused_sweep._ratio_cuda(*sargs,
                                                    emit_argmax=True), 3)
    g = torch.ones_like(am[0]) / am[0].numel()
    bargs = (tuple(zf.shape), g, am[1], am[2], plan,
             replay.horizon_shifts(sargs[3], plan))
    replay._bwd_cuda(*bargs)
    k3_ms = cuda_ms(lambda: replay._bwd_cuda(*bargs), 3)
    print(f"  at this shape alone: K1-argmax {am_ms:.3f} ms, K3 {k3_ms:.3f} "
          f"ms  [{card}]")
    skip_report("K1-argmax (multires)", sargs, True, am_ms, card)
    print_levels("2 m cell")
    del am, g, bargs, sargs, crop, zf, zc
    mr_am_err, mr_bwd_err = am_err, bwd_err

    print("  horizon_gridded(vert_simp=...) on a mid-size scene")
    t0 = time.perf_counter()
    sc = tin_scene()
    print(f"  scene and TIN ({sc['tin']['num_tri_simp']} triangles) made on "
          f"the host in {time.perf_counter() - t0:.1f} s")
    gk = dict(azim_num=32, hori_acc=0.25, verbose=False, device=dev)
    fused_sweep.KERNEL_LAUNCHES = 0
    t0 = time.perf_counter()
    h_tin, _ = horizon.horizon_gridded(*sc["fine"], **gk, **sc["tin"])
    torch.cuda.synchronize()
    tin_s = time.perf_counter() - t0
    check(fused_sweep.KERNEL_LAUNCHES == 1, "the TIN route launched K1 once")
    h_full, _ = horizon.horizon_gridded(*sc["full"], **gk)
    d = torch.rad2deg((h_tin - h_full).abs())
    print(f"  TIN route {tuple(h_tin.shape)}: {tin_s:.2f} s wall (host "
          f"rasterisation included); against the full-resolution run: max "
          f"{d.max().item():.3f} deg, mean {d.mean().item():.4f} deg  "
          f"[{card}]")
    check(bool(torch.isfinite(h_tin).all()) and d.max().item() < 2.0
          and d.mean().item() < 0.25,
          "TIN route finite, within 2 deg of the full-resolution run "
          "everywhere and 0.25 deg (hori_acc) on average")
    return mr_am_err, mr_bwd_err


def srtm_shadow_scene(n=700, dlat=0.0012, lon0=-36.3, lat0=-54.35):
    """``examples/shadow/gridded_curved_dem_srtm.py``'s synthetic default:
    ``n``^2 lon/lat cells of ``dlat`` degree around (lon0, lat0), 20 bumps
    (seed 4), the inner domain 0.2 degree in from each side in lon and 0.15
    in lat, the WGS84 ENU mesh about its centre.  Returns the mesh (x, y,
    z), the inner slice, its normals, the lon/lat elevation and the ENU
    transformer."""
    lat = lat0 + (np.arange(n)[::-1] - n / 2) * dlat
    lon = lon0 + (np.arange(n) - n / 2) * dlat
    rng = np.random.default_rng(4)
    lon2, lat2 = np.meshgrid(lon, lat)
    elevation = np.zeros_like(lon2)
    for _ in range(20):
        clon = rng.uniform(lon.min(), lon.max())
        clat = rng.uniform(lat.min(), lat.max())
        sig = rng.uniform(0.01, 0.05)
        elevation += rng.uniform(300, 2500) * np.exp(
            -(((lon2 - clon) ** 2 + (lat2 - clat) ** 2) / (2 * sig ** 2)))
    elevation = elevation.astype(np.float32)
    dom = {"lon_min": float(lon.min()) + 0.2,
           "lon_max": float(lon.max()) - 0.2,
           "lat_min": float(lat.min()) + 0.15,
           "lat_max": float(lat.max()) - 0.15}
    trans = transform.TransformerEcef2enu(
        0.5 * (dom["lon_min"] + dom["lon_max"]),
        0.5 * (dom["lat_min"] + dom["lat_max"]), "WGS84")
    xe, ye, ze = transform.lonlat2ecef(lon2, lat2, elevation, "WGS84")
    x, y, z = transform.ecef2enu(xe, ye, ze, trans)
    sl = (slice(np.where(lat >= dom["lat_max"])[0][-1],
                np.where(lat <= dom["lat_min"])[0][0] + 1),
          slice(np.where(lon <= dom["lon_min"])[0][-1],
                np.where(lon >= dom["lon_max"])[0][0] + 1))
    vn_ecef = direction.surf_norm(lon2[sl], lat2[sl])
    vec_norm = transform.ecef2enu_vector(vn_ecef, trans)
    return x, y, z, sl, vec_norm, elevation, trans


def phase_l(dev, card):
    """Phase L: curved shadows at the defaults of
    ``examples/shadow/gridded_curved_dem_srtm.py``.  Returns the largest
    differences of K2-argmax and K4 to their plain versions on 4 suns."""
    print("== L. curved shadows: Terrain at the curved SRTM example's "
          "defaults")
    x, y, z, sl, vec_norm, elevation, trans = srtm_shadow_scene()
    sl1 = (slice(sl[0].start - 1, sl[0].stop + 1),
           slice(sl[1].start - 1, sl[1].stop + 1))

    def on_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    vec_tilt = topo_param.slope_vector_meth(on_dev(x[sl1]), on_dev(y[sl1]),
                                            on_dev(z[sl1]))[1:-1, 1:-1]
    surf = topo_param.surface_enlargement_factor(on_dev(vec_norm), vec_tilt)
    check(vec_tilt.is_cuda and bool(torch.isfinite(vec_tilt).all())
          and surf.min().item() > 0.999,
          f"slope_vector_meth and the surface enlargement factor on the "
          f"card: finite, factor [{surf.min().item():.3f}, "
          f"{surf.max().item():.3f}]")
    inner = tuple(vec_tilt.shape[:2])
    terrain = shadow.Terrain()
    t0 = time.perf_counter()
    terrain.initialise(auxiliary.rearrange_pad_buffer(x, y, z),
                       x.shape[0], x.shape[1], sl[0].start, sl[1].start,
                       vec_tilt.contiguous(), vec_norm, surf,
                       np.ascontiguousarray(elevation[sl]),
                       np.ones(inner, np.uint8), refrac_cor=True,
                       device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    times = [np.datetime64("2026-01-15") + np.timedelta64(h, "h")
             for h in range(25)]
    suns = sun_position.sun_position_enu(times, trans)
    back = terrain._back
    print(f"  mesh {x.shape}, inner {inner}; lattice "
          f"{tuple(terrain._z_outer.shape)} at {terrain.grid.dx:.2f} m, box "
          f"{terrain.comp_shape} at {terrain.offset}, up to "
          f"{back[2].shape[1]} cells per box cell; plan "
          f"{terrain.plan['n_dense']} dense steps, "
          f"{len(terrain.plan['phases_meta']) - 1} mip phases")
    print(f"  initialise {init_s:.3f} s wall: host planarisation "
          f"{terrain.planarize_s:.3f} s, the rest (box, normals, back-map, "
          f"pyramid, fields) {init_s - terrain.planarize_s:.3f} s  [{card}]")
    terrain.sw_dir_cor_batch(suns)
    terrain.shadow_batch(suns)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    shadow_sweep.KERNEL_LAUNCHES = 0
    walls = {"sw_dir_cor_batch": [], "shadow_batch": []}
    for _ in range(3):
        for name in walls:
            t0 = time.perf_counter()
            out = getattr(terrain, name)(suns)
            torch.cuda.synchronize()
            walls[name].append(time.perf_counter() - t0)
            if name == "sw_dir_cor_batch":
                sw = out
            else:
                codes = out
    launches = shadow_sweep.KERNEL_LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    print("  " + "; ".join(
        f"{k} median {np.median(v):.4f} s wall of 3 (min {min(v):.4f}, max "
        f"{max(v):.4f})" for k, v in walls.items())
        + f"; peak {peak / 2**20:.1f} MiB allocated  [{card}]")
    check(launches == 6, f"the curved queries launched K2 ({launches} "
          f"launches in 6 queries)")
    check(tuple(sw.shape) == (25,) + inner and sw.is_cuda
          and bool(torch.isfinite(sw).all()), "sw_dir_cor shape, device, "
          "finite")
    counts = torch.bincount(codes.flatten().long(), minlength=4)
    lit = (codes == 0).float().mean(dim=(1, 2))
    print(f"  shadow codes {counts.tolist()}; illuminated share per hour "
          f"{np.array2string(lit.cpu().numpy(), precision=2)}")
    check(codes.dtype == torch.uint8 and counts[3].item() == 0
          and counts[0].item() > 0 and counts[2].item() > 0,
          "codes in {0, 1, 2}, some cells lit and some terrain-shaded")
    t0 = time.perf_counter()
    plain_codes = terrain._run(suns, "shadow", plain=True)
    check(torch.equal(plain_codes, codes),
          f"the codes of all 25 suns (sign-exact K2 on the box, read back at "
          f"the cells) equal those from the plain exact metric "
          f"({time.perf_counter() - t0:.1f} s)")
    del sw, codes, plain_codes
    fld = terrain._fields

    def terrain_args(sun_rows):
        table_f, _ = shadow_sweep.shadow_sun_table(
            sun_rows, terrain._center, terrain.grid.dx, terrain.grid.dy)
        return shadow_sweep.metric_args(
            terrain._z_outer, fld["z_org_r"], fld["z_inner_r"], table_f,
            offset=terrain.offset, inner_shape=terrain.comp_shape,
            dx=terrain.grid.dx, dy=terrain.grid.dy, hori_acc=terrain.acc,
            pyramid=terrain._levels, pooled=terrain._pooled)

    largs = terrain_args(suns)
    origin, pooled = terrain._grid_origin, terrain._pooled

    def k2_l():
        return shadow_sweep._metric_cuda(*largs, grid_origin=origin,
                                         exact_metric=False, pooled=pooled)

    k2_l()
    k2_ms = cuda_ms(k2_l, 3)
    model, m_counts = shadow_sweep.metric_model(
        *largs, grid_origin=origin, exact_metric=False, pooled=pooled)
    check(torch.equal(k2_l(), model), "sign-exact K2 bit-equal to its plain "
          "model on the box, all 25 suns")
    del model
    print(f"  K2 sign-exact alone on the box: {k2_ms:.3f} ms for 25 suns  "
          f"[{card}]")
    skip_report("K2 sign-exact (curved box, 25 suns)", largs, False, k2_ms,
                card, k2_counted(largs, origin, exact_metric=False,
                                 pooled=pooled), m_counts)

    hard = terrain.sw_dir_cor_batch(suns)
    soft = terrain.sw_dir_cor_soft(suns)
    check(torch.equal(soft, hard) and soft.grad_fn is None,
          "straight-through value bit-equal to sw_dir_cor_batch (no "
          "gradient asked)")
    del soft

    def soft_step():
        zg = terrain._z_outer.clone().requires_grad_(True)
        out = terrain.sw_dir_cor_soft(suns, elevation=zg)
        out.mean().backward()
        return out.detach(), zg.grad

    soft_step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    shadow_sweep.ARGMAX_KERNEL_LAUNCHES = 0
    replay.SHADOW_KERNEL_LAUNCHES = 0
    s_walls, grads = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        out, gz = soft_step()
        torch.cuda.synchronize()
        s_walls.append(time.perf_counter() - t0)
        grads.append(gz)
    k2a = shadow_sweep.ARGMAX_KERNEL_LAUNCHES
    k4 = replay.SHADOW_KERNEL_LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    print(f"  sw_dir_cor_soft + mean().backward(), 25 suns: median "
          f"{np.median(s_walls):.4f} s wall of 3 (min {min(s_walls):.4f}, "
          f"max {max(s_walls):.4f}); peak {peak / 2**20:.1f} MiB allocated  "
          f"[{card}]")
    check(k2a == 3 and k4 == 3, f"the curved soft step launched K2-argmax "
          f"({k2a}) and K4 ({k4}) once per step in 3 steps")
    check(torch.equal(out, hard), "straight-through value with a gradient "
          "asked bit-equal to sw_dir_cor_batch")
    (o0, o1), (c0, c1) = terrain.offset, terrain.comp_shape
    check(bool(torch.isfinite(gz).all())
          and gz[o0:o0 + c0, o1:o1 + c1].abs().max().item() > 0.0,
          f"lattice elevation.grad finite and nonzero on the box (max |g| "
          f"{gz.abs().max().item():.3e})")
    check(torch.equal(grads[-1], grads[-2]), "lattice elevation.grad "
          "bit-equal across runs (the read-back's backward in a fixed order)")
    del hard, out, gz, grads

    def k2a_l():
        return shadow_sweep._metric_cuda(*largs, grid_origin=origin,
                                         emit_argmax=True, pooled=pooled)

    k2a_l()
    k2a_ms = cuda_ms(k2a_l, 3)
    met, ids, aux = k2a_l()
    g = torch.from_numpy(np.random.default_rng(11).normal(
        size=tuple(met.shape)).astype(np.float32)).to(dev)
    lb = (tuple(terrain._z_outer.shape), g, ids, aux, largs[4])
    shadow_l = (largs[3], largs[0], origin)
    replay._bwd_cuda(*lb, shadow=shadow_l)
    k4_ms = cuda_ms(lambda: replay._bwd_cuda(*lb, shadow=shadow_l), 3)
    cots, dzo = replay._bwd_cuda(*lb, shadow=shadow_l)
    k4_bound = replay_bound(g, ids, aux, largs[4], cots, dzo, shadow=True)
    print(f"  on the 25 suns alone: K2-argmax {k2a_ms:.3f} ms, K4 "
          f"{k4_ms:.3f} ms (bound {k4_bound[0]:.4f} ms, {k4_bound[1]}); the "
          f"rest of a soft step (classification, read-back and their "
          f"backward, pyramid and its VJP, host) "
          f"{1e3 * float(np.median(s_walls)) - k2a_ms - k4_ms:.1f} ms  "
          f"[{card}]")
    skip_report("K2-argmax (curved box, 25 suns)", largs, True, k2a_ms, card,
                k2_counted(largs, origin, emit_argmax=True, pooled=pooled))
    del met, ids, aux, g, lb, shadow_l, cots, dzo
    few = [6, 10, 14, 18]
    fargs = terrain_args(suns[few])
    sa_err = check_shadow_argmax(f"curved box, suns {few}", fargs, origin)[0]
    g = torch.from_numpy(np.random.default_rng(12).normal(
        size=(len(few),) + terrain.comp_shape).astype(np.float32)).to(dev)
    sb_err = check_shadow_replay(f"curved box, suns {few}", fargs, origin,
                                 g)[0]
    return sa_err, sb_err


def locations_scene(n=700, dlat=0.0012, lon0=8.0, lat0=46.5):
    """``examples/horizon/locations_curved_dem.py``'s default terrain:
    ``n``^2 lon/lat cells of ``dlat`` degree around (lon0, lat0), 25 bumps
    (seed 1), the WGS84 ENU mesh about (lon0, lat0).  Returns the vertex
    buffer, the mesh (x, y, z) and the transformer."""
    lat = lat0 + (np.arange(n)[::-1] - n / 2) * dlat
    lon = lon0 + (np.arange(n) - n / 2) * dlat
    lon2, lat2 = np.meshgrid(lon, lat)
    rng = np.random.default_rng(1)
    elevation = np.zeros_like(lon2)
    for _ in range(25):
        clon = rng.uniform(lon.min(), lon.max())
        clat = rng.uniform(lat.min(), lat.max())
        sig = rng.uniform(0.01, 0.06)
        elevation += rng.uniform(300, 2000) * np.exp(
            -(((lon2 - clon) ** 2 + (lat2 - clat) ** 2) / (2 * sig ** 2)))
    elevation = elevation.astype(np.float32)
    trans = transform.TransformerEcef2enu(lon0, lat0, "WGS84")
    xe, ye, ze = transform.lonlat2ecef(lon2, lat2, elevation, "WGS84")
    x, y, z = transform.ecef2enu(xe, ye, ze, trans)
    return auxiliary.rearrange_pad_buffer(x, y, z), (x, y, z), trans


def location_vectors(loc_lon, loc_lat, trans):
    """Coordinates (surface point, h = 0) and unit normals and north
    vectors of locations, as the example forms them."""
    lxe, lye, lze = transform.lonlat2ecef(
        loc_lon, loc_lat, np.zeros(len(loc_lon), dtype=np.float32), "WGS84")
    lx, ly, lz = transform.ecef2enu(lxe, lye, lze, trans)
    coords = np.stack([lx, ly, lz], axis=-1).astype(np.float32)
    vn_ecef = direction.surf_norm(loc_lon, loc_lat)
    vnorth_ecef = direction.north_dir(lxe, lye, lze, vn_ecef, "WGS84")
    return (coords, transform.ecef2enu_vector(vn_ecef, trans),
            transform.ecef2enu_vector(vnorth_ecef, trans))


def phase_m(dev, card):
    """Phase M: per-location horizons at the defaults of
    ``examples/horizon/locations_curved_dem.py``, then at 10,000
    locations."""
    print("== M. per-location horizons: horizon_locations on the curved "
          "example's mesh")
    vg, (x, y, z), trans = locations_scene()
    t0 = time.perf_counter()
    pg = regrid.planarize(x, y, z)
    plan_s = time.perf_counter() - t0
    kw = dict(dist_search=20.0, azim_num=360, hori_dist_out=True)
    names = {"peak": (8.005, 46.505), "valley": (7.95, 46.45),
             "ridge": (8.06, 46.56)}
    loc = location_vectors(np.array([v[0] for v in names.values()]),
                           np.array([v[1] for v in names.values()]), trans)
    schedule = sweep.build_schedule(min(abs(pg.grid.dx), abs(pg.grid.dy)),
                                    20000.0, sweep.default_rel_err(0.25))
    chunk = locations.chunk_size(schedule, 360)
    z_dev = torch.from_numpy(pg.z).to(dev)
    azim = horizon.azimuth_angles(360)

    def sweep_only(c, vn, vno, device=dev):
        return locations.horizon_locations_sweep(
            z_dev.to(device), pg.grid, c, vn, vno, azim, 20000.0, 0.25,
            -89.98, np.float32([0.01]))

    print(f"  mesh {x.shape}, lattice {pg.grid.shape} at "
          f"{abs(pg.grid.dx):.2f} m (host planarisation {plan_s:.3f} s); "
          f"{schedule.num_samples} samples per (location, azimuth) at 20 km, "
          f"{chunk} locations per chunk ({locations.MAX_GATHER_ELEMS} "
          f"elements a gather)")
    for what, (c, vn, vno) in (("3 named", loc),
                               ("10,000", (None, None, None))):
        if c is None:
            rng = np.random.default_rng(0)
            lons = rng.uniform(8.0 - 0.15, 8.0 + 0.15, 10000)
            lats = rng.uniform(46.5 - 0.15, 46.5 + 0.15, 10000)
            c, vn, vno = location_vectors(lons, lats, trans)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        hori, dist, az = horizon.horizon_locations(
            vg, x.shape[0], x.shape[1], c, vn, vno, device=dev, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        sweep_only(c, vn, vno)
        s_ms, (h2, d2) = event_ms(lambda: sweep_only(c, vn, vno))
        n_loc = len(c)
        print(f"  {what} locations: horizon_locations {wall:.3f} s wall, of "
              f"which the sweep alone {s_ms:.1f} ms ({-(-n_loc // chunk)} "
              f"chunk(s)) and host planarisation about {plan_s:.3f} s; peak "
              f"{peak / 2**20:.1f} MiB allocated  [{card}]")
        check(hori.is_cuda and tuple(hori.shape) == (n_loc, 360)
              and bool(torch.isfinite(hori).all())
              and bool(torch.isfinite(dist).all())
              and dist.min().item() > 0.0 and torch.equal(hori, h2)
              and torch.equal(dist, d2),
              f"{what}: hori and hori_dist finite, of shape ({n_loc}, 360), "
              f"the sweep alone equal to the entry's")
        if n_loc == 3:
            for i, name in enumerate(names):
                print(f"  {name}: mean horizon "
                      f"{np.rad2deg(hori[i].mean().item()):.2f} deg, max "
                      f"{np.rad2deg(hori[i].max().item()):.2f} deg, mean "
                      f"distance {dist[i].mean().item() / 1e3:.1f} km")
            check(bool((hori.max(dim=1).values > 0.0).all()),
                  "each named location sees terrain above its horizontal")
        else:
            pick = np.random.default_rng(1).choice(n_loc, 64, replace=False)
            t0 = time.perf_counter()
            hc, dc = sweep_only(c[pick], vn[pick], vno[pick], device="cpu")
            cpu_s = time.perf_counter() - t0
            pk = torch.from_numpy(pick).to(dev)
            err = (hori[pk].cpu() - hc).abs().max().item()
            derr = ((dist[pk].cpu() - dc).abs() / dc).max().item()
            check(err <= 1e-6 and derr <= 1e-6,
                  f"64 of the 10,000 against the CPU path ({cpu_s:.1f} s): "
                  f"max |hori - cpu| {err:.2e} rad, hori_dist {derr:.2e} "
                  f"relative, within 1e-6")

def bench_vectors(z, x, y, halo, inner):
    """``vec_norm`` of the bench's inner block from the terrain's own
    slope (``topo_param.slope_plane_meth`` on the block and a one-cell
    ring) and ``vec_north`` (0, 1, 0) made orthogonal to it, both unit,
    (inner, inner, 3) float32; and the slope's tilt vectors."""
    sl1 = slice(halo - 1, halo + inner + 1)
    xx, yy = np.meshgrid(x[sl1], y[sl1])
    tilt = topo_param.slope_plane_meth(xx, yy, z[sl1, sl1]).numpy()[1:-1,
                                                                   1:-1]
    norm = tilt.astype(np.float64)
    north = np.zeros_like(norm)
    north[..., 1] = 1.0
    north -= np.sum(north * norm, axis=-1, keepdims=True) * norm
    north /= np.linalg.norm(north, axis=-1, keepdims=True)
    return (np.ascontiguousarray(norm, np.float32),
            np.ascontiguousarray(north, np.float32),
            np.ascontiguousarray(tilt, np.float32))


def engine_terrain(z, x, y, off, inner, engine, dev):
    """A planar ``Terrain`` on the heights ``z`` with the vertices at ``x``,
    ``y`` (north up), the inner block ``inner`` at ``off`` with unit
    normals, the slope's tilt and no mask, on ``engine`` and ``dev``."""
    sl1 = (slice(off[0] - 1, off[0] + inner[0] + 1),
           slice(off[1] - 1, off[1] + inner[1] + 1))
    xx, yy = np.meshgrid(x, y)
    vec_tilt = np.ascontiguousarray(topo_param.slope_plane_meth(
        xx[sl1], yy[sl1], z[sl1]).numpy()[1:-1, 1:-1])
    vec_norm = np.zeros(inner + (3,), np.float32)
    vec_norm[..., 2] = 1.0
    t = shadow.Terrain()
    t.initialise(auxiliary.rearrange_pad_buffer(xx, yy, z), z.shape[0],
                 z.shape[1], off[0], off[1], vec_tilt, vec_norm,
                 topo_param.surface_enlargement_factor(vec_norm,
                                                       vec_tilt).numpy(),
                 np.ascontiguousarray(z[off[0]:off[0] + inner[0],
                                        off[1]:off[1] + inner[1]]),
                 np.ones(inner, np.uint8), engine=engine, device=dev)
    return t


def bench_track(n_sun=16):
    """bench.py:420-446's sun track, relative to the domain centre."""
    tt = np.linspace(0.15, 2.9, n_sun)
    return list(zip(3.0e5 * np.cos(tt), 3.0e5 * np.sin(tt),
                    2.0e4 + 1.0e4 * np.sin(2 * tt)))


def phase_n(dev, card, z, x, y, halo, azim_num, dist_km, k1_ms):
    """Phase N: the reference's XLA engines in plain torch at full width,
    and K2-mask.  Returns the K2-mask row's numbers (launches, error, ms,
    plain ms, bound)."""
    print("== N. the XLA engines (plain torch) and K2-mask")
    n, inner = z.shape[0], z.shape[0] - 2 * halo
    xx, yy = np.meshgrid(x, y)
    vert_grid = auxiliary.rearrange_pad_buffer(xx, yy, z)
    del xx, yy
    vec_norm, vec_north, _ = bench_vectors(z, x, y, halo, inner)
    vn0 = np.zeros_like(vec_norm)
    vn0[..., 2] = 1.0
    vno0 = np.zeros_like(vec_norm)
    vno0[..., 1] = 1.0
    hz_kw = dict(dist_search=dist_km, azim_num=azim_num, hori_acc=0.25,
                 verbose=False)
    chunk = sweep.azimuth_chunk(azim_num, (inner, inner))

    # the general geometry at the bench cell (non-default vectors take the
    # XLA engine's per-cell basis whatever the engine)
    def general():
        return horizon.horizon_gridded(vert_grid, n, n, vec_norm, vec_north,
                                       halo, halo, device=dev, **hz_kw)[0]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    g_wall, g_min, g_max, hg = wall_runs(general, 2)
    peak = torch.cuda.max_memory_allocated()
    tilt = np.degrees(np.arccos(np.clip(vec_norm[..., 2], -1.0, 1.0)))
    print(f"  general basis (vec_norm from the slope: tilt up to "
          f"{tilt.max():.1f} deg, mean {tilt.mean():.1f}), {inner}^2 x "
          f"{azim_num} azimuths at {dist_km:g} km: median {g_wall:.3f} s "
          f"wall of 2 (min {g_min:.3f}, max {g_max:.3f}), {chunk} azimuths "
          f"per chunk, peak {peak / 2**20:.1f} MiB allocated "
          f"({base / 2**20:.1f} MiB before)  [{card}]")
    check(tuple(hg.shape) == (inner, inner, azim_num) and hg.is_cuda
          and bool(torch.isfinite(hg).all()), "general: shape, device, "
          "finite")
    # the same call on a 64^2 block (and its 20 km halo) on the card and
    # on the CPU, within the CPU tests' tolerance
    c0, cn = halo + inner // 2 - 32, 64
    cr = int(round(dist_km * 1000.0 / float(x[1] - x[0])))
    sl = slice(c0 - cr, c0 + cn + cr)
    cxx, cyy = np.meshgrid(x[sl], y[sl])
    cvg = auxiliary.rearrange_pad_buffer(cxx, cyy, z[sl, sl])
    cnorm = vec_norm[c0 - halo:c0 - halo + cn, c0 - halo:c0 - halo + cn]
    cnorth = vec_north[c0 - halo:c0 - halo + cn, c0 - halo:c0 - halo + cn]
    m = cn + 2 * cr
    t0 = time.perf_counter()
    crop = [horizon.horizon_gridded(cvg, m, m, np.ascontiguousarray(cnorm),
                                    np.ascontiguousarray(cnorth), cr, cr,
                                    device=d, **hz_kw)[0].cpu()
            for d in (dev, "cpu")]
    err = (crop[0] - crop[1]).abs().max().item()
    print(f"  the general basis on a {cn}^2 block: card against the CPU "
          f"path max |d hori| {err:.3e} rad ({time.perf_counter() - t0:.1f}"
          f" s for both)")
    check(err <= 2.4e-7, "general basis on the card within 2.4e-7 rad of "
          "the CPU path")
    del hg, crop

    # the planar sweep engine on default vectors beside K1
    def planar(engine):
        return horizon.horizon_gridded(vert_grid, n, n, vn0, vno0, halo,
                                       halo, engine=engine, device=dev,
                                       **hz_kw)[0]

    p_wall, p_min, p_max, hs = wall_runs(lambda: planar("sweep"), 2)
    f_wall, _, _, hf = wall_runs(lambda: planar("auto"), 2)
    d = (hs - hf).abs()
    print(f"  planar engine='sweep': median {p_wall:.3f} s wall of 2 (min "
          f"{p_min:.3f}, max {p_max:.3f}); the fused route {f_wall:.4f} s "
          f"(K1 alone {k1_ms:.3f} ms), {p_wall / f_wall:.1f}x; the two "
          f"estimators differ by up to {np.degrees(d.max().item()):.4f} deg "
          f"(mean {np.degrees(d.mean().item()):.5f})  [{card}]")
    check(bool(torch.isfinite(hs).all()), "planar sweep engine finite")
    del hs, hf, d

    # Terrain's XLA engines on the bench's shadow row: 2048^2 / 1024^2,
    # its 16 suns
    cx = 0.5 * (float(x[0]) + float(x[-1]))
    cy = 0.5 * (float(y[0]) + float(y[-1]))
    suns = np.array([[cx + a, cy + b, c] for a, b, c in bench_track()],
                    np.float32)
    codes = {}
    for engine in ("pallas", "sweep", "scan"):
        t0 = time.perf_counter()
        ter = engine_terrain(z, x, y, (halo, halo), (inner, inner), engine,
                             dev)
        init_s = time.perf_counter() - t0
        wall, w_min, _, codes[engine] = wall_runs(
            lambda: ter.shadow_batch(suns), 1)
        sw = ter.sw_dir_cor_batch(suns)
        check(codes[engine].is_cuda and bool(torch.isfinite(sw).all()),
              f"Terrain(engine={engine!r}): codes on the card, sw_dir_cor "
              f"finite")
        print(f"  Terrain(engine={engine!r}): initialise {init_s:.2f} s, "
              f"shadow_batch of 16 suns {wall:.3f} s wall, {wall / 16:.4f} s "
              f"per sun; {codes[engine].eq(2).float().mean().item():.4f} "
              f"terrain-shaded  [{card}]")
        del ter, sw
    for engine in ("sweep", "scan"):
        same = codes[engine].eq(codes["pallas"]).float().mean().item()
        print(f"  {engine}: {same:.5f} of the codes equal to the fused "
              f"engine's")
        check(same > 0.95, f"{engine}: codes agree with the fused engine on "
              f"most cells")
    del codes
    # both engines on a 512^2 crop (64^2 inner) on the card and the CPU
    c0 = n // 2 - 256
    zc_ = np.ascontiguousarray(z[c0:c0 + 512, c0:c0 + 512])
    csuns = np.array([[0.5 * (float(x[c0]) + float(x[c0 + 511])) + a,
                       0.5 * (float(y[c0]) + float(y[c0 + 511])) + b, c]
                      for a, b, c in bench_track()[::8]], np.float32)
    for engine in ("sweep", "scan"):
        out = []
        for d_ in (dev, "cpu"):
            ter = engine_terrain(zc_, x[c0:c0 + 512], y[c0:c0 + 512],
                                 (224, 224), (64, 64), engine, d_)
            f = ter._fields
            met, _ = ter._xla_metric(csuns, f["z_org_r"], f["z_inner_r"],
                                     ter._levels, scan=engine == "scan")
            out.append((met.cpu(), ter.shadow_batch(csuns).cpu()))
        check(torch.equal(out[0][0], out[1][0])
              and torch.equal(out[0][1], out[1][1]),
              f"Terrain(engine={engine!r}) on a 64^2 block: the card's "
              f"metric and codes equal to the CPU's")

    # the XLA multires engine at the 2 m example's defaults
    zf_np, zc_np, mkw = multires_2m_scene()
    zf = torch.from_numpy(zf_np).to(dev)
    zc = torch.from_numpy(zc_np).to(dev)
    a_num = mkw.pop("azim_num")
    fused_wall, _, _, _ = wall_runs(
        lambda: multires.horizon_sweep_multires_fused(zf, zc, azim_num=a_num,
                                                      **mkw), 1)
    torch.cuda.reset_peak_memory_stats()
    x_wall, _, _, hx = wall_runs(
        lambda: multires.horizon_sweep_multires(
            zf, zc, azim=horizon.azimuth_angles(a_num), **mkw), 1)
    peak = torch.cuda.max_memory_allocated()
    check(bool(torch.isfinite(hx).all()) and hx.max().item() > 0.0,
          "XLA multires finite and above the plane")
    print(f"  horizon_sweep_multires (XLA engine), {mkw['inner_shape']} x "
          f"{a_num} azimuths: {x_wall:.3f} s wall, peak "
          f"{peak / 2**20:.1f} MiB; horizon_sweep_multires_fused "
          f"{fused_wall:.4f} s ({x_wall / fused_wall:.1f}x)  [{card}]")
    del zf, zc, hx

    # K2-mask on the island and disc masks, 16 suns, both arms
    zt = torch.from_numpy(z).to(dev)
    z_org, z_in, table, kw = shadow_inputs(zt, (halo, halo), (inner, inner),
                                           float(x[1] - x[0]),
                                           -float(x[1] - x[0]), (0.0, 0.0),
                                           bench_track())
    sargs = shadow_sweep.metric_args(
        zt, z_org, z_in, table,
        **{k: kw[k] for k in ("offset", "inner_shape", "dx", "dy")})
    masks = {k: torch.from_numpy(v).to(dev)
             for k, v in bench_mask_set(inner).items()
             if k in ("island", "disc")}
    shadow_sweep.MASK_KERNEL_LAUNCHES = 0
    got = {(k, e): shadow_sweep.shadow_metric_fused(
        zt, z_org, z_in, table, mask=mk, exact_metric=e, **kw)
        for k, mk in masks.items() for e in (True, False)}
    torch.cuda.synchronize()
    launches = shadow_sweep.MASK_KERNEL_LAUNCHES
    check(launches == 4, f"K2-mask launched once per call ({launches} in "
          f"4 calls)")
    n_blk = (-(-inner // fused_sweep.BLOCK_ROWS)
             * -(-inner // fused_sweep.BLOCK_COLS))
    times = {}
    for exact in (True, False):
        dense = shadow_sweep._metric_cuda(*sargs, grid_origin=(0.0, 0.0),
                                          exact_metric=exact)
        dense_ms = cuda_ms(lambda: shadow_sweep._metric_cuda(
            *sargs, grid_origin=(0.0, 0.0), exact_metric=exact), 10)
        for k, mk in masks.items():
            live = shadow_sweep.live_cells(mk)
            res = got[(k, exact)]
            check(torch.equal(res[:, live], dense[:, live])
                  and bool((res[:, ~live] == np.float32(-3.0e38)).all()),
                  f"K2-mask ({k}, exact_metric={exact}): live blocks "
                  f"bit-equal to the dense K2, the rest -3e38")
            ms = cuda_ms(lambda: shadow_sweep._metric_cuda(
                *sargs, grid_origin=(0.0, 0.0), exact_metric=exact,
                mask=mk), 10)
            times[(k, exact)] = ms
            n_live = fused_sweep.live_blocks(mk).shape[0]
            share = mk.float().mean().item()
            print(f"  K2-mask {k} (exact_metric={exact}): {share:.4f} "
                  f"considered, {n_live / n_blk:.4f} of the "
                  f"blocks live; {ms:.3f} ms against the dense K2's "
                  f"{dense_ms:.3f} ms (mean of 10), {dense_ms / ms:.2f}x "
                  f"faster  [{card}]")
        del dense
    island = masks["island"]
    plain_ms, plain = event_ms(lambda: shadow_sweep._metric_plain(
        *sargs, grid_origin=(0.0, 0.0), mask=island))
    err = (got[("island", True)] - plain).abs().max().item()
    check(torch.equal(got[("island", True)], plain), "K2-mask bit-equal to "
          "its plain version on the island, full output")
    del plain, got
    live_u8 = shadow_sweep.live_cells(island).to(torch.uint8)
    bnd = skip_report("K2-mask (island)", sargs + (None, live_u8), False,
                      times[("island", True)], card,
                      k2_counted(sargs, (0.0, 0.0), mask=island))
    return launches, err, times[("island", True)], plain_ms, bnd


def shard_k1_ms(fwd, emit_argmax, reps=3):
    """Milliseconds of each slot's launch of K1 (``emit_argmax``:
    K1-argmax) in the sharded run ``fwd`` (``shard._HzForward``), by CUDA
    events, on the inputs ``fwd.run`` cuts for it."""
    out = []
    for t, a, dev in fwd.mesh.local_slots():
        r0, az0 = t * fwd.rows, a * fwd.az_loc
        levels, pooled = fwd.slot_levels(t, dev)
        args = (fwd.z_org[r0:r0 + fwd.rows].contiguous(),
                fwd.z_inner[r0:r0 + fwd.rows].contiguous(), levels,
                fwd.trig[az0:az0 + fwd.az_loc], fwd.slot_plan(t),
                fwd.outer_shape)

        def launch(args=args, pooled=pooled):
            return fused_sweep._ratio_cuda(*args, emit_argmax=emit_argmax,
                                           pooled=pooled)

        launch()
        out.append(cuda_ms(launch, reps))
    return out


def shard_k2_ms(mesh, sargs, origin, emit_argmax, reps=3):
    """Milliseconds of each tile's launch of K2 (K2-argmax) in a sharded
    metric over ``sargs`` (``shadow_sweep.metric_args``), by CUDA events."""
    z_org, z_inner, levels, table, plan, shape = sargs
    rows = plan["inner_shape"][0] // mesh.shape[parallel.AXIS_TILE]
    pooled = fused_sweep.skip_inputs(levels, plan)
    out = []
    for t, a, _ in mesh.local_slots():
        if a:
            continue
        args = (z_org[t * rows:(t + 1) * rows].contiguous(),
                z_inner[t * rows:(t + 1) * rows].contiguous(), levels, table,
                fused_sweep.shard_plan(plan, t * rows, rows), shape, origin)

        def launch(args=args):
            return shadow_sweep._metric_cuda(*args, emit_argmax=emit_argmax,
                                             pooled=pooled)

        launch()
        out.append(cuda_ms(launch, reps))
    return out


#: Keywords of the two-process run of phase O: a 512^2 grid, 256^2 inner.
PAIR_KW = dict(dx=25.0, dy=-25.0, offset=(128, 128), inner_shape=(256, 256),
               azim_num=8, dist_search=3000.0, hori_acc=0.25)


def pair_worker(rank, port):
    """One process of phase O's pair: a gloo group of two on one card,
    each process two slots of a (2, 2) mesh on cuda:0; the assembled angles
    and the gradient against the single launch.  Returns the exit code."""
    import torch.distributed as dist
    dev = torch.device("cuda", 0)
    mesh = parallel.init_distributed(
        n_azim=2, coordinator_address=f"127.0.0.1:{port}", num_processes=2,
        process_id=rank, devices=[dev] * 2, backend="gloo")
    z = torch.from_numpy(make_terrain(512, 512, seed=3)).to(dev)
    zg = z.clone().requires_grad_(True)
    got = shard.horizon_sweep_fused_sharded(mesh, zg, **PAIR_KW)
    torch.mean(got ** 2).backward()
    zs = z.clone().requires_grad_(True)
    want = fused_sweep.horizon_sweep_fused(zs, **PAIR_KW)
    torch.mean(want ** 2).backward()
    ok = (torch.equal(got, want) and torch.equal(zg.grad, zs.grad)
          and [t for t, _, _ in mesh.local_slots()] == [rank, rank])
    print(json.dumps({"rank": rank, "world": mesh.world,
                      "angles_equal": torch.equal(got, want),
                      "grad_equal": torch.equal(zg.grad, zs.grad)}),
          flush=True)
    dist.destroy_process_group()
    return 0 if ok else 1


def run_pair():
    """Phase O's two processes on the one card; fails the run if either
    fails.  Returns the wall [s]."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    env = {k: v for k, v in os.environ.items()
           if k not in ("HZT_COORDINATOR", "HZT_NUM_PROCESSES",
                        "HZT_PROCESS_ID")}
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--pair-worker",
         str(rank), str(port)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env) for rank in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for rank, (p, out) in enumerate(zip(procs, outs)):
        for line in out.strip().splitlines()[-3:]:
            print(f"  process {rank}: {line}")
        check(p.returncode == 0, f"process {rank} of the pair exited "
              f"{p.returncode}")
    return wall


def phase_o(dev, card, zt, halo, inner, azim_num, dist_km, dx, track,
            single):
    """The sharded entries (horayzon_tpu_torch.parallel) with the shards of
    a mesh in turn on this card.  ``single``: the single launches' times,
    plain times and bounds from the earlier phases.  Returns the four
    ``*-shard`` rows of the kernels line."""
    print("== O. sharded: the shards of a mesh in turn on one card")
    t_o = time.perf_counter()
    mesh42 = parallel.make_mesh(4, 2, devices=[dev] * 8)
    mesh81 = parallel.make_mesh(8, 1, devices=[dev] * 8)
    sweep_kw = dict(dx=dx, dy=-dx, offset=(halo, halo),
                    inner_shape=(inner, inner), azim_num=azim_num,
                    dist_search=dist_km * 1000.0, hori_acc=0.25)
    z_org_b, z_in_b, table_b, kw_b = shadow_inputs(
        zt, (halo, halo), (inner, inner), dx, -dx, (0.0, 0.0), track)
    zf_np, zc_np, mkw = multires_2m_scene()
    zf, zc = torch.from_numpy(zf_np).to(dev), torch.from_numpy(zc_np).to(dev)
    del zf_np, zc_np

    def hz_grad():
        zg = zt.clone().requires_grad_(True)
        h = shard.horizon_sweep_fused_sharded(mesh42, zg, **sweep_kw)
        torch.mean(h ** 2).backward()
        return zg.grad

    def sh_grad():
        zg = zt.clone().requires_grad_(True)
        z_i = zg[halo:halo + inner, halo:halo + inner]
        met = shard.shadow_metric_fused_sharded(mesh81, zg, z_i + 0.05, z_i,
                                                table_b, **kw_b)
        torch.mean(torch.sigmoid(met / 2.0)).backward()
        return zg.grad

    # warm-up of every sharded path, then the main path with the counts
    shard.horizon_sweep_fused_sharded(mesh42, zt, **sweep_kw)
    hz_grad()
    shard.shadow_metric_fused_sharded(mesh81, zt, z_org_b, z_in_b, table_b,
                                      **kw_b)
    sh_grad()
    shard.horizon_sweep_multires_fused_sharded(mesh42, zf, zc, **mkw)
    torch.cuda.synchronize()
    fused_sweep.SHARD_KERNEL_LAUNCHES = 0
    shadow_sweep.SHARD_KERNEL_LAUNCHES = 0
    replay.SHARD_KERNEL_LAUNCHES = 0
    replay.SHADOW_SHARD_KERNEL_LAUNCHES = 0
    ms = {}
    ms["hz"], hz = event_ms(lambda: shard.horizon_sweep_fused_sharded(
        mesh42, zt, **sweep_kw))
    ms["hz_grad"], gz = event_ms(hz_grad)
    ms["sh"], met = event_ms(lambda: shard.shadow_metric_fused_sharded(
        mesh81, zt, z_org_b, z_in_b, table_b, **kw_b))
    ms["sh_grad"], gs = event_ms(sh_grad)
    ms["mr"], mr = event_ms(lambda: shard.horizon_sweep_multires_fused_sharded(
        mesh42, zf, zc, **mkw))
    launches = (fused_sweep.SHARD_KERNEL_LAUNCHES,
                shadow_sweep.SHARD_KERNEL_LAUNCHES,
                replay.SHARD_KERNEL_LAUNCHES,
                replay.SHADOW_SHARD_KERNEL_LAUNCHES)
    print(f"  main path (CUDA events): horizon {ms['hz']:.2f} ms, its "
          f"gradient step {ms['hz_grad']:.2f} ms on (4, 2); shadow row B "
          f"{ms['sh']:.2f} ms, its gradient step {ms['sh_grad']:.2f} ms on "
          f"(8, 1); multires 2 m cell {ms['mr']:.2f} ms on (4, 2)  [{card}]")
    print(f"  shard launches: K1 {launches[0]}, K2 {launches[1]}, K3 "
          f"{launches[2]}, K4 {launches[3]}")
    check(launches == (24, 16, 25, 25), "the main path launched every shard "
          "variant: K1 8 + K1-argmax 8 + multires 8, K2 8 + K2-argmax 8, "
          "K3 and K4 3 passes x 8 shards + 1 conversion")

    # 1. the horizon at the bench cell against the single launch
    want = fused_sweep.horizon_sweep_fused(zt, **sweep_kw)
    hz_err = (hz - want).abs().max().item()
    check(torch.equal(hz, want), f"sharded horizon (4, 2) bit-equal to the "
          f"single K1 launch ({hz_err:.1e} rad)")
    args = fused_sweep.sweep_args(zt, **sweep_kw)
    fwd = shard._HzForward(mesh42, args)
    k1_single = cuda_ms(lambda: fused_sweep._ratio_cuda(*args), 3)
    k1_parts = shard_k1_ms(fwd, False)
    k1_single2 = cuda_ms(lambda: fused_sweep._ratio_cuda(*args), 3)
    k1_sum = float(sum(k1_parts))
    parts = ", ".join(f"{v:.2f}" for v in k1_parts)
    print(f"  K1: 8 shards {k1_sum:.3f} ms summed ({parts}); "
          f"the single launch {k1_single:.3f} / {k1_single2:.3f} ms: "
          f"sharding costs {k1_sum / k1_single - 1.0:+.1%} on one card  "
          f"[{card}]")

    # 2. the gradient row against the single-device gradient
    zs = zt.clone().requires_grad_(True)
    torch.mean(fused_sweep.horizon_sweep_fused(zs, **sweep_kw) ** 2) \
        .backward()
    g_err = (gz - zs.grad).abs().max().item()
    check(torch.equal(gz, zs.grad), f"sharded gradient bit-equal to the "
          f"single-device gradient (max |g| {zs.grad.abs().max().item():.3e})")
    check(torch.equal(hz_grad(), gz), "sharded gradient bit-equal across runs")
    del zs
    am_parts = shard_k1_ms(fwd, True)
    raw, records = fwd.run(emit_argmax=True)
    lims = (-15.0, 89.98)
    h = fused_sweep._angles(raw.clone(), *lims)
    graw = fused_sweep.raw_cotangent(raw, 2.0 * h / h.numel(), lims)
    del h
    shifts = replay.horizon_shifts(fwd.trig, fwd.plan)
    k3_ms, (cots, zcot) = event_ms(lambda: shard._sharded_replay(
        mesh42, tuple(zt.shape), fwd.plan, graw, records, shifts, fwd.rows,
        fwd.az_loc))
    s_raw, s_ids, s_aux = fused_sweep._ratio_cuda(*args, emit_argmax=True)
    check(torch.equal(raw, s_raw), "K1-argmax shards' raw ratios bit-equal "
          "to the single launch's")
    bargs = (tuple(zt.shape), graw, s_ids, s_aux, fwd.plan, shifts)
    k3_single, (w_cots, w_zcot) = event_ms(lambda: replay._bwd_cuda(*bargs))
    check(all(torch.equal(a, b) for a, b in zip(cots + [zcot],
                                                w_cots + [w_zcot])),
          "K3's shard variant: level and z_org cotangents bit-equal to the "
          "single K3 launch")
    print(f"  K1-argmax: 8 shards {sum(am_parts):.3f} ms summed; K3's shard "
          f"variant (8 shards' passes, the words' sum, one conversion) "
          f"{k3_ms:.3f} ms against the single K3 {k3_single:.3f} ms  "
          f"[{card}]")
    del raw, records, graw, cots, zcot, w_cots, w_zcot, s_raw, s_ids, s_aux

    # 3. shadow row B and its gradient
    sargs = shadow_sweep.metric_args(
        zt, z_org_b, z_in_b, table_b,
        **{k: kw_b[k] for k in ("offset", "inner_shape", "dx", "dy")})
    want = shadow_sweep._metric_cuda(*sargs, grid_origin=(0.0, 0.0))
    sh_err = (met - want).abs().max().item()
    check(torch.equal(met, want), "sharded shadow metric (8, 1) bit-equal "
          "to the single K2 launch")
    zs = zt.clone().requires_grad_(True)
    z_i = zs[halo:halo + inner, halo:halo + inner]
    torch.mean(torch.sigmoid(shadow_sweep.shadow_metric_fused(
        zs, z_i + 0.05, z_i, table_b, **kw_b) / 2.0)).backward()
    gs_err = (gs - zs.grad).abs().max().item()
    check(torch.equal(gs, zs.grad), "sharded shadow gradient bit-equal to "
          "the single-device gradient")
    del zs, z_i
    k2_single = cuda_ms(lambda: shadow_sweep._metric_cuda(
        *sargs, grid_origin=(0.0, 0.0)), 3)
    k2_parts = shard_k2_ms(mesh81, sargs, (0.0, 0.0), False)
    met_a, records = shard._shadow_run(mesh81, sargs, (0.0, 0.0), True)
    sig = torch.sigmoid(met_a / 2.0)
    gmet = sig * (1.0 - sig) * (0.5 / met_a.numel())
    del sig
    k4_ms, (cots, dzo) = event_ms(lambda: shard._sharded_replay(
        mesh81, tuple(zt.shape), sargs[4], gmet, records, table_b,
        inner // 8, len(table_b), shadow=(sargs[0], (0.0, 0.0))))
    _, s_ids, s_aux = shadow_sweep._metric_cuda(*sargs, grid_origin=(0.0, 0.0),
                                                emit_argmax=True)
    bargs = (tuple(zt.shape), gmet, s_ids, s_aux, sargs[4])
    sh_b = (table_b, sargs[0], (0.0, 0.0))
    k4_single, (w_cots, w_dzo) = event_ms(
        lambda: replay._bwd_cuda(*bargs, shadow=sh_b))
    check(all(torch.equal(a, b) for a, b in zip(cots + [dzo],
                                                w_cots + [w_dzo])),
          "K4's shard variant: level and z_org cotangents bit-equal to the "
          "single K4 launch")
    print(f"  K2: 8 shards {sum(k2_parts):.3f} ms summed against the single "
          f"launch {k2_single:.3f} ms; K4's shard variant {k4_ms:.3f} ms "
          f"against the single K4 {k4_single:.3f} ms  [{card}]")
    del met_a, records, gmet, cots, dzo, w_cots, w_dzo, s_ids, s_aux

    # 4. multires at the 2 m cell: fine windows per tile
    want = multires.horizon_sweep_multires_fused(zf, zc, **mkw)
    mr_err = (mr - want).abs().max().item()
    check(torch.equal(mr, want), "sharded multires (4, 2) bit-equal to "
          "horizon_sweep_multires_fused")
    margs = multires_args(zf, zc, mkw)
    mfwd = shard._HzForward(mesh42, margs, n_fine=mkw["ratio_log2"])
    fine = [sum((e - o) * lv.shape[1] * 4 for (o, e), lv in
                zip(mfwd.windows[t][:mkw["ratio_log2"]], margs[2]))
            for t in range(4)]
    full = sum(t.numel() * 4 for t in margs[2][:mkw["ratio_log2"]])
    coarse = sum(t.numel() * 4 for t in margs[2][mkw["ratio_log2"]:])
    per_tile = ", ".join(f"{b / 1e6:.1f}" for b in fine)
    print(f"  multires fine levels per tile [{per_tile}] MB against "
          f"{full / 1e6:.1f} MB replicated (the outer grid "
          f"{tuple(zf.shape)} {zf.numel() * 4 / 1e6:.1f} MB); coarse "
          f"levels {coarse / 1e6:.1f} MB replicated")
    mr_parts = shard_k1_ms(mfwd, False)
    mr_single = cuda_ms(lambda: fused_sweep._ratio_cuda(*margs), 3)
    print(f"  K1 at the 2 m cell: 8 shards {sum(mr_parts):.3f} ms summed "
          f"against the single launch {mr_single:.3f} ms  [{card}]")
    del margs, mfwd, mr, want, zf, zc

    # 5. the XLA engines on a 256^2 crop
    c0 = halo + inner // 2 - 256
    zcrop = zt[c0:c0 + 512, c0:c0 + 512].contiguous()
    xkw = dict(dx=dx, dy=-dx, offset=(128, 128), inner_shape=(256, 256),
               dist_search=3000.0, hori_acc=0.25)
    azim = (2 * np.pi / 32) * np.arange(32)
    t0 = time.perf_counter()
    xs = shard.horizon_sweep_sharded(mesh42, zcrop, azim=azim, **xkw)
    torch.cuda.synchronize()
    x_wall = time.perf_counter() - t0
    xw, _ = sweep.horizon_sweep(zcrop, azim=azim, **xkw)
    check(torch.equal(xs, xw), "sharded XLA horizon (4, 2) on a 256^2 crop "
          "equal to the single-device call")
    sched = sweep.build_schedule(dx, float(np.hypot(512 * dx, 512 * dx)),
                                 sweep.default_rel_err(0.25))
    zi = zcrop[128:384, 128:384]
    m = torch.full((256, 256), 0.2, device=dev)
    u = np.array([0.6 / dx, 0.8 / dx], dtype=np.float32)
    xs = shard.shadow_metric_sharded(mesh81, zcrop, zi + 0.05, zi, m, u,
                                     sched, (128, 128), (256, 256))
    xw = sweep.shadow_metric(zcrop, zi + 0.05, zi, m, u, sched, (128, 128),
                             (256, 256))
    check(torch.equal(xs, xw), "sharded XLA shadow metric (8, 1) equal to "
          "the single-device call")
    print(f"  XLA engines on the crop: horizon {x_wall:.3f} s wall on (4, 2)")

    # 6. two processes on the one card (gloo)
    pair_s = run_pair()
    print(f"  two processes, gloo, (2, 2) mesh on cuda:0: {pair_s:.1f} s wall "
          f"(start-up included); NCCL needs one card per process and is not "
          f"exercised on one card")
    print(f"  phase O {time.perf_counter() - t_o:.1f} s")
    return [
        ("horizon_sweep shard (K1-shard)", KERNEL_SOURCE, SHARD_REPLACES,
         launches[0], max(hz_err, mr_err), k1_sum, single["k1"][1],
         single["k1"][2], k1_single),
        ("shadow_sweep shard (K2-shard)", KERNEL_SOURCE,
         SHADOW_SHARD_REPLACES, launches[1], sh_err, float(sum(k2_parts)),
         single["k2"][1], single["k2"][2], k2_single),
        ("horizon_replay_bwd shard (K3-shard)", BWD_SOURCE,
         BWD_SHARD_REPLACES, launches[2], g_err, k3_ms, single["k3"][1],
         single["k3"][2], k3_single),
        ("shadow_replay_bwd shard (K4-shard)", BWD_SOURCE,
         SHADOW_BWD_SHARD_REPLACES, launches[3], gs_err, k4_ms,
         single["k4"][1], single["k4"][2], k4_single)]


#: Where phase P writes its tiles, chunks, trace and example outputs (under
#: the gitignored build/; removed at the end of the phase).
P_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                     "smoke_p")
#: The example workflows phase P runs as subprocesses at their defaults,
#: with the count of printed checks each must pass (the library paths of
#: the other six run at their defaults as phases 8, C, I, K, L and M).
P_SCRIPTS = (("horizon/gridded_planar_dem.py", 2),
             ("horizon/gridded_curved_dem_masked.py", 4),
             ("shadow/gridded_curved_dem_nasadem.py", 3),
             ("shadow/gridded_curved_dem_rema.py", 2),
             ("verify_drive.py", 8))


class _Killed(Exception):
    """Raised inside a runner's call to stand for a kill of the run."""


def _kill_on_call(obj, attr, n_kill):
    """Patch ``obj.attr`` (an instance attribute shadowing the method) to
    raise :class:`_Killed` from its ``n_kill``-th call on."""
    orig = getattr(obj, attr)
    calls = [0]

    def dying(*a, **kw):
        calls[0] += 1
        if calls[0] >= n_kill:
            raise _Killed
        return orig(*a, **kw)

    setattr(obj, attr, dying)


def phase_p(dev, card, z, halo, inner, azim_num, dist_km, dx, k1_args,
            k1_ms, samples):
    """Phase P: the streaming runners, profiling and the example workflows.
    Returns (K1 launches of the tiled run, K2 launches of the sun-track
    run)."""
    import shutil

    from horayzon_tpu_torch.utils import profiling, streaming

    print("== P. streaming runners, profiling, example workflows")
    t_p = time.perf_counter()
    shutil.rmtree(P_DIR, ignore_errors=True)
    os.makedirs(P_DIR)
    # 1. TiledHorizonRunner at the bench cell: 1024^2 in four 512^2 tiles
    zt = torch.from_numpy(z).to(dev)
    kw = dict(dx=dx, dy=-dx, offset=(halo, halo), inner_shape=(inner, inner),
              azim=horizon.azimuth_angles(azim_num),
              dist_search=dist_km * 1000.0, hori_acc=0.25)
    tile = (inner // 2, inner // 2)
    runner = streaming.TiledHorizonRunner(
        z, out_dir=os.path.join(P_DIR, "tiles"), tile=tile, device=dev, **kw)
    check(runner.fused, "the tiled run takes the fused route (K1)")
    tiles = list(runner.tiles())
    torch.cuda.synchronize()
    fused_sweep.KERNEL_LAUNCHES = 0
    t0 = time.perf_counter()
    runner.run(verbose=False)
    torch.cuda.synchronize()
    run_wall = time.perf_counter() - t0
    tile_launches = fused_sweep.KERNEL_LAUNCHES
    check(tile_launches == len(tiles), f"the tiled run launched K1 once a "
          f"tile ({tile_launches} launches, {len(tiles)} tiles)")
    cube = runner.assemble()
    sweep_kw = dict(dx=dx, dy=-dx, azim_num=azim_num,
                    dist_search=dist_km * 1000.0, hori_acc=0.25)
    t0 = time.perf_counter()
    single = fused_sweep.horizon_sweep_fused(
        zt, offset=(halo, halo), inner_shape=(inner, inner), **sweep_kw)
    single = single.cpu().numpy()
    single_wall = time.perf_counter() - t0
    whole_plan = fused_sweep.plan_sweep(
        tuple(z.shape), inner_shape=(inner, inner), offset=(halo, halo),
        dist_search=dist_km * 1000.0, dx=dx, dy=-dx)
    walls = []
    for i0, j0, n0, n1 in tiles:
        t_kw = dict(sweep_kw, offset=(halo + i0, halo + j0),
                    inner_shape=(n0, n1))
        own = fused_sweep.horizon_sweep_fused(zt, **t_kw).cpu().numpy()
        got = cube[i0:i0 + n0, j0:j0 + n1]
        check(np.array_equal(got, own), f"tile ({i0}, {j0}) bit-equal to "
              f"horizon_sweep_fused on the tile")
        plan = fused_sweep.plan_sweep(
            tuple(z.shape), inner_shape=(n0, n1), offset=t_kw["offset"],
            dist_search=dist_km * 1000.0, dx=dx, dy=-dx)
        diff = float(np.abs(got - single[i0:i0 + n0, j0:j0 + n1]).max())
        same = plan["n_safe"] == whole_plan["n_safe"]
        quirk = plan["n_safe"] == plan["n_dense"] - 1
        print(f"  tile ({i0}, {j0}): n_safe {plan['n_safe']} (run "
              f"{whole_plan['n_safe']}, n_dense {plan['n_dense']}), max "
              f"|tile - single launch| {diff:.3e} rad")
        check(diff == 0.0 if same else (quirk or diff <= 3e-8),
              f"tile ({i0}, {j0}) against the single launch")
        t0 = time.perf_counter()
        runner.sweep_tile(i0, j0, n0, n1).cpu().numpy()
        walls.append(time.perf_counter() - t0)
    print(f"  TiledHorizonRunner.run, {len(tiles)} tiles of {tile}: "
          f"{run_wall:.4f} s wall (pyramid, {len(tiles)} K1 launches, "
          f"copies and .npy writes); per tile (sweep + copy to host) "
          f"{', '.join(f'{w:.4f}' for w in walls)} s; the single "
          f"{inner}^2 launch + copy {single_wall:.4f} s  [{card}]")
    # kill inside the second tile's call, then resume
    killed = streaming.TiledHorizonRunner(
        z, out_dir=os.path.join(P_DIR, "tiles_kill"), tile=tile, device=dev,
        **kw)
    _kill_on_call(killed, "sweep_tile", 2)
    try:
        killed.run(verbose=False)
        check(False, "the killed tiled run raised")
    except _Killed:
        pass
    del killed.sweep_tile
    paths = [killed._tile_path(i0, j0) for i0, j0, _, _ in tiles]
    on_disk = [os.path.exists(p) for p in paths]
    check(on_disk == [True] + [False] * (len(tiles) - 1),
          f"a kill in the second tile leaves the first on disk ({on_disk})")
    mtime0 = os.path.getmtime(paths[0])
    fused_sweep.KERNEL_LAUNCHES = 0
    killed.run(verbose=False)
    check(fused_sweep.KERNEL_LAUNCHES == len(tiles) - 1
          and os.path.getmtime(paths[0]) == mtime0,
          f"the resumed run computed the {len(tiles) - 1} missing tiles "
          f"only, the first untouched")
    check(np.array_equal(killed.assemble(), cube),
          "the resumed cube bit-equal to the uninterrupted one")
    shutil.rmtree(os.path.join(P_DIR, "tiles_kill"))
    shutil.rmtree(os.path.join(P_DIR, "tiles"))
    del cube, single, zt

    # 2. SunTrackRunner at hemisphere_800_s181: chunks of 32
    terrain = shadow.Terrain()
    terrain.initialise(*hemisphere_terrain(), ang_max=89.99, device=dev)
    suns = sun_position.sun_position_planar(np.linspace(0.0, 360.0, 181),
                                            30.0, dist=1.0e7)
    want = terrain.sw_dir_cor_batch(suns).cpu().numpy()
    track = streaming.SunTrackRunner(
        terrain, suns, out_dir=os.path.join(P_DIR, "track"), chunk=32)
    n_chunks = len(list(track.chunks()))
    torch.cuda.synchronize()
    shadow_sweep.KERNEL_LAUNCHES = 0
    t0 = time.perf_counter()
    track.run(verbose=False)
    track_wall = time.perf_counter() - t0
    chunk_launches = shadow_sweep.KERNEL_LAUNCHES
    check(chunk_launches == n_chunks, f"the sun-track run launched K2 once "
          f"a chunk ({chunk_launches} launches, {n_chunks} chunks)")
    check(np.array_equal(track.assemble(), want), "the sun track's chunks "
          "bit-equal to one sw_dir_cor_batch call of 181 suns")
    print(f"  SunTrackRunner.run, 181 suns x {terrain.comp_shape} in "
          f"{n_chunks} chunks of 32: {track_wall:.4f} s wall (K2, "
          f"classification, copies, {want.nbytes / 1e6:.0f} MB of .npy)  "
          f"[{card}]")
    shutil.rmtree(os.path.join(P_DIR, "track"))
    resumed = streaming.SunTrackRunner(
        terrain, suns, out_dir=os.path.join(P_DIR, "track_kill"), chunk=32)
    orig = terrain.sw_dir_cor_batch
    _kill_on_call(terrain, "sw_dir_cor_batch", 2)
    try:
        resumed.run(verbose=False)
        check(False, "the killed sun-track run raised")
    except _Killed:
        pass
    terrain.sw_dir_cor_batch = orig
    first = resumed._chunk_path(0)
    check(os.path.exists(first) and not os.path.exists(
        resumed._chunk_path(32)), "a kill in the second chunk leaves the "
          "first on disk")
    mtime0 = os.path.getmtime(first)
    t0 = time.perf_counter()
    resumed.run(verbose=False)
    resume_wall = time.perf_counter() - t0
    check(os.path.getmtime(first) == mtime0
          and np.array_equal(resumed.assemble(), want),
          "the resumed track keeps the first chunk and is bit-equal")
    print(f"  resumed after a kill in the second chunk: {resume_wall:.4f} s "
          f"for the other {n_chunks - 1} chunks")
    shutil.rmtree(os.path.join(P_DIR, "track_kill"))
    del want, terrain

    # 3. profiling at the bench cell's K1 route
    stats = profiling.time_sweep(lambda: fused_sweep._ratio_cuda(*k1_args),
                                 cells=inner * inner, azim_num=azim_num,
                                 samples_per_cell_azim=samples, iters=5)
    print(f"  profiling.time_sweep on K1 at the bench cell: best of 5 "
          f"{1e3 * stats.wall_time_s:.3f} ms wall (phase 4's CUDA events: "
          f"{k1_ms:.3f} ms); {stats.to_json()}  [{card}]")
    check(stats.wall_time_s * 1e3 >= 0.9 * k1_ms,
          "time_sweep waits for the card (its wall at least 0.9 x the "
          "CUDA-event time)")
    trace_dir = os.path.join(P_DIR, "trace")
    with profiling.profiler_trace(trace_dir):
        fused_sweep._ratio_cuda(*k1_args)
        torch.cuda.synchronize()
    files = os.listdir(trace_dir)
    check(len(files) == 1, f"profiler_trace wrote one trace ({files})")
    with open(os.path.join(trace_dir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    k1_events = [e for e in events if e.get("cat") == "kernel"
                 and "horizon" in str(e.get("name", ""))]
    print(f"  profiler_trace: {len(events)} events, "
          f"{len(k1_events)} K1 kernel event(s) on the card"
          + (f", {k1_events[0]['dur'] / 1e3:.3f} ms" if k1_events else
             " (no device time in the trace)"))

    # 4. the example workflows no phase runs yet, at their defaults
    ex_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "examples", "torch")
    for script, n_checks in P_SCRIPTS:
        cmd = [sys.executable, os.path.join(ex_dir, script)]
        if script != "verify_drive.py":
            cmd += ["--out", os.path.join(P_DIR, "examples")]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=300)
        wall = time.perf_counter() - t0
        oks = res.stdout.count("check ok:")
        tail = [ln for ln in res.stdout.splitlines()
                if not ln.startswith("check ok:")][-2:]
        print(f"  examples/torch/{script}: exit {res.returncode}, "
              f"{oks} checks met, {wall:.1f} s wall; {' | '.join(tail)}")
        check(res.returncode == 0 and oks == n_checks
              and "CHECK FAILED" not in res.stdout,
              f"{script} ran with its checks met"
              + ("" if res.returncode == 0 else
                 f": {res.stdout[-1500:]}{res.stderr[-1500:]}"))
    shutil.rmtree(P_DIR)
    print(f"  phase P {time.perf_counter() - t_p:.1f} s")
    return tile_launches, chunk_launches


def main():
    t_run = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    print("== 1. environment")
    print(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}")
    check(torch.cuda.is_available(), "torch.cuda.is_available()")
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "?"
    print(f"  device {kind}, count {torch.cuda.device_count()}")
    print(card)

    print("== 2. build")
    t0 = time.perf_counter()
    libs = _build.build_all(KERNELS)
    print(f"  built {len(libs)} kernels in {time.perf_counter() - t0:.2f} s")
    for name, lib in zip(KERNELS, libs):
        secs, log = _build.BUILD_LOG.get(name, (0.0, "(cached)"))
        print(f"  {lib.name}: nvcc {secs:.2f} s")
        for line in log.splitlines():
            print(f"  nvcc: {line}")

    print("== 3. K1 against the plain version on the card")
    max_err = 0.0
    for name, z, kw in small_cases():
        zt = torch.from_numpy(z).to(dev)
        kw = dict(kw, dx=25.0, dy=-25.0, hori_acc=0.25)
        n0 = fused_sweep.KERNEL_LAUNCHES
        got = fused_sweep.horizon_sweep_fused(zt, **kw)
        ref = fused_sweep.horizon_sweep_plain(zt, **kw)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        max_err = max(max_err, err)
        print(f"  {name}: max |hori_K1 - hori_plain| = {err:.3e} rad")
        check(fused_sweep.KERNEL_LAUNCHES == n0 + 1,
              f"{name}: K1 launched once")
        check(bool(torch.isfinite(got).all()) and err <= TOL,
              f"{name}: finite and within {TOL} rad")

    print("== 4. main path: PlanarPipeline.run at the bench shape")
    n, halo, dx, azim_num, dist_km = 2048, 512, 25.0, 32, 20.0
    inner = n - 2 * halo
    z = make_terrain(n, n, seed=0)
    x = np.arange(n, dtype=np.float32) * dx
    y = (n - 1 - np.arange(n, dtype=np.float32)) * dx    # north-up
    domain = {"x_min": float(x[halo]), "x_max": float(x[halo + inner - 1]),
              "y_min": float(y[halo + inner - 1]), "y_max": float(y[halo])}
    pipe = PlanarPipeline(x, y, z, domain, dist_search=dist_km,
                          azim_num=azim_num, hori_acc=0.25, device=dev)
    check((pipe.offset_0, pipe.offset_1) == (halo, halo),
          f"inner domain at offset {halo}")
    t0 = time.perf_counter()
    pipe.run()
    torch.cuda.synchronize()
    print(f"  warm-up run (first launch at this shape): "
          f"{time.perf_counter() - t0:.3f} s")
    runs = 5
    fused_sweep.KERNEL_LAUNCHES = 0
    walls, ev_ms = [], []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = pipe.run()
        stop.record()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        ev_ms.append(start.elapsed_time(stop))
    launches = fused_sweep.KERNEL_LAUNCHES
    wall = float(np.median(walls))
    rate = inner * inner * azim_num / wall
    print(f"  PlanarPipeline.run over {runs} runs: median {wall:.4f} s wall "
          f"(min {min(walls):.4f}, max {max(walls):.4f}; median "
          f"{np.median(ev_ms):.2f} ms between CUDA events), "
          f"{rate:.4e} (cell*azimuth)/s  [{card}]")
    check(launches == runs, f"main path launched K1 ({launches} launches "
          f"in {runs} runs)")
    hori, svf = out["hori"], out["svf"]
    check(tuple(hori.shape) == (inner, inner, azim_num) and hori.is_cuda,
          "hori shape and device")
    check(bool(torch.isfinite(hori).all()), "hori finite")
    check(bool(torch.isfinite(svf).all()) and svf.min().item() > 0.0
          and svf.max().item() <= 1.0 + 1e-3,
          f"svf finite in (0, 1.001]: [{svf.min().item():.4f}, "
          f"{svf.max().item():.4f}]")
    zt = torch.from_numpy(z).to(dev)
    sweep_kw = dict(dx=dx, dy=-dx, azim_num=azim_num,
                    dist_search=dist_km * 1000.0, hori_acc=0.25)
    flat = fused_sweep.horizon_sweep_fused(
        torch.zeros_like(zt), offset=(halo, halo),
        inner_shape=(inner, inner), **sweep_kw)
    check(flat.abs().max().item() < 1e-4,
          f"flat plane: max |hori| = {flat.abs().max().item():.2e} rad")
    c0 = halo + inner // 2 - 64
    crop = fused_sweep.horizon_sweep_plain(
        zt, offset=(c0, c0), inner_shape=(128, 128), **sweep_kw)
    err = (hori[c0 - halo:c0 - halo + 128, c0 - halo:c0 - halo + 128]
           - crop).abs().max().item()
    max_err = max(max_err, err)
    check(err <= TOL, f"128^2 crop against the plain version: {err:.3e} rad")

    # K1 and the plain sweep alone at the main-path shape: raw ratios from
    # the same padded levels (levels, arctan and transpose not included)
    plan = fused_sweep.plan_sweep(
        tuple(zt.shape), inner_shape=(inner, inner), offset=(halo, halo),
        dist_search=dist_km * 1000.0, dx=dx, dy=-dx, hori_acc=0.25)
    levels = mip.padded_levels(zt, plan["pads"])
    z_inner = zt[halo:halo + inner, halo:halo + inner].contiguous()
    z_org = z_inner + float(np.float32(0.01))
    trig = fused_sweep.trig_table(azim_num)
    args = (z_org, z_inner, levels, trig, plan, tuple(zt.shape))
    fused_sweep._ratio_cuda(*args)
    k1_ms = cuda_ms(lambda: fused_sweep._ratio_cuda(*args), 10)
    plain_ms = cuda_ms(lambda: fused_sweep._ratio_plain(*args), 1)
    samples = plan["nx"] * 2 + (plan["n_dense"] - plan["nx"]) + sum(
        ph[1] for ph in plan["phases_meta"][1:])
    k1_args, k1_samples = args, samples
    print(f"  K1 alone: {k1_ms:.3f} ms; plain torch sweep: {plain_ms:.1f} ms "
          f"({samples} samples per (cell, azimuth))  [{card}]")
    k1_bound = skip_report("K1", args, False, k1_ms, card)

    print("== 5. K1-argmax and K3 against their plain versions on the card")
    am_err = bwd_err = 0.0
    for name, z, kw in small_cases() + [odd_case()]:
        zs = torch.from_numpy(z).to(dev)
        kw = dict(kw, dx=25.0, dy=-25.0, hori_acc=0.25)
        sargs = fused_sweep.sweep_args(zs, **kw)
        plan, trig = sargs[4], sargs[3]
        print(f"  {name}: nx {plan['nx']}, ns1 {plan['ns1']}, n_dense "
              f"{plan['n_dense']}, {len(plan['phases_meta']) - 1} mip phases")
        raw, ids, aux = fused_sweep._ratio_cuda(*sargs, emit_argmax=True)
        raw_k1 = fused_sweep._ratio_cuda(*sargs)
        p_raw, p_ids, p_aux = fused_sweep._ratio_plain(*sargs,
                                                       emit_argmax=True)
        torch.cuda.synchronize()
        am_err = max(am_err, (raw - p_raw).abs().max().item())
        check(torch.equal(raw, raw_k1) and torch.equal(raw, p_raw),
              f"{name}: K1-argmax raw bit-equal to K1 and to the plain "
              f"argmax sweep")
        check(torch.equal(ids, p_ids) and torch.equal(aux, p_aux),
              f"{name}: ids and aux equal to the plain version "
              f"({int((ids < 2 * plan['n_dense']).sum())} dense, "
              f"{int((ids >= 2 * plan['n_dense']).sum())} mip winners)")
        g = torch.from_numpy(np.random.default_rng(7).normal(
            size=tuple(raw.shape)).astype(np.float32)).to(dev)
        bargs = (tuple(zs.shape), g, ids, aux, plan,
                 replay.horizon_shifts(trig, plan))
        k_runs = [replay._bwd_cuda(*bargs) for _ in range(2)]
        p_cots, p_zcot = replay.backward_replay_plain(*bargs)
        torch.cuda.synchronize()
        bwd_err = max(bwd_err, check_replay(name, "K3",
                                            [c + [z] for c, z in k_runs],
                                            p_cots + [p_zcot]))
        print_levels(name)
    # contention: a tall spike at the centre of a flat grid; most winners
    # land on a few level-0 cells, the far ones on a few coarse cells
    z_c = np.zeros((256, 256), dtype=np.float32)
    z_c[128, 128] = 2000.0
    sargs = fused_sweep.sweep_args(
        torch.from_numpy(z_c).to(dev), offset=(64, 64),
        inner_shape=(128, 128), azim_num=16, dist_search=8000.0, dx=25.0,
        dy=-25.0)
    raw, ids, aux = fused_sweep._ratio_cuda(*sargs, emit_argmax=True)
    g = torch.from_numpy(np.random.default_rng(7).normal(
        size=tuple(raw.shape)).astype(np.float32)).to(dev)
    bargs = (tuple(z_c.shape), g, ids, aux, sargs[4],
             replay.horizon_shifts(sargs[3], sargs[4]))
    k_runs = [replay._bwd_cuda(*bargs) for _ in range(2)]
    p_cots, p_zcot = replay.backward_replay_plain(*bargs)
    torch.cuda.synchronize()
    hit = [int((c != 0).sum()) for c in p_cots]
    check(hit[0] < 4000 and len(hit) > 1 and hit[1] > 0,
          f"contention scene: {ids.numel()} winners onto {hit} cells of the "
          f"levels")
    bwd_err = max(bwd_err, check_replay("contention scene", "K3",
                                        [c + [z] for c, z in k_runs],
                                        p_cots + [p_zcot]))
    print_levels("contention scene")

    print("== 6. gradient path at the bench's gradient row")
    grad_kw = dict(dx=dx, dy=-dx, offset=(halo, halo),
                   inner_shape=(inner, inner), azim_num=azim_num,
                   dist_search=dist_km * 1000.0, hori_acc=0.25)

    def forward_loss():
        return torch.mean(fused_sweep.horizon_sweep_fused(zt, **grad_kw)
                          ** 2)

    def grad_step():
        zg = zt.clone().requires_grad_(True)
        loss = torch.mean(fused_sweep.horizon_sweep_fused(zg, **grad_kw)
                          ** 2)
        loss.backward()
        return zg.grad

    event_ms(forward_loss)
    fwd_ms = [event_ms(forward_loss)[0] for _ in range(runs)]
    event_ms(grad_step)
    fused_sweep.KERNEL_LAUNCHES = 0
    fused_sweep.ARGMAX_KERNEL_LAUNCHES = 0
    replay.KERNEL_LAUNCHES = 0
    grads, grad_ms = [], []
    for _ in range(runs):
        ms, gz = event_ms(grad_step)
        grad_ms.append(ms)
        grads.append(gz)
    am_launches = fused_sweep.ARGMAX_KERNEL_LAUNCHES
    k3_launches = replay.KERNEL_LAUNCHES
    f_med, g_med = float(np.median(fwd_ms)), float(np.median(grad_ms))
    print(f"  forward (loss, no grad) median {f_med:.2f} ms (min "
          f"{min(fwd_ms):.2f}, max {max(fwd_ms):.2f}); loss + backward() "
          f"median {g_med:.2f} ms (min {min(grad_ms):.2f}, max "
          f"{max(grad_ms):.2f}); grad/forward {g_med / f_med:.3f}  [{card}]")
    check(am_launches == runs and k3_launches == runs,
          f"gradient path launched K1-argmax ({am_launches}) and K3 "
          f"({k3_launches}) once per run in {runs} runs")
    gz = grads[-1]
    check(bool(torch.isfinite(gz).all()) and gz.abs().max().item() > 0.0,
          f"z.grad finite and nonzero (max |g| {gz.abs().max().item():.3e})")
    check(torch.equal(grads[-1], grads[-2]), "z.grad bit-equal across runs")

    sargs = fused_sweep.sweep_args(zt, **grad_kw)
    plan, trig = sargs[4], sargs[3]
    fused_sweep._ratio_cuda(*sargs, emit_argmax=True)
    am_ms = cuda_ms(lambda: fused_sweep._ratio_cuda(*sargs, emit_argmax=True),
                    10)
    raw, ids, aux = fused_sweep._ratio_cuda(*sargs, emit_argmax=True)
    am_plain_ms, (p_raw, p_ids, p_aux) = event_ms(
        lambda: fused_sweep._ratio_plain(*sargs, emit_argmax=True))
    check(torch.equal(raw, p_raw) and torch.equal(ids, p_ids)
          and torch.equal(aux, p_aux),
          "K1-argmax equal to the plain argmax sweep at this shape")
    del p_raw, p_ids, p_aux
    lims = (-15.0, 89.98)
    h = fused_sweep._angles(raw.clone(), *lims)
    graw = fused_sweep.raw_cotangent(raw, 2.0 * h / h.numel(), lims)
    del h
    bargs = (tuple(zt.shape), graw, ids, aux, plan,
             replay.horizon_shifts(trig, plan))
    replay._bwd_cuda(*bargs)
    k3_ms = cuda_ms(lambda: replay._bwd_cuda(*bargs), 10)
    k_runs = [replay._bwd_cuda(*bargs) for _ in range(2)]
    print_levels("gradient row")
    cots, zcot = k_runs[0]
    k3_plain_ms, (p_cots, p_zcot) = event_ms(
        lambda: replay.backward_replay_plain(*bargs))
    bwd_err = max(bwd_err, check_replay("gradient row", "K3",
                                        [c + [z] for c, z in k_runs],
                                        p_cots + [p_zcot]))
    k3_bound = replay_bound(graw, ids, aux, plan, cots, zcot, shadow=False)
    print(f"  K1-argmax alone: {am_ms:.3f} ms; plain argmax sweep: "
          f"{am_plain_ms:.1f} ms  [{card}]")
    am_bound = skip_report("K1-argmax", sargs, True, am_ms, card)
    print(f"  K3 alone: {k3_ms:.3f} ms; plain backward: {k3_plain_ms:.1f} ms;"
          f" bound {k3_bound[0]:.4f} ms ({k3_bound[1]})  [{card}]")
    del p_cots, p_zcot, cots, zcot, k_runs, graw, raw, ids, aux, grads

    print("== 7. central finite difference on the card")
    z96 = torch.from_numpy(make_terrain(96, 96, seed=4)).to(dev)
    fd_kw = dict(dx=25.0, dy=-25.0, offset=(32, 32), inner_shape=(32, 32),
                 azim_num=4, dist_search=900.0, hori_acc=0.25)

    def fd_loss(zz):
        h = fused_sweep.horizon_sweep_fused(zz, **fd_kw)
        return torch.mean(h.double() ** 2)

    zg = z96.clone().requires_grad_(True)
    fd_loss(zg).backward()
    v = torch.from_numpy(np.random.default_rng(11).normal(
        size=(96, 96)).astype(np.float32)).to(dev)
    eps = 3e-2
    with torch.no_grad():
        fd = (fd_loss(z96 + eps * v) - fd_loss(z96 - eps * v)).item() / (
            2 * eps)
    an = float((zg.grad.double() * v.double()).sum())
    check(abs(fd - an) < 3e-3 * max(1.0, abs(an)),
          f"directional derivative {an:.6e} against central difference "
          f"{fd:.6e} (white noise, tests/test_pallas.py:118-128)")
    yy, xx = np.mgrid[0:96, 0:96]
    w = torch.from_numpy(np.exp(
        -((yy - 40.32) ** 2 + (xx - 49.92) ** 2) / (2 * 15.36 ** 2))
        .astype(np.float32)).to(dev)
    with torch.no_grad():
        fd = (fd_loss(z96 + 0.1 * w) - fd_loss(z96 - 0.1 * w)).item() / 0.2
    an = float((zg.grad.double() * w.double()).sum())
    check(an != 0.0 and abs(fd - an) <= 2e-2 * abs(an),
          f"directional derivative {an:.6e} against central difference "
          f"{fd:.6e} along a smooth bump: within 2%")

    print("== 8. trainer: TerrainFit at the example's defaults")
    n_fit, inner_fit, dx_fit, steps = 192, 64, 25.0, 150
    halo_fit = (n_fit - inner_fit) // 2
    z_true, z_init = terrain_fit.terrains(n_fit, dx_fit, seed=3)
    obs = fused_sweep.horizon_sweep_fused(
        torch.from_numpy(z_true).to(dev), dx=dx_fit, dy=-dx_fit,
        offset=(halo_fit, halo_fit), inner_shape=(inner_fit, inner_fit),
        azim_num=16, dist_search=1500.0)
    model = terrain_fit.TerrainFit(z_init, obs, dx=dx_fit, inner=inner_fit,
                                   azim_num=16, dist_search=1500.0,
                                   smooth=0.02).to(dev)
    t0 = time.perf_counter()
    losses = terrain_fit.fit(model, steps, lr=2.0)
    fit_s = time.perf_counter() - t0
    e0 = terrain_fit.shift_adjusted_error(z_init, z_true, halo_fit, inner_fit)
    e1 = terrain_fit.shift_adjusted_error(model.z.detach().cpu().numpy(),
                                          z_true, halo_fit, inner_fit)
    print(f"  {steps} Adam steps in {fit_s:.2f} s; horizon MSE "
          f"{losses[0]:.3e} -> {losses[-1]:.3e} rad^2; shift-adjusted error "
          f"{e0.mean():.2f} -> {e1.mean():.2f} m (max {e0.max():.1f} -> "
          f"{e1.max():.1f})  [{card}]")
    check(e1.max() < 0.5 * e0.max(), "ridge recovered: max error below "
          "half its start")
    check(losses[-1] < 0.05 * losses[0], "horizon misfit below 5% of the "
          "first step's")

    print("== A. K2 against the plain version on the card")
    sh_err = 0.0
    for name, z_s, off, inner_s, dx_s, dy_s, origin, rel in \
            shadow_small_cases():
        zs = torch.from_numpy(z_s).to(dev)
        z_org_s, z_in_s, table, kw = shadow_inputs(zs, off, inner_s, dx_s,
                                                   dy_s, origin, rel)
        n0 = shadow_sweep.KERNEL_LAUNCHES
        got = shadow_sweep.shadow_metric_fused(zs, z_org_s, z_in_s, table,
                                               **kw)
        ref = shadow_sweep.shadow_metric_plain(zs, z_org_s, z_in_s, table,
                                               **kw)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        sh_err = max(sh_err, err)
        print(f"  {name}: max |metric_K2 - metric_plain| = {err:.3e} m, "
              f"{int((got != ref).sum())} of {got.numel()} differ; "
              f"{(got > 0).float().mean().item():.3f} occluded")
        check(shadow_sweep.KERNEL_LAUNCHES == n0 + 1,
              f"{name}: K2 launched once")
        check(bool(torch.isfinite(got).all()) and torch.equal(got, ref),
              f"{name}: finite, bit-equal to the plain version (its "
              f"value-exact skips move no value)")
        sargs_a = shadow_sweep.metric_args(
            zs, z_org_s, z_in_s, table,
            **{k: kw[k] for k in ("offset", "inner_shape", "dx", "dy")})
        sign_k2 = shadow_sweep._metric_cuda(*sargs_a, grid_origin=origin,
                                            exact_metric=False)
        model, counts = shadow_sweep.metric_model(
            *sargs_a, grid_origin=origin, exact_metric=False)
        torch.cuda.synchronize()
        print(f"  {name}: sign-exact K2: "
              f"{int((sign_k2 != ref).sum())} of {ref.numel()} values below "
              f"the exact metric; the model's skips: {skip_shares(counts)}")
        check(torch.equal(sign_k2, model)
              and torch.equal(sign_k2 > 0, ref > 0)
              and bool((sign_k2 <= ref).all()),
              f"{name}: sign-exact K2 bit-equal to its plain model, with the "
              f"exact metric's sign and at most its value")

    print("== B. the bench's shadow row: K2 alone at 2048^2 / 1024^2")
    n_sun = 16
    tt = np.linspace(0.15, 2.9, n_sun)
    track = list(zip(3.0e5 * np.cos(tt), 3.0e5 * np.sin(tt),
                     2.0e4 + 1.0e4 * np.sin(2 * tt)))
    z_org_b, z_in_b, table_b, kw_b = shadow_inputs(
        zt, (halo, halo), (inner, inner), dx, -dx, (0.0, 0.0), track)
    sargs = shadow_sweep.metric_args(
        zt, z_org_b, z_in_b, table_b,
        **{k: kw_b[k] for k in ("offset", "inner_shape", "dx", "dy")})
    plan = sargs[4]
    samples = plan["nx"] * 2 + (plan["n_dense"] - plan["nx"]) + sum(
        ph[1] for ph in plan["phases_meta"][1:])
    lv_mb = sum(t.numel() for t in sargs[2]) * 4 / 1e6
    print(f"  plan: {samples} samples per (cell, sun), mip levels "
          f"{[ph[0] for ph in plan['phases_meta'][1:]]}, pads "
          f"{plan['pads']}, padded levels {lv_mb:.1f} MB")
    check(samples == 658 and plan["pads"] == (232, 232, 232, 232, 183, 93),
          "the plan of bench.py's shadow row")

    def k2_run():
        return shadow_sweep._metric_cuda(*sargs, grid_origin=(0.0, 0.0))

    k2_run()
    k2_ms = cuda_ms(k2_run, 10)
    got = k2_run()
    k2_plain_ms, ref = event_ms(lambda: shadow_sweep._metric_plain(
        *sargs, grid_origin=(0.0, 0.0)))
    err = (got - ref).abs().max().item()
    sh_err = max(sh_err, err)
    print(f"  K2 alone: {k2_ms:.3f} ms for {n_sun} suns, "
          f"{k2_ms / n_sun:.4f} ms per sun, "
          f"{inner * inner * n_sun / (k2_ms * 1e-3):.4e} (cell*sun)/s; "
          f"plain torch sweep: {k2_plain_ms:.1f} ms  [{card}]")
    print(f"  max |metric_K2 - metric_plain| = {err:.3e} m, "
          f"{int((got != ref).sum())} of {got.numel()} differ; "
          f"{(got > 0).float().mean().item():.4f} occluded")
    check(bool(torch.isfinite(got).all()) and torch.equal(got, ref),
          "K2 bit-equal to the plain version on the full output")
    t0 = time.perf_counter()
    model, b_counts = shadow_sweep.metric_model(*sargs,
                                                grid_origin=(0.0, 0.0))
    print(f"  the plain model of K2's skips: {time.perf_counter() - t0:.1f} s")
    check(torch.equal(model, ref), "the model's skipping sweep bit-equal to "
          "the plain version")
    k2_bound = skip_report("K2 (row B)", sargs, False, k2_ms, card,
                           k2_counted(sargs, (0.0, 0.0)), b_counts)
    del got, ref, model

    print("== C. shadow main path: Terrain at the artificial example's "
          "defaults")
    t0 = time.perf_counter()
    terrain = shadow.Terrain()
    terrain.initialise(*hemisphere_terrain(), ang_max=89.99, device=dev)
    torch.cuda.synchronize()
    print(f"  initialise (host prep, vectors, pyramid): "
          f"{time.perf_counter() - t0:.3f} s; inner {terrain.comp_shape}, "
          f"{terrain.plan['n_dense']} dense steps, "
          f"{len(terrain.plan['phases_meta']) - 1} mip phases")
    azim = np.linspace(0.0, 360.0, 181)
    suns = sun_position.sun_position_planar(azim, 30.0, dist=1.0e7)
    terrain.sw_dir_cor_batch(suns)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    shadow_sweep.KERNEL_LAUNCHES = 0
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        sw = terrain.sw_dir_cor_batch(suns)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    codes = terrain.shadow_batch(suns)
    torch.cuda.synchronize()
    shadow_wall = time.perf_counter() - t0
    k2_launches = shadow_sweep.KERNEL_LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    c_wall = float(np.median(walls))
    means = sw.mean(dim=(1, 2))
    print(f"  sw_dir_cor_batch, 181 suns x {terrain.comp_shape}: median "
          f"{c_wall:.4f} s wall of 3 (min {min(walls):.4f}, max "
          f"{max(walls):.4f}); shadow_batch {shadow_wall:.4f} s; peak "
          f"{peak / 2**20:.1f} MiB allocated  [{card}]")
    print(f"  spatial-mean sw_dir_cor: min {means.min().item():.4f} max "
          f"{means.max().item():.4f} average {means.mean().item():.4f}")
    check(k2_launches == 4, f"main path launched K2 ({k2_launches} "
          f"launches in 4 queries)")
    check(tuple(sw.shape) == (181, 600, 600) and sw.is_cuda
          and bool(torch.isfinite(sw).all()), "sw_dir_cor shape, device, "
          "finite")
    check(abs(means.mean().item() - 1.0) <= 0.03,
          "average spatial-mean sw_dir_cor within 1 +- 0.03 (the "
          "example's analytic check)")
    counts = torch.bincount(codes.flatten().long(), minlength=4)
    check(codes.dtype == torch.uint8 and codes.max().item() <= 3
          and counts.sum().item() == codes.numel(),
          f"shadow codes in {{0, 1, 2, 3}}: counts {counts.tolist()}")
    t0 = time.perf_counter()
    plain_codes = terrain._run(suns, "shadow", plain=True)
    check(torch.equal(plain_codes, codes),
          f"the codes of all {len(suns)} suns (from sign-exact K2) equal "
          f"those from the plain exact metric "
          f"({time.perf_counter() - t0:.1f} s)")
    del sw, codes, plain_codes
    fld = terrain._fields

    def terrain_args(sun_rows):
        table_f, _ = shadow_sweep.shadow_sun_table(
            sun_rows, terrain._center, terrain.grid.dx, terrain.grid.dy)
        return shadow_sweep.metric_args(
            terrain._z_outer, fld["z_org_r"], fld["z_inner_r"], table_f,
            offset=terrain.offset, inner_shape=terrain.comp_shape,
            dx=terrain.grid.dx, dy=terrain.grid.dy, hori_acc=terrain.acc,
            pyramid=terrain._levels, pooled=terrain._pooled)

    cargs = terrain_args(suns)
    origin_c, pooled_c = terrain._grid_origin, terrain._pooled

    def k2_c(exact):
        return shadow_sweep._metric_cuda(*cargs, grid_origin=origin_c,
                                         exact_metric=exact, pooled=pooled_c)

    c_ms = {}
    for exact in (False, True):
        k2_c(exact)
        c_ms[exact] = cuda_ms(lambda: k2_c(exact), 3)
    t0 = time.perf_counter()
    model_s, counts_s = shadow_sweep.metric_model(
        *cargs, grid_origin=origin_c, exact_metric=False, pooled=pooled_c)
    model_e, counts_e = shadow_sweep.metric_model(
        *cargs, grid_origin=origin_c, pooled=pooled_c)
    print(f"  the plain model of K2's skips, both modes: "
          f"{time.perf_counter() - t0:.1f} s")
    got_s, got_e = k2_c(False), k2_c(True)
    print(f"  K2 on the 181 suns alone: sign-exact {c_ms[False]:.3f} ms, "
          f"exact {c_ms[True]:.3f} ms; sign-exact values below the exact "
          f"ones on "
          f"{int((got_s != got_e).sum())} of {got_e.numel()} (cell, sun)  "
          f"[{card}]")
    check(torch.equal(got_e, model_e), "exact K2 bit-equal to the plain "
          "sweep on all 181 suns")
    check(torch.equal(got_s, model_s)
          and torch.equal(got_s > 0, got_e > 0)
          and bool((got_s <= got_e).all()),
          "sign-exact K2 bit-equal to its plain model on all 181 suns, with "
          "the exact metric's sign and at most its value")
    del model_s, model_e, got_s, got_e
    skip_report("K2 sign-exact (181 suns)", cargs, False, c_ms[False], card,
                k2_counted(cargs, origin_c, exact_metric=False,
                           pooled=pooled_c), counts_s)
    skip_report("K2 exact (181 suns)", cargs, False, c_ms[True], card,
                k2_counted(cargs, origin_c, pooled=pooled_c), counts_e)

    print("== D. K2-argmax and K4 against their plain versions on the card")
    sa_err = sb_err = 0.0
    for name, z_s, off, inner_s, dx_s, dy_s, origin, rel in \
            shadow_small_cases():
        zs = torch.from_numpy(z_s).to(dev)
        z_org_s, z_in_s, table, kw = shadow_inputs(zs, off, inner_s, dx_s,
                                                   dy_s, origin, rel)
        dargs = shadow_sweep.metric_args(
            zs, z_org_s, z_in_s, table,
            **{k: kw[k] for k in ("offset", "inner_shape", "dx", "dy")})
        sa_err = max(sa_err, check_shadow_argmax(name, dargs, origin)[0])
        g = torch.from_numpy(np.random.default_rng(7).normal(
            size=(len(rel),) + inner_s).astype(np.float32)).to(dev)
        sb_err = max(sb_err, check_shadow_replay(name, dargs, origin, g)[0])

    print("== E. the bench's shadow-gradient row at 2048^2 / 1024^2")
    lift = float(np.float32(0.05))

    def shadow_loss(zz):
        z_i = zz[halo:halo + inner, halo:halo + inner]
        met = shadow_sweep.shadow_metric_fused(zz, z_i + lift, z_i, table_b,
                                               **kw_b)
        return torch.mean(torch.sigmoid(met / 2.0))

    def shadow_grad_step():
        zg = zt.clone().requires_grad_(True)
        shadow_loss(zg).backward()
        return zg.grad

    event_ms(lambda: shadow_loss(zt))
    sfwd_ms = [event_ms(lambda: shadow_loss(zt))[0] for _ in range(runs)]
    event_ms(shadow_grad_step)
    sgrads, sgrad_ms = [], []
    for _ in range(runs):
        ms, gz = event_ms(shadow_grad_step)
        sgrad_ms.append(ms)
        sgrads.append(gz)
    sf_med, sg_med = float(np.median(sfwd_ms)), float(np.median(sgrad_ms))
    print(f"  forward (loss, K2, no grad) median {sf_med:.2f} ms (min "
          f"{min(sfwd_ms):.2f}, max {max(sfwd_ms):.2f}); loss + backward() "
          f"median {sg_med:.2f} ms (min {min(sgrad_ms):.2f}, max "
          f"{max(sgrad_ms):.2f}), {sg_med / n_sun:.3f} ms per sun; "
          f"grad/forward {sg_med / sf_med:.3f}, grad / K2 alone "
          f"{sg_med / k2_ms:.3f}  [{card}]")
    gz = sgrads[-1]
    check(bool(torch.isfinite(gz).all()) and gz.abs().max().item() > 0.0,
          f"z.grad finite and nonzero (max |g| {gz.abs().max().item():.3e})")
    check(torch.equal(sgrads[-1], sgrads[-2]),
          "z.grad bit-equal across runs")
    del sgrads, gz

    def k2a_run():
        return shadow_sweep._metric_cuda(*sargs, grid_origin=(0.0, 0.0),
                                         emit_argmax=True)

    k2a_run()
    k2a_ms = cuda_ms(k2a_run, 10)
    err, k2a_plain_ms = check_shadow_argmax("row B", sargs, (0.0, 0.0))
    sa_err = max(sa_err, err)
    met, ids, aux = k2a_run()
    sig = torch.sigmoid(met / 2.0)
    gmet = sig * (1.0 - sig) * (0.5 / met.numel())   # d loss / d metric
    del sig, met
    bargs = (tuple(zt.shape), gmet, ids, aux, sargs[4])
    shadow_b = (table_b, sargs[0], (0.0, 0.0))
    replay._bwd_cuda(*bargs, shadow=shadow_b)
    k4_ms = cuda_ms(lambda: replay._bwd_cuda(*bargs, shadow=shadow_b), 10)
    cots, dzo = replay._bwd_cuda(*bargs, shadow=shadow_b)
    k4_bound = replay_bound(gmet, ids, aux, sargs[4], cots, dzo, shadow=True)
    print_levels("shadow-gradient row")
    del cots, dzo
    err, k4_plain_ms = check_shadow_replay("row B", sargs, (0.0, 0.0), gmet,
                                           (ids, aux))
    sb_err = max(sb_err, err)
    print(f"  K2-argmax alone: {k2a_ms:.3f} ms ({k2a_ms / k2_ms:.3f} x K2); "
          f"plain argmax sweep: {k2a_plain_ms:.1f} ms  [{card}]")
    # the argmax variant keeps K2's running value, so it skips as K2 does
    k2a_bound = skip_report("K2-argmax (row E)", sargs, True, k2a_ms, card,
                            k2_counted(sargs, (0.0, 0.0), emit_argmax=True),
                            b_counts)
    print(f"  K4 alone: {k4_ms:.3f} ms; plain shadow replay: "
          f"{k4_plain_ms:.1f} ms; bound {k4_bound[0]:.4f} ms "
          f"({k4_bound[1]}); the rest of a gradient step (loss, pyramid and "
          f"its VJP, host) {sg_med - k2a_ms - k4_ms:.2f} ms  [{card}]")
    del gmet, ids, aux, bargs, shadow_b, sargs

    print("== F. Terrain.sw_dir_cor_soft at the artificial example's "
          "defaults")
    hard = terrain.sw_dir_cor_batch(suns)
    soft = terrain.sw_dir_cor_soft(suns)
    check(torch.equal(soft, hard) and soft.grad_fn is None,
          "straight-through value bit-equal to sw_dir_cor_batch (no "
          "gradient asked)")
    del soft

    def soft_step():
        zg = terrain._z_outer.clone().requires_grad_(True)
        out = terrain.sw_dir_cor_soft(suns, elevation=zg)
        out.mean().backward()
        return out.detach(), zg.grad

    soft_step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    shadow_sweep.ARGMAX_KERNEL_LAUNCHES = 0
    replay.SHADOW_KERNEL_LAUNCHES = 0
    f_walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        out, gz = soft_step()
        torch.cuda.synchronize()
        f_walls.append(time.perf_counter() - t0)
    k2a_launches = shadow_sweep.ARGMAX_KERNEL_LAUNCHES
    k4_launches = replay.SHADOW_KERNEL_LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    f_wall = float(np.median(f_walls))
    print(f"  sw_dir_cor_soft + mean().backward(), 181 suns x "
          f"{terrain.comp_shape}: median {f_wall:.4f} s wall of 3 (min "
          f"{min(f_walls):.4f}, max {max(f_walls):.4f}; "
          f"{f_wall / c_wall:.3f} x sw_dir_cor_batch); peak "
          f"{peak / 2**20:.1f} MiB allocated  [{card}]")
    check(k2a_launches == 3 and k4_launches == 3,
          f"main path launched K2-argmax ({k2a_launches}) and K4 "
          f"({k4_launches}) once per step in 3 steps")
    check(torch.equal(out, hard), "straight-through value with a gradient "
          "asked bit-equal to sw_dir_cor_batch")
    check(bool(torch.isfinite(gz).all()) and gz.abs().max().item() > 0.0,
          f"elevation.grad finite and nonzero (max |g| "
          f"{gz.abs().max().item():.3e})")
    del hard, out, gz
    fargs = cargs

    def k2a_f():
        return shadow_sweep._metric_cuda(
            *fargs, grid_origin=terrain._grid_origin, emit_argmax=True,
            pooled=pooled_c)

    k2a_f()
    k2a_f_ms = cuda_ms(k2a_f, 3)
    met, ids, aux = k2a_f()
    g = torch.from_numpy(np.random.default_rng(9).normal(
        size=tuple(met.shape)).astype(np.float32)).to(dev)
    fb = (tuple(terrain._z_outer.shape), g, ids, aux, fargs[4])
    shadow_f = (fargs[3], fargs[0], terrain._grid_origin)
    replay._bwd_cuda(*fb, shadow=shadow_f)
    k4_f_ms = cuda_ms(lambda: replay._bwd_cuda(*fb, shadow=shadow_f), 3)
    print_levels("181 suns")
    print(f"  on the 181 suns alone: K2-argmax {k2a_f_ms:.3f} ms, K4 "
          f"{k4_f_ms:.3f} ms; the rest of a step (classification and its "
          f"backward, pyramid and its VJP, host) "
          f"{1e3 * f_wall - k2a_f_ms - k4_f_ms:.1f} ms  [{card}]")
    skip_report("K2-argmax (181 suns)", fargs, True, k2a_f_ms, card,
                k2_counted(fargs, terrain._grid_origin, emit_argmax=True,
                           pooled=pooled_c), counts_e)
    del met, ids, aux, g, fb, shadow_f, fargs
    few = [0, 45, 100, 150]
    fargs = terrain_args(suns[few])
    sa_err = max(sa_err, check_shadow_argmax(f"suns {few}", fargs,
                                             terrain._grid_origin)[0])
    g = torch.from_numpy(np.random.default_rng(10).normal(
        size=(len(few),) + terrain.comp_shape).astype(np.float32)).to(dev)
    sb_err = max(sb_err, check_shadow_replay(f"suns {few}", fargs,
                                             terrain._grid_origin, g)[0])
    del fargs, g

    kink_check(dev)

    var_err = phase_g(dev)
    (mask_launches, mask_err, mask_ms, mask_plain_ms,
     mask_bound) = phase_h(dev, zt, x, y, halo, azim_num, dist_km, k1_ms,
                           card, runs)
    (tilt_launches, tilt_err, tilt_ms, tilt_plain_ms,
     tilt_bound) = phase_i(dev, azim_num, card, curved_bench_scene(), 256,
                           512, srtm_like_scene())

    t_j = time.perf_counter()
    k5_row, alu_rate = phase_j(dev, card)
    for what, bnd in (("K1", k1_bound), ("K2", k2_bound)):
        if bnd[1] == "operations":
            print(f"  {what}'s operation bound {bnd[0]:.3f} ms at "
                  f"{PEAK_F32_OPS / 1e12:.0f} TFLOP/s is "
                  f"{bnd[0] * PEAK_F32_OPS / alu_rate:.3f} ms at the "
                  f"measured alu rate")
    t_k = time.perf_counter()
    mr_am_err, mr_bwd_err = phase_k(dev, card)
    am_err, bwd_err = max(am_err, mr_am_err), max(bwd_err, mr_bwd_err)
    t_l = time.perf_counter()
    c_sa_err, c_sb_err = phase_l(dev, card)
    sa_err, sb_err = max(sa_err, c_sa_err), max(sb_err, c_sb_err)
    t_m = time.perf_counter()
    phase_m(dev, card)
    t_n = time.perf_counter()
    k2m_row = phase_n(dev, card, zt.cpu().numpy(), x, y, halo, azim_num,
                      dist_km, k1_ms)
    t_o = time.perf_counter()
    shard_rows = phase_o(
        dev, card, zt, halo, inner, azim_num, dist_km, dx, track,
        dict(k1=(k1_ms, plain_ms, k1_bound), k2=(k2_ms, k2_plain_ms, k2_bound),
             k3=(k3_ms, k3_plain_ms, k3_bound),
             k4=(k4_ms, k4_plain_ms, k4_bound)))
    t_p = time.perf_counter()
    tile_launches, chunk_launches = phase_p(
        dev, card, zt.cpu().numpy(), halo, inner, azim_num, dist_km, dx,
        k1_args, k1_ms, k1_samples)
    print(f"  phase J {t_k - t_j:.1f} s, phase K {t_l - t_k:.1f} s, phase L "
          f"{t_m - t_l:.1f} s, phase M {t_n - t_m:.1f} s, phase N "
          f"{t_o - t_n:.1f} s, phase O {t_p - t_o:.1f} s, phase P "
          f"{time.perf_counter() - t_p:.1f} s")

    print("== 9. result")
    print(f"  phases 1-P in {time.perf_counter() - t_run:.1f} s")
    rows = [
        ("horizon_sweep (K1)", KERNEL_SOURCE, REPLACES, launches, max_err,
         k1_ms, plain_ms, k1_bound),
        ("horizon_sweep argmax (K1-argmax)", KERNEL_SOURCE, REPLACES,
         am_launches, am_err, am_ms, am_plain_ms, am_bound),
        ("horizon_replay_bwd (K3)", BWD_SOURCE, BWD_REPLACES, k3_launches,
         bwd_err, k3_ms, k3_plain_ms, k3_bound),
        ("shadow_sweep (K2)", KERNEL_SOURCE, SHADOW_REPLACES, k2_launches,
         sh_err, k2_ms, k2_plain_ms, k2_bound),
        ("shadow_sweep argmax (K2-argmax)", KERNEL_SOURCE, SHADOW_REPLACES,
         k2a_launches, sa_err, k2a_ms, k2a_plain_ms, k2a_bound),
        ("shadow_replay_bwd (K4)", BWD_SOURCE, SHADOW_BWD_REPLACES,
         k4_launches, sb_err, k4_ms, k4_plain_ms, k4_bound),
        ("horizon_sweep mask (K1-mask)", KERNEL_SOURCE, MASK_REPLACES,
         mask_launches, max(var_err, mask_err), mask_ms, mask_plain_ms,
         mask_bound),
        ("horizon_sweep tilt (K1-tilt)", KERNEL_SOURCE, TILT_REPLACES,
         tilt_launches, max(var_err, tilt_err), tilt_ms, tilt_plain_ms,
         tilt_bound),
        ("shadow_sweep mask (K2-mask)", KERNEL_SOURCE,
         SHADOW_MASK_REPLACES) + k2m_row,
        # K5 is on no user path of the library; its launches are those of
        # its own entry, read_floor.time_modes, in phase J
        ("read_floor (K5)", READ_FLOOR_SOURCE, READ_FLOOR_REPLACES) + k5_row]
    # no single PyTorch call computes a sweep, a winner replay or the
    # shifted bilinear running max, so library_ms is null for every kernel.
    # A shard row: launches on phase O's path, its error against the single
    # launch, the summed shards' time (ms) and the single launch's
    # (single_ms), the single launch's bound and plain version (the same
    # function on the same inputs: the shards' outputs are bit-equal to it)
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": n, "max_abs_err": err, "ms": ms, "plain_ms": p_ms,
         "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None}
        for name, src, rep, n, err, ms, p_ms, bnd in rows]
    # K1 and K2 also carry the launches of phase P's runners, each path's
    # count set to 0 just before it and read just after
    kernels[0]["launches_by_path"] = {
        "PlanarPipeline.run": launches,
        "TiledHorizonRunner.run": tile_launches}
    kernels[3]["launches_by_path"] = {
        "Terrain.sw_dir_cor_batch/shadow_batch": k2_launches,
        "SunTrackRunner.run": chunk_launches}
    for name, src, rep, n, err, ms, p_ms, bnd, one_ms in shard_rows:
        kernels.append(
            {"name": name, "route": "cuda", "source": src, "replaces": rep,
             "launches": n, "max_abs_err": err, "ms": ms, "plain_ms": p_ms,
             "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None,
             "single_ms": one_ms})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--pair-worker":
        sys.exit(pair_worker(int(sys.argv[2]), int(sys.argv[3])))
    sys.exit(main())
