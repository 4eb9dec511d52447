"""Scenes of the sweep's skips, shared by the CPU tests
(tests/test_torch_sweep_skips.py for K1, tests/test_torch_shadow_skips.py
for K2) and the card's (tests/test_torch_cuda.py), the curved meshes of
the curved shadow and locations tests, a NumPy transcription of the
refraction's float32 arithmetic, the sharded scenes of
tests/test_torch_sharding.py and the card's, the streaming runners'
scenes of tests/test_torch_utils.py and the card's, and the planar and
curved pipelines' scenes and vertex-buffer routes of
tests/test_torch_pipeline.py and the card's, the planarisation's
meshes of tests/test_torch_planarize.py and the card's, and the curved
geometry's lon/lat DEMs, with a NumPy model of its kernel, of
tests/test_torch_geometry.py and the card's, and the TIN far field's
scenes of tests/test_torch_tin_raster.py, the card's and chip_smoke.py's
phase K.  Imports no JAX."""

import math

import numpy as np
import torch

from horayzon_tpu_torch import auxiliary, horizon, topo_param, transform
from horayzon_tpu_torch.models import CurvedPipeline, PlanarPipeline
from reference_impl import gaussian_bumps_terrain


def skip_scene(name):
    """(z, sweep keywords, mask or None) of a scene for the sweep's skips
    (see the module's docstring)."""
    kw = dict(dx=25.0, dy=-25.0, azim_num=8, offset=(120, 110),
              inner_shape=(20, 72), dist_search=8000.0)
    n = (260, 292)
    if name == "random":
        return gaussian_bumps_terrain(*n, seed=6, amp=600.0), kw, None
    if name == "random_dx24.7":
        # a step whose multiples float32 rounds: the pairs' second
        # distances differ from float32((m + 1) * step)
        return (gaussian_bumps_terrain(*n, seed=10, amp=600.0),
                dict(kw, dx=24.7, dy=-24.7), None)
    if name in ("spike_inside", "spike_outside"):
        # flat terrain, a far spike north of the block (read by the mip
        # phases) on the last column of the first warp or the first column
        # of the second, and a lower one in the safe d1 range
        z = np.zeros((420, 292), np.float32)
        col = 110 + (31 if name == "spike_inside" else 32)
        z[8, col] = 2000.0
        z[200, col + 3] = 300.0
        return z, dict(kw, offset=(280, 110)), None
    if name == "plateau":
        # the block on a 400 m plateau: the far terrain lies below every
        # ray origin, so every far numerator is negative
        z = gaussian_bumps_terrain(*n, seed=8, amp=150.0)
        z[100:160, 90:200] += 400.0
        return z, kw, None
    if name == "flat_pit":
        # a flat plane with the block sunk 100 m: the rim sets the
        # running value, and every far chunk of the flat plane skips
        z = np.zeros(n, np.float32)
        z[115:145, 105:187] = -100.0
        return z, kw, None
    if name == "masked":
        z = gaussian_bumps_terrain(*n, seed=9, amp=500.0)
        mask = np.zeros(kw["inner_shape"], np.uint8)
        mask[3:15, 10:40] = 1
        mask[::4, 60:] = 1
        return z, kw, mask
    raise KeyError(name)


SKIP_SCENES = ["random", "random_dx24.7", "spike_inside", "spike_outside",
               "plateau", "flat_pit", "masked"]


def shadow_skip_scene(name):
    """(z, offset, inner shape, dx, dy, suns relative to the domain centre)
    of a scene for K2's skips.  Every scene has safe and masked d1 pairs and
    a mip phase of three chunks; the grid origin is (0, 0)."""
    n, off, inner = (260, 292), (120, 110), (20, 72)
    if name == "random":
        # dx != dy; a sun below the cells (m < 0) and one near overhead
        return (gaussian_bumps_terrain(*n, seed=6, amp=600.0), off, inner,
                25.0, -30.0, [(2.0e5, 1.0e5, 1.5e4), (-1.0e5, 2.0e5, 0.8e4),
                              (3.0e4, -2.0e5, 0.0), (1.0e3, 5.0e2, 1.0e5)])
    if name == "flat_pit":
        # a flat plane with the block sunk 100 m: no terrain beyond the rim
        # reaches a ray, so the far chunks skip
        z = np.zeros(n, np.float32)
        z[115:145, 105:187] = -100.0
        return z, off, inner, 25.0, -25.0, [(2.0e5, 1.0e5, 2.0e4),
                                           (-1.5e5, -0.5e5, 6.0e3)]
    if name == "spike":
        # flat terrain, a far spike north of the block read by the mip
        # phases, a lower one in the safe d1 range; suns toward and away
        z = np.zeros((420, 292), np.float32)
        z[8, 141] = 2000.0
        z[200, 144] = 300.0
        return z, (280, 110), inner, 25.0, -25.0, [
            (0.0, 2.0e5, 2.0e4), (3.0e3, 2.0e5, 4.0e4),
            (0.0, -2.0e5, 1.0e4)]
    if name == "ridge_low_sun":
        # a concave ridge across the rays in the d1 range, low suns behind
        # it: the rays graze its crest, where parabola vertices win
        z = np.zeros(n, np.float32)
        rows = np.arange(n[0], dtype=np.float32)[:, None]
        cols = np.arange(n[1], dtype=np.float32)[None, :]
        crest = 60.0 + 6.0 * np.sin(cols / 9.0)
        z += (95.0 * np.exp(-((rows - crest) ** 2) / (2 * 7.0 ** 2))
              ).astype(np.float32)
        return z, off, inner, 25.0, -25.0, [
            (1.0e4, 3.0e5, 1.6e4), (-2.0e4, 3.0e5, 1.8e4),
            (0.0, 3.0e5, 2.2e4)]
    if name == "overhead":
        # suns nearly overhead: ray slopes of 10-1000
        return (gaussian_bumps_terrain(*n, seed=11, amp=800.0), off, inner,
                25.0, -25.0, [(1.0e3, 5.0e2, 1.0e5), (-2.0e2, -3.0e2, 8.0e4)])
    raise KeyError(name)


SHADOW_SKIP_SCENES = ["random", "flat_pit", "spike", "ridge_low_sun",
                      "overhead"]


def curved_setup(elev_fn, n=160, dlat=0.002, lat0=45.0, lon0=7.0):
    """tests/test_curved.py:8-28 on the port's NumPy copies: an ``n``^2
    lon/lat grid of ``dlat`` degree around (lon0, lat0) on the sphere,
    north up, heights ``elev_fn(lon, lat)``, as an ENU mesh with its unit
    normals and north vectors."""
    from horayzon_tpu_torch import direction, transform
    lat = lat0 + (np.arange(n)[::-1] - n / 2) * dlat
    lon = lon0 + (np.arange(n) - n / 2) * dlat
    lon2, lat2 = np.meshgrid(lon, lat)
    elevation = elev_fn(lon2, lat2).astype(np.float32)
    trans = transform.TransformerEcef2enu(lon0, lat0, "sphere")
    xe, ye, ze = transform.lonlat2ecef(lon2, lat2, elevation, "sphere")
    x, y, z = transform.ecef2enu(xe, ye, ze, trans)
    vn_ecef = direction.surf_norm(lon2, lat2)
    vnorth_ecef = direction.north_dir(xe, ye, ze, vn_ecef, "sphere")
    return dict(x=x, y=y, z=z, elevation=elevation, lon2=lon2, lat2=lat2,
                vec_norm=transform.ecef2enu_vector(vn_ecef, trans),
                vec_north=transform.ecef2enu_vector(vnorth_ecef, trans))


def bumps(seed, count=8, sig=(0.004, 0.02), amp=(100.0, 500.0)):
    """``elev_fn`` of :func:`curved_setup`: ``count`` gaussian bumps drawn
    with ``seed`` (tests/test_curved.py:240-252 with seed 4)."""
    def elev_fn(lon, lat):
        rng = np.random.default_rng(seed)
        e = np.zeros_like(lon)
        for _ in range(count):
            clon = rng.uniform(lon.min(), lon.max())
            clat = rng.uniform(lat.min(), lat.max())
            sg = rng.uniform(*sig)
            e += rng.uniform(*amp) * np.exp(
                -(((lon - clon) ** 2 + (lat - clat) ** 2) / (2 * sg ** 2)))
        return e
    return elev_fn


def wall(lat_wall, wall_h):
    """``elev_fn`` of :func:`curved_setup`: a wall ``wall_h`` metres high
    along the latitude ``lat_wall`` (0.004 degree wide)."""
    def elev_fn(lon, lat):
        e = np.zeros_like(lon)
        e[np.abs(lat - lat_wall) < 0.002] = wall_h
        return e
    return elev_fn


def curved_terrain_inputs(s, offset, inner, mask=None):
    """``Terrain.initialise`` inputs of the curved mesh ``s``
    (:func:`curved_setup`) as the curved shadow examples build them
    (examples/shadow/gridded_curved_dem_srtm.py): ``slope_vector_meth``
    on the inner block and a one-cell ring, the surface enlargement
    factor, the lon/lat grid's elevation; ``mask`` defaults to all ones."""
    from horayzon_tpu_torch import auxiliary, topo_param
    (o0, o1), (in0, in1) = offset, inner
    sl = (slice(o0, o0 + in0), slice(o1, o1 + in1))
    sl1 = (slice(o0 - 1, o0 + in0 + 1), slice(o1 - 1, o1 + in1 + 1))
    vec_norm = np.ascontiguousarray(s["vec_norm"][sl], dtype=np.float32)
    vec_tilt = np.ascontiguousarray(topo_param.slope_vector_meth(
        s["x"][sl1], s["y"][sl1], s["z"][sl1]).numpy()[1:-1, 1:-1])
    return dict(
        vert_grid=auxiliary.rearrange_pad_buffer(s["x"], s["y"], s["z"]),
        vec_tilt=vec_tilt, vec_norm=vec_norm,
        surf_enl_fac=topo_param.surface_enlargement_factor(
            vec_norm, vec_tilt).numpy(),
        elevation=np.ascontiguousarray(s["elevation"][sl]),
        mask=np.ones(inner, np.uint8) if mask is None else mask,
        dem_dim=s["z"].shape, offset=offset)


def refraction_numpy(elev, temp, pres, height, fn):
    """``ops.refraction.atmos_refrac(elev, temp, pres)`` and
    ``reference_atmosphere(height)`` transcribed in NumPy float32, whose
    division rounds once; ``fn(name, x)`` evaluates the torch function
    ``name`` ("tan", "pow") on a float32 array on the device under test
    (the transcendental functions are not what is compared).  Returns
    ``(refrac_deg, temperature, pressure)``."""
    f = np.float32
    e = np.clip(elev, f(-1.0), f(90.0))
    arg = (e + f(10.3) / (e + f(5.11))) * f(math.pi / 180.0)
    refrac = f(1.02) / fn("tan", arg)
    refrac = refrac + f(0.0019279)
    refrac = (refrac * (pres / f(101.0))) * (f(283.0) / (f(273.0) + temp))
    temperature = f(283.15) - f(0.0065) * height
    pressure = f(101.0) * fn("pow", temperature / f(283.15))
    return refrac / f(60.0), temperature, pressure


#: Meshes of the sharded tests: the reference's (tests/test_sharding.py:38)
#: and (4, 2).
SHARD_MESHES = [(8, 1), (2, 4), (1, 8), (2, 2), (4, 2)]


def sharded_scenes():
    """The inputs of the reference's sharded cases (tests/test_sharding.py:
    97-398), with its seeds: the 64^2 bumps (seed 7) with its 32^2 block at
    (16, 16) and their tilt ramps (``ramp``: seed 3, 32^2; ``gramp``: seed
    5, 8 x 32), the shadow cases' sun tables (``table2``: two suns,
    ``table3``: three), and the multires case (4 km at accuracy 2, ratio
    4, a 96-cell fine halo; seed 9)."""
    from horayzon_tpu_torch.ops import shadow_sweep
    f32 = np.float32
    terrain = gaussian_bumps_terrain(64, 64, seed=7, amp=400.0)
    rng = np.random.default_rng(3)
    ramp = tuple(rng.normal(0.0, 1e-4, (32, 32)).astype(f32)
                 for _ in range(2))
    rng = np.random.default_rng(5)
    gramp = tuple(rng.normal(0.0, 1e-4, (8, 32)).astype(f32)
                  for _ in range(2))
    dx, n = 25.0, 64
    cx, cy = 0.5 * (n - 1) * dx, -0.5 * (n - 1) * dx
    suns = np.array([[cx + 2e5, cy + 1e5, 2e4], [cx - 1e5, cy - 2e5, 1.5e4],
                     [cx + 5e4, cy - 2e5, 8e3]], dtype=f32)
    table2, _ = shadow_sweep.shadow_sun_table(suns[:2], (cx, cy), dx, -dx)
    table3, _ = shadow_sweep.shadow_sun_table(suns, (cx, cy), dx, -dx)
    dist = 4000.0
    halo_full = int(dist / dx) + 16
    full = gaussian_bumps_terrain(32 + 2 * halo_full, 32 + 2 * halo_full,
                                  seed=9, amp=500.0)
    i0 = halo_full - 96
    z_fine = np.ascontiguousarray(full[i0:i0 + 224, i0:i0 + 224])
    h, w = full.shape
    z_coarse = full[:h - h % 4, :w - w % 4].reshape(
        h // 4, 4, w // 4, 4).max(axis=(1, 3))
    return dict(
        terrain=terrain, ramp=ramp, gramp=gramp, table2=table2,
        table3=table3, z_in=terrain[16:48, 16:48],
        z_org=terrain[16:48, 16:48] + f32(0.05),
        diag=float(np.hypot(n * dx, n * dx)), z_fine=z_fine,
        z_coarse=np.ascontiguousarray(z_coarse), i0=i0,
        hz_kw=dict(dx=25.0, dy=-25.0, offset=(16, 16), inner_shape=(32, 32),
                   dist_search=600.0, hori_acc=0.25, azim_num=16),
        tilt_kw=dict(dx=25.0, dy=-25.0, offset=(16, 16),
                     inner_shape=(32, 32), dist_search=500.0, azim_num=8),
        grad_kw=dict(dx=25.0, dy=-25.0, offset=(16, 16), inner_shape=(8, 32),
                     dist_search=150.0, azim_num=2),
        shadow_kw=dict(offset=(16, 16), inner_shape=(32, 32), dx=25.0,
                       dy=-25.0, grid_origin=(0.0, 0.0)),
        mr_kw=dict(ratio_log2=2, coarse_offset=(i0, i0), dx=25.0, dy=-25.0,
                   offset=(96, 96), inner_shape=(32, 32), dist_search=dist,
                   hori_acc=2.0, azim_num=8))


#: The tiled runner's scenes: (z, keywords of the whole run, tile).
#: "bumps96" is tests/test_utils.py's scene (96^2, inner 48^2 at 24,
#: 500 m, 32^2 tiles, the last row and column 16 wide): every tile's halo
#: is the whole run's, so every tile has its n_safe.  "nearfield84" has 34
#: cells of halo above and left, 18 below and right: the whole run and
#: three tiles get n_safe 16, tile (0, 0) n_safe 32 = n_dense - 1, the
#: reference's near-field-h2 case (pallas_sweep.py:754-757).
RUNNER_SCENES = {
    "bumps96": (gaussian_bumps_terrain(96, 96, seed=13, amp=400.0),
                dict(offset=(24, 24), inner_shape=(48, 48),
                     dist_search=500.0), (32, 32)),
    "nearfield84": (gaussian_bumps_terrain(84, 84, seed=7, amp=300.0),
                    dict(offset=(34, 34), inner_shape=(32, 32),
                         dist_search=825.0), (16, 16)),
}


def sun_track_terrain_inputs():
    """tests/test_utils.py's sun-track scene: ``Terrain.initialise``'s
    arguments (48^2 bumps at 25 m, inner 32^2 at 8, flat normals) and its
    7 suns (T, 3) float32."""
    z = gaussian_bumps_terrain(48, 48, seed=21, amp=400.0)
    dx = 25.0
    h, w = z.shape
    off, in0, in1 = 8, 32, 32
    x1 = np.arange(w, dtype=np.float32) * dx
    y1 = -np.arange(h, dtype=np.float32) * dx
    xx, yy = np.meshgrid(x1, y1)
    vert_grid = auxiliary.rearrange_pad_buffer(xx, yy, z)
    vec_norm = np.zeros((in0, in1, 3), dtype=np.float32)
    vec_norm[..., 2] = 1.0
    args = (vert_grid, h, w, off, off, vec_norm.copy(), vec_norm,
            np.ones((in0, in1), dtype=np.float32),
            z[off:off + in0, off:off + in1],
            np.ones((in0, in1), dtype=np.uint8))
    ang = np.linspace(0.2, 2.8, 7)
    suns = np.stack([1e7 * np.cos(ang), 1e7 * np.sin(ang),
                     2e6 + 1e6 * np.sin(ang)], axis=-1).astype(np.float32)
    return args, suns


def recompute_scenes():
    """The recompute VJP's scenes (tests/test_torch_recompute.py and the
    card's).  ``spike``: tests/test_pallas.py:275-312's far field (544^2
    flat, spikes of 500 m and 400 m 2.4 and 3.75 km north of the 32^2
    block, 6 km, 4 azimuths), whose gradient flows through mip winners.
    ``bumps`` (seed 11, with a tilt ramp, seed 12) and ``masked`` (seed
    13, about half the cells masked, seed 14, and a fixed cotangent on
    every cell, seed 15) share its geometry, so one compile of the
    reference serves all three.  ``shard``: the reference's sharded
    gradient case (tests/test_sharding.py:236-279: the 64^2 bumps of
    seed 7, an 8 x 32 block at (16, 16), 150 m, the ramp of seed 5) at 8
    azimuths, so the (1, 8) mesh divides them; ``shard_wide``: a 16 x 32
    block at 300 m with a ramp (seed 16), whose schedule has a masked d2
    phase, for the port-against-port checks.  Each: ``(z, keywords,
    ramp or None, mask or None, cotangent or None)``."""
    f32 = np.float32
    dist = 6000.0
    halo, inner = int(dist / 25) + 16, 32
    n = inner + 2 * halo
    spike = np.zeros((n, n), dtype=f32)
    spike[halo - 96, halo + 16] = 500.0
    spike[halo - 150, halo + 8] = 400.0
    kw = dict(dx=25.0, dy=-25.0, offset=(halo, halo),
              inner_shape=(inner, inner), dist_search=dist, hori_acc=0.25,
              azim_num=4)
    rng = np.random.default_rng(12)
    ramp = tuple(rng.normal(0.0, 0.05, (inner, inner)).astype(f32)
                 for _ in range(2))
    mask = (np.random.default_rng(14).random((inner, inner)) < 0.5) \
        .astype(np.uint8)
    cot = np.random.default_rng(15).normal(
        0.0, 1e-3, (inner, inner, 4)).astype(f32)
    terrain = gaussian_bumps_terrain(64, 64, seed=7, amp=400.0)
    rng = np.random.default_rng(5)
    gramp = tuple(rng.normal(0.0, 1e-4, (8, 32)).astype(f32)
                  for _ in range(2))
    rng = np.random.default_rng(16)
    wramp = tuple(rng.normal(0.0, 1e-2, (16, 32)).astype(f32)
                  for _ in range(2))
    skw = dict(dx=25.0, dy=-25.0, offset=(16, 16), hori_acc=0.25,
               azim_num=8)
    return {
        "spike": (spike, kw, None, None, None),
        "bumps": (gaussian_bumps_terrain(n, n, seed=11, amp=600.0), kw,
                  ramp, None, None),
        "masked": (gaussian_bumps_terrain(n, n, seed=13, amp=600.0), kw,
                   None, mask, cot),
        "shard": (terrain, dict(skw, inner_shape=(8, 32), dist_search=150.0),
                  gramp, None, None),
        "shard_wide": (terrain, dict(skw, inner_shape=(16, 32),
                                     dist_search=300.0), wramp, None, None),
    }


#: The planar pipeline's masks: none, glacier-style patches, every cell.
PIPELINE_MASKS = ("none", "patches", "all_masked")


def planar_pipeline_scene(n=96, pad=400.0, seed=4, jitter=None,
                          mask="none", device="cpu", **kw):
    """``(PlanarPipeline, mask)`` on ``n``^2 bumps at 25 m, north-up, the
    inner domain ``pad`` metres inside the outer one, 8 azimuths and 0.3
    km unless ``kw`` says otherwise; ``jitter`` "x" or "y" moves one
    point of that axis by a tenth of a step (the axes are then not
    uniform); ``mask`` one of :data:`PIPELINE_MASKS`."""
    dx = 25.0
    z = gaussian_bumps_terrain(n, n, seed=seed, amp=400.0)
    x = np.arange(n, dtype=np.float32) * dx
    y = (n - 1 - np.arange(n, dtype=np.float32)) * dx
    domain = {"x_min": float(x[0]) + pad, "x_max": float(x[-1]) - pad,
              "y_min": float(y[-1]) + pad, "y_max": float(y[0]) - pad}
    if jitter is not None:
        {"x": x, "y": y}[jitter][n // 3] += np.float32(0.1 * dx)
    args = dict(dist_search=0.3, azim_num=8)
    args.update(kw)
    pipe = PlanarPipeline(x, y, z, domain, device=device, **args)
    return pipe, _pipeline_mask(pipe, mask, seed)


def _pipeline_mask(pipe, mask, seed):
    """The mask ``mask`` (one of :data:`PIPELINE_MASKS`) of ``pipe``'s inner
    block: None, five seeded round patches of considered cells, or
    zeros."""
    in0, in1 = (s.stop - s.start for s in pipe.slice_in)
    m = None
    if mask == "patches":
        yy, xx = np.mgrid[0:in0, 0:in1]
        rng = np.random.default_rng(seed)
        m = np.zeros((in0, in1), np.uint8)
        for cy, cx, r in zip(rng.uniform(0, in0, 5), rng.uniform(0, in1, 5),
                             rng.uniform(2.0, 0.2 * min(in0, in1), 5)):
            m[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = 1
    elif mask == "all_masked":
        m = np.zeros((in0, in1), np.uint8)
    return m


def planar_buffer_route(pipe, mask=None):
    """``PlanarPipeline.run``'s outputs through the vertex buffer: the
    meshgrid of its axes, ``auxiliary.rearrange_pad_buffer``,
    ``horizon_gridded`` with default vectors, and the topo parameters from
    the meshgrid's host planes."""
    in0, in1 = (s.stop - s.start for s in pipe.slice_in)
    vec_norm = np.zeros((in0, in1, 3), dtype=np.float32)
    vec_norm[..., 2] = 1.0
    vec_north = np.zeros((in0, in1, 3), dtype=np.float32)
    vec_north[..., 1] = 1.0
    x_2d, y_2d = np.meshgrid(pipe.x, pipe.y)
    vert_grid = auxiliary.rearrange_pad_buffer(x_2d, y_2d, pipe.elevation)
    hori, azim = horizon.horizon_gridded(
        vert_grid, *pipe.elevation.shape, vec_norm, vec_north,
        pipe.offset_0, pipe.offset_1, dist_search=pipe.dist_search,
        azim_num=pipe.azim_num, hori_acc=pipe.hori_acc,
        elev_ang_low_lim=pipe.elev_ang_low_lim, mask=mask,
        device=pipe.device)

    def on_device(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(pipe.device)

    s0, s1 = pipe.slice_in
    sl = (slice(s0.start - 1, s0.stop + 1), slice(s1.start - 1, s1.stop + 1))
    vec_tilt = topo_param.slope_plane_meth(
        *(on_device(a[sl]) for a in (x_2d, y_2d, pipe.elevation)))[1:-1, 1:-1]
    svf = topo_param.sky_view_factor(azim, hori, vec_tilt)
    slope, aspect = topo_param.slope_angle_aspect(vec_tilt)
    return {"hori": hori, "azim": azim, "svf": svf, "slope": slope,
            "aspect": aspect, "vec_tilt": vec_tilt,
            "elevation": on_device(pipe.elevation[pipe.slice_in]),
            "x": on_device(pipe.x[s1]), "y": on_device(pipe.y[s0])}


def curved_pipeline_scene(n0=72, n1=96, seed=5, mask="none", device="cpu",
                          **kw):
    """``(CurvedPipeline, mask)`` on an ``n0`` x ``n1`` lon/lat DEM of six
    seeded bumps of 100-800 m around (8.0, 46.5) at 1/1200 degree, WGS84,
    the inner domain 16 rows and 20 columns inside the outer one, 8
    azimuths and 1.5 km unless ``kw`` says otherwise; ``mask`` one of
    :data:`PIPELINE_MASKS`."""
    d = 1.0 / 1200.0
    lon = 7.96 + (np.arange(n1) + 0.5) * d
    lat = 46.54 - (np.arange(n0) + 0.5) * d
    lon2, lat2 = np.meshgrid(lon, lat)
    rng = np.random.default_rng(seed)
    z = np.zeros_like(lon2)
    for _ in range(6):
        c0, c1 = rng.uniform(lon.min(), lon.max()), rng.uniform(lat.min(),
                                                                lat.max())
        sig = rng.uniform(0.004, 0.02)
        z += rng.uniform(100.0, 800.0) * np.exp(
            -((lon2 - c0) ** 2 + (lat2 - c1) ** 2) / (2.0 * sig ** 2))
    domain = {"lon_min": float(lon[20]), "lon_max": float(lon[n1 - 21]),
              "lat_min": float(lat[n0 - 17]), "lat_max": float(lat[16])}
    args = dict(dist_search=1.5, azim_num=8, ellps="WGS84")
    args.update(kw)
    pipe = CurvedPipeline(lon, lat, z.astype(np.float32), domain,
                          device=device, **args)
    return pipe, _pipeline_mask(pipe, mask, seed)


def curved_buffer_route(pipe, mask=None):
    """``CurvedPipeline.run``'s outputs through the vertex buffer: the ENU
    mesh packed by ``auxiliary.rearrange_pad_buffer``, ``horizon_gridded``
    with the mesh's normals and norths, and the topo parameters in the
    local frames."""
    if not hasattr(pipe, "x"):
        pipe.build_geometry()
    vert_grid = auxiliary.rearrange_pad_buffer(pipe.x, pipe.y, pipe.z)
    hori, azim = horizon.horizon_gridded(
        vert_grid, *pipe.elevation.shape, pipe.vec_norm, pipe.vec_north,
        pipe.offset_0, pipe.offset_1, dist_search=pipe.dist_search,
        azim_num=pipe.azim_num, hori_acc=pipe.hori_acc,
        elev_ang_low_lim=pipe.elev_ang_low_lim, mask=mask, verbose=False,
        device=pipe.device)

    def on_device(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(pipe.device)

    s0, s1 = pipe.slice_in
    sl = (slice(s0.start - 1, s0.stop + 1), slice(s1.start - 1, s1.stop + 1))
    rot = transform.rotation_matrix_glob2loc(pipe.vec_north, pipe.vec_norm)
    vec_tilt = topo_param.slope_plane_meth(
        *(on_device(a[sl]) for a in (pipe.x, pipe.y, pipe.z)),
        rot_mat=on_device(rot), output_rot=True)[1:-1, 1:-1]
    svf = topo_param.sky_view_factor(azim, hori, vec_tilt)
    slope, aspect = topo_param.slope_angle_aspect(vec_tilt)
    return {"hori": hori, "azim": azim, "svf": svf, "slope": slope,
            "aspect": aspect, "vec_tilt": vec_tilt,
            "elevation": on_device(pipe.elevation[pipe.slice_in]),
            "lon": on_device(pipe.lon[s1]), "lat": on_device(pipe.lat[s0])}


#: name -> (ellipsoid, rows north to south, target spacing [m] or None)
PLANARIZE_MESHES = {"wgs84_north_down": ("WGS84", True, None),
                    "sphere_north_up": ("sphere", False, None),
                    "wgs84_spacing": ("WGS84", True, 150.0)}


def planarize_mesh(name, n0=150, n1=170, seed=0):
    """``(x, y, z, target_spacing)`` of :data:`PLANARIZE_MESHES`' mesh
    ``name``: an ``n0`` x ``n1`` lon/lat grid of 0.2 x 0.3 degree around
    (7.5, 46.5) with six seeded bumps of 300-2500 m, as float32 ENU
    coordinates (the vertex buffer's), whose lattice's corners lie outside
    the warped mesh."""
    from horayzon_tpu_torch import transform
    ellps, north_down, spacing = PLANARIZE_MESHES[name]
    rng = np.random.default_rng(seed)
    lat = 46.5 + np.linspace(-0.1, 0.1, n0)
    if north_down:
        lat = lat[::-1]
    lon = 7.5 + np.linspace(-0.15, 0.15, n1)
    lon2, lat2 = np.meshgrid(lon, lat)
    elevation = np.zeros_like(lon2)
    for _ in range(6):
        c_lon, c_lat = rng.uniform(7.35, 7.65), rng.uniform(46.4, 46.6)
        sig, amp = rng.uniform(0.01, 0.05), rng.uniform(300.0, 2500.0)
        elevation += amp * np.exp(-((lon2 - c_lon) ** 2 + (lat2 - c_lat) ** 2)
                                  / (2 * sig ** 2))
    trans = transform.TransformerEcef2enu(7.5, 46.5, ellps)
    x, y, z = transform.ecef2enu(*transform.lonlat2ecef(
        lon2, lat2, elevation.astype(np.float32), ellps), trans)
    return (x.astype(np.float32), y.astype(np.float32),
            z.astype(np.float32), spacing)


#: name -> (ellipsoid, rows north to south, (rows, columns) of the DEM);
#: ``srtm_alps`` has ``srtm_alps_hz``'s 972 x 1350 cells and inner block.
GEOMETRY_MESHES = {
    **{f"{e.lower()}_north_{'down' if d else 'up'}": (e, d, (48, 64))
       for e in ("WGS84", "GRS80", "sphere") for d in (True, False)},
    "srtm_alps": ("WGS84", True, (972, 1350))}


def geometry_mesh(name, seed=0):
    """``(lon, lat, elevation, slice_in, trans)`` of
    :data:`GEOMETRY_MESHES`' DEM ``name``: cell centres of 1/1200 degree of
    the SRTM tile at (5 E, 50 N) (the full-size one at ``srtm_alps_hz``'s
    crop, the small ones around (7.75, 46.5)), seeded uniform float32
    heights of -100 to 4000 m, ``CurvedPipeline``'s inner block (a fifth of
    each side in; the full-size one lon 7.70-8.30, lat 46.30-46.75) and its
    ENU frame at the inner domain's mean, which on the small DEMs lies on a
    cell centre, where the east and north components of the normals and
    norths cancel."""
    from horayzon_tpu_torch import transform
    ellps, north_down, (n0, n1) = GEOMETRY_MESHES[name]
    d = 1.0 / 1200.0
    if name == "srtm_alps":
        lon = 5.0 + d * (np.arange(2925, 4275) + 0.5)
        lat = 50.0 - d * (np.arange(3684, 4656) + 0.5)
        dom = {"lon_min": 7.70, "lon_max": 8.30, "lat_min": 46.30,
               "lat_max": 46.75}
    else:
        lon = 7.75 + d * (np.arange(n1) - n1 // 2 + 0.5)
        lat = 46.5 - d * (np.arange(n0) - n0 // 2 + 0.5)
        dom = {"lon_min": float(lon[n1 // 5]),
               "lon_max": float(lon[n1 - 1 - n1 // 5]),
               "lat_min": float(lat[n0 - 1 - n0 // 5]),
               "lat_max": float(lat[n0 // 5])}
    if not north_down:
        lat = lat[::-1].copy()
    rng = np.random.default_rng(seed)
    elevation = rng.uniform(-100.0, 4000.0, (n0, n1)).astype(np.float32)
    rows = (np.where(lat >= dom["lat_max"])[0],
            np.where(lat <= dom["lat_min"])[0])
    if north_down:
        r0, r1 = rows[0][-1], rows[1][0] + 1
    else:
        r0, r1 = rows[1][-1], rows[0][0] + 1
    slice_in = (slice(int(r0), int(r1)),
                slice(int(np.where(lon <= dom["lon_min"])[0][-1]),
                      int(np.where(lon >= dom["lon_max"])[0][0]) + 1))
    trans = transform.TransformerEcef2enu(
        float(np.mean([dom["lon_min"], dom["lon_max"]])),
        float(np.mean([dom["lat_min"], dom["lat_max"]])), ellps)
    return lon, lat, elevation, slice_in, trans


def exact_fma(a, b, c):
    """``a * b + c`` rounded once, elementwise on float64 arrays (exact
    rational arithmetic, for a few thousand values)."""
    from fractions import Fraction
    a, b, c = np.broadcast_arrays(*(np.asarray(v, dtype=np.float64)
                                    for v in (a, b, c)))
    return np.array([float(Fraction(x) * Fraction(y) + Fraction(z))
                     for x, y, z in zip(a.ravel().tolist(),
                                        b.ravel().tolist(),
                                        c.ravel().tolist())]).reshape(a.shape)


def geometry_model(lon, lat, elevation, slice_in, trans, cells=None):
    """The geometry kernel's arithmetic (csrc/geometry.cu) in NumPy from
    ``ops.geometry.axis_factors``: ``(x, y, z, v_norm, v_north, vec_norm,
    vec_north)``, the ENU mesh, the float32 ECEF normals and norths of the
    inner block (before the rotation) and both rotated into ENU as the
    kernel sums them (a fused multiply-add chain).  ``cells``, a pair of
    index arrays into the inner block, limits the rotated vectors to those
    cells ((k, 3) each)."""
    from horayzon_tpu_torch.ops import geometry
    f = geometry.axis_factors(lon, lat, trans)
    h = np.asarray(elevation, dtype=np.float32)
    if f.sphere:
        nh = zh = (h + np.float32(f.n[0])).astype(np.float64)
    else:
        nh = f.n[:, None] + h.astype(np.float64)
        zh = f.zf[:, None] + h.astype(np.float64)
    ce = nh * f.cos_lat[:, None]
    xe, ye, ze = ce * f.cos_lon, ce * f.sin_lon, zh * f.sin_lat[:, None]
    dx, dy, dz = xe - f.origin[0], ye - f.origin[1], ze - f.origin[2]
    r = f.rot
    x = (r[0, 0] * dx + r[0, 1] * dy).astype(np.float32)
    y = ((r[1, 0] * dx + r[1, 1] * dy) + r[1, 2] * dz).astype(np.float32)
    z = ((r[2, 0] * dx + r[2, 1] * dy) + r[2, 2] * dz).astype(np.float32)
    rs, cs = slice_in
    cl = f.cos_lat[rs, None]
    v_norm = np.stack(np.broadcast_arrays(
        cl * f.cos_lon[cs], cl * f.sin_lon[cs], f.sin_lat[rs, None]),
        axis=-1).astype(np.float32)
    v = v_norm.astype(np.float64)
    q = np.stack([-xe[slice_in], -ye[slice_in], f.b - ze[slice_in]], -1)
    dot = (q[..., 0] * v[..., 0] + q[..., 1] * v[..., 1]) \
        + q[..., 2] * v[..., 2]
    t = q - dot[..., None] * v
    norm = np.sqrt((t[..., 0] * t[..., 0] + t[..., 1] * t[..., 1])
                   + t[..., 2] * t[..., 2])
    v_north = (t / norm[..., None]).astype(np.float32)

    def rotate(vec):
        vec = vec.astype(np.float64)
        if cells is not None:
            vec = vec[cells]
        return np.stack(
            [exact_fma(vec[..., 2], r[k, 2],
                       exact_fma(vec[..., 1], r[k, 1], vec[..., 0] * r[k, 0]))
             for k in range(3)], axis=-1).astype(np.float32)

    return x, y, z, v_norm, v_north, rotate(v_norm), rotate(v_north)


def within_rotation_rounding(got, want):
    """Whether float32 ENU vectors ``got`` and ``want`` differ by at most
    what summing ``ecef2enu_vector``'s three products in another order can
    give: one float32 ulp of the value, plus the float64 rounding of the
    sum (below 2^-49 for unit vectors) where the terms cancel."""
    gap = np.abs(got.astype(np.float64) - want.astype(np.float64))
    return bool((gap <= np.spacing(np.abs(want)).astype(np.float64)
                 + 2.0 ** -49).all())


#: The TINs of the far-field scenes (:func:`tin_far_field_scene`).
TIN_KINDS = ("regular", "irregular")


def tin_far_field_scene(kind, ratio_log2, fine_shape=(37, 45), dx=10.0,
                        dist_search=300.0, seed=0):
    """A fine grid, its ``GridSpec`` and a far-field TIN over the coarse
    lattice of ``multires.coarse_grid_from_tin`` at ``ratio_log2``, for
    tests/test_torch_tin_raster.py and the card's.  ``kind`` "regular":
    two triangles a quad at 1.7 coarse cells, over the lattice plus half
    its extent on each side, so triangles lie in it, across its edges and
    wholly outside, but for a hole over its north-west corner, which only
    the pad value fills.  "irregular": the same vertices each moved by up to
    0.45 of the spacing, plus slivers, triangles with a repeated vertex
    and with three collinear ones (``|d| < 1e-12``), three triangles
    larger than the lattice, a vertex below the pad value, and unused
    vertices (one not finite) that nothing may scatter.  Returns
    ``(vert_simp, tri_ind_simp, grid, z_fine)``: flat float32 (x, y, z),
    flat int32, the fine grid's ``GridSpec`` (LV95-like coordinates, dy
    negative) and its (H, W) float32 heights."""
    from horayzon_tpu_torch.terrain import GridSpec
    rng = np.random.default_rng(seed + 31 * ratio_log2)
    hf, wf = fine_shape
    grid = GridSpec(x0=2600001.0, y0=1200000.0 - 1.0, dx=dx, dy=-dx,
                    shape=fine_shape)
    z_fine = rng.uniform(0.0, 2500.0, fine_shape).astype(np.float32)
    r = 2 ** ratio_log2
    pad_c = int(math.ceil(dist_search / (dx * r))) + 2
    ext_x = ((wf + r - 1) // r + 2 * pad_c) * r * dx
    ext_y = ((hf + r - 1) // r + 2 * pad_c) * r * dx
    x_lo = grid.x0 - pad_c * r * dx - 0.5 * ext_x
    y_hi = grid.y0 + pad_c * r * dx + 0.5 * ext_y
    step = 1.7 * r * dx
    nx = int(math.ceil(2.0 * ext_x / step)) + 1
    ny = int(math.ceil(2.0 * ext_y / step)) + 1
    xv, yv = np.meshgrid(x_lo + step * np.arange(nx),
                         y_hi - step * np.arange(ny))
    if kind == "irregular":
        xv = xv + rng.uniform(-0.45, 0.45, xv.shape) * step
        yv = yv + rng.uniform(-0.45, 0.45, yv.shape) * step
    zv = rng.uniform(-200.0, 3000.0, xv.shape)
    verts = [np.stack([xv, yv, zv], -1).reshape(-1, 3)]
    jj, ii = np.meshgrid(np.arange(nx - 1), np.arange(ny - 1))
    # no quads over the lattice's north-west corner
    hole = (jj < 0.4 * (nx - 1)) & (ii < 0.4 * (ny - 1))
    a = (ii * nx + jj)[~hole]
    tris = [np.stack([a, a + 1, a + nx], -1),
            np.stack([a + 1, a + nx + 1, a + nx], -1)]
    if kind == "irregular":
        n = nx * ny
        cx, cy = grid.x0 + 0.5 * wf * dx, grid.y0 - 0.5 * hf * dx
        span = max(ext_x, ext_y)
        extra = np.array([
            # slivers across the fine grid
            [cx - 0.4 * span, cy, 2900.0], [cx + 0.4 * span, cy + 1e-3,
                                            2950.0],
            [cx, cy + 3.0 * dx, 3100.0],
            [cx - 0.3 * span, cy - 0.2 * span, 2800.0],
            [cx + 0.3 * span, cy + 0.2 * span, 3300.0],
            # three collinear vertices
            [cx - 5 * dx, cy - 5 * dx, 5000.0], [cx, cy, 5000.0],
            [cx + 5 * dx, cy + 5 * dx, 5000.0],
            # larger than the lattice, sloping from low to high
            [cx - 2 * span, cy - 2 * span, -500.0],
            [cx + 2 * span, cy - 2 * span, 100.0],
            [cx, cy + 2 * span, 4500.0],
            [cx - 3 * span, cy + 3 * span, -900.0],
            # below the pad value
            [cx + 0.25 * span, cy - 0.25 * span, -4.0e4],
            # unused
            [cx, cy, 9.0e3], [np.nan, cy, 9.0e3]])
        tris += [np.array([[n, n + 1, n + 2], [n + 3, n + 4, n + 2],
                           [n + 5, n + 6, n + 7], [n + 6, n + 6, n + 1],
                           [n + 8, n + 9, n + 10], [n + 11, n + 10, n + 9],
                           [n + 8, n + 10, n + 11],
                           [n + 12, n + 4, n + 3]])]
        verts.append(extra)
        order = rng.permutation(sum(len(t) for t in tris))
        tris = [np.concatenate(tris)[order]]
    return (np.concatenate(verts).astype(np.float32).ravel(),
            np.concatenate(tris).astype(np.int32).ravel(), grid, z_fine)


def _lv95_bumps(rng, lo, hi, count, sig, amp):
    """``count`` gaussian bumps over the square [lo, hi]^2 [m]: (centre x,
    centre y, sigma, amplitude) each."""
    return (rng.uniform(lo[0], hi[0], count), rng.uniform(lo[1], hi[1], count),
            rng.uniform(*sig, count), rng.uniform(*amp, count))


def _bump_heights(bumps, x, y):
    z = np.zeros(np.broadcast(x, y).shape)
    for cx, cy, s, a in zip(*bumps):
        z += a * np.exp(-((x - cx) ** 2 + (y - cy) ** 2) / (2.0 * s * s))
    return z


def regular_tin(x_lo, y_hi, step, n, heights):
    """A regular TIN of ``n`` x ``n`` vertices every ``step`` [m] east and
    south of (``x_lo``, ``y_hi``), two triangles a quad, its heights from
    ``heights(x, y)``: flat float32 (x, y, z) and flat int32 indices."""
    s = step * np.arange(n)
    xv, yv = np.meshgrid(x_lo + s, y_hi - s)
    verts = np.stack([xv, yv, heights(xv, yv)], -1).astype(np.float32)
    jj, ii = np.meshgrid(np.arange(n - 1), np.arange(n - 1))
    a = (ii * n + jj).ravel()
    tris = np.concatenate([np.stack([a, a + 1, a + n], -1),
                           np.stack([a + 1, a + n + 1, a + n], -1)])
    return verts.ravel(), tris.astype(np.int32).ravel()


def tin_cell_scene(seed=0):
    """The far field's shapes of the benchmark's 2 m multires cell
    (``hzbench/scene/swissalti_2m_like.py`` at its configuration), made
    here: a 5120^2 fine grid at 2 m whose south-west corner lies at LV95
    (2669000, 1241000), cell centres at odd metres, y descending; a
    regular TIN every 256 m over it plus 20 km (198^2 vertices, 77,618
    triangles) through 30 bumps; the fine grid the same bumps on 32 m
    blocks plus 3 m of noise.  Returns ``(vert_simp, tri_ind_simp, grid,
    z_fine, offset, inner_shape, dist_search)``, the inner block 1024^2
    at (2048, 2048), ``dist_search`` in metres."""
    from horayzon_tpu_torch.terrain import GridSpec
    rng = np.random.default_rng(seed)
    n, dx, margin = 5120, 2.0, 20000.0
    x0, y0 = 2669000.0, 1241000.0
    y_top = y0 + n * dx
    bumps = _lv95_bumps(rng, (x0 - margin, y0 - margin),
                        (x0 + n * dx + margin, y_top + margin), 30,
                        (320.0, 8000.0), (200.0, 2000.0))
    c = x0 + 16.0 + 32.0 * np.arange(n // 16)
    window = _bump_heights(bumps, c[None, :],
                           (y_top - 16.0 - 32.0 * np.arange(n // 16))[:, None])
    z_fine = np.repeat(np.repeat(window.astype(np.float32), 16, 0), 16, 1)
    z_fine += 3.0 * rng.standard_normal(z_fine.shape, dtype=np.float32)
    nv = int(math.ceil((n * dx + 2.0 * margin) / 256.0)) + 1
    verts, tris = regular_tin(x0 - margin, y_top + margin, 256.0, nv,
                              lambda x, y: _bump_heights(bumps, x, y))
    grid = GridSpec(x0=x0 + 1.0, y0=y_top - 1.0, dx=dx, dy=-dx,
                    shape=(n, n))
    return verts, tris, grid, z_fine, (2048, 2048), (1024, 1024), 20000.0


def tin_pipeline_scene(seed=11):
    """A small ``PlanarPipeline`` scene with a far-field TIN, at the sizes
    of tests/test_torch_tin_pipeline.py: 64^2 inner cells at 2 m in a
    576^2 fine grid (a 256-cell halo), the TIN every 384 m over the fine
    grid plus 2 km (15^2 vertices, 392 triangles), both through 4 bumps,
    the fine grid with 3 m of noise.  Returns a dict of ``x``, ``y``
    (float32 axes), ``z``, ``domain``, ``vert_simp``, ``tri_ind_simp``."""
    rng = np.random.default_rng(seed)
    n, dx, margin = 576, 2.0, 2000.0
    x0, y0 = 2669000.0, 1241000.0
    y_top = y0 + n * dx
    bumps = _lv95_bumps(rng, (x0 - margin, y0 - margin),
                        (x0 + n * dx + margin, y_top + margin), 4,
                        (150.0, 900.0), (100.0, 600.0))
    k = np.arange(n, dtype=np.float64)
    x = (x0 + (k + 0.5) * dx).astype(np.float32)
    y = (y_top - (k + 0.5) * dx).astype(np.float32)
    z = (_bump_heights(bumps, x.astype(np.float64)[None, :],
                       y.astype(np.float64)[:, None])
         + 3.0 * rng.standard_normal((n, n))).astype(np.float32)
    nv = int(math.ceil((n * dx + 2.0 * margin) / 384.0)) + 1
    verts, tris = regular_tin(x0 - margin, y_top + margin, 384.0, nv,
                              lambda xx, yy: _bump_heights(bumps, xx, yy))
    halo = 256
    domain = {"x_min": float(x[halo]), "x_max": float(x[n - halo - 1]),
              "y_min": float(y[n - halo - 1]), "y_max": float(y[halo])}
    return dict(x=x, y=y, z=z, domain=domain, vert_simp=verts,
                tri_ind_simp=tris)
