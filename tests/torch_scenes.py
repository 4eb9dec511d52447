"""Scenes of the sweep's skips, shared by the CPU tests
(tests/test_torch_sweep_skips.py for K1, tests/test_torch_shadow_skips.py
for K2) and the card's (tests/test_torch_cuda.py), the curved meshes of
the curved shadow and locations tests, a NumPy transcription of the
refraction's float32 arithmetic, the sharded scenes of
tests/test_torch_sharding.py and the card's, and the streaming runners'
scenes of tests/test_torch_utils.py and the card's.  Imports no JAX."""

import math

import numpy as np

from horayzon_tpu_torch import auxiliary
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
