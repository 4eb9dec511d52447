"""The port's copies of the reference's pure-NumPy helpers equal the
originals: the sweep schedule, the vertex buffer, the grid detection, the
coordinate transformations, the solar ephemeris, the ellipsoid directions,
the curved mesh's planarisation and the multires host helpers (the TIN
rasteriser, the coarse grid from a TIN, the fine-halo check).

The copies exist because importing ``horayzon_tpu`` loads JAX, which the
port never does.  Equality here is exact (same NumPy code, same inputs).
"""

import dataclasses

import numpy as np
import pytest

from horayzon_tpu import auxiliary as aux_ref
from horayzon_tpu import direction as direction_ref
from horayzon_tpu import regrid as regrid_ref
from horayzon_tpu import sun_position as sun_ref
from horayzon_tpu import terrain as terrain_ref
from horayzon_tpu import transform as transform_ref
from horayzon_tpu.ops import multires as multires_ref
from horayzon_tpu.ops import sweep as sweep_ref
from horayzon_tpu_torch import (auxiliary, direction, regrid, sun_position,
                                terrain, transform)
from horayzon_tpu_torch.ops import multires, sweep


def _same_schedule(a, b):
    assert [dataclasses.astuple(p) for p in a.phases] == \
        [dataclasses.astuple(p) for p in b.phases]
    assert len(a.s_values) == len(b.s_values)
    for sa, sb in zip(a.s_values, b.s_values):
        assert sa.dtype == sb.dtype
        np.testing.assert_array_equal(sa, sb)
    assert (a.step, a.dist, a.pads, a.num_samples, a.meta()) == \
        (b.step, b.dist, b.pads, b.num_samples, b.meta())


@pytest.mark.parametrize("step,dist,hori_acc,max_level", [
    (25.0, 20000.0, 0.25, 10),
    (25.0, 800.0, 0.25, 10),
    (25.0, 6000.0, 1.0, 10),
    (2.0, 15000.0, 0.1, 4),
    (90.0, 250000.0, 0.5, 3),
    (30.0, 31.0, 5.0, 1),
])
def test_schedule_matches_reference(step, dist, hori_acc, max_level):
    rel_err = sweep.default_rel_err(hori_acc)
    assert rel_err == sweep_ref.default_rel_err(hori_acc)
    got = sweep.build_schedule(step, dist, rel_err, max_level=max_level)
    ref = sweep_ref.build_schedule(step, dist, rel_err, max_level=max_level)
    _same_schedule(got, ref)
    for halo in (0, 5, 17, 40, 400):
        _same_schedule(sweep.mark_safe_phases(got, halo),
                       sweep_ref.mark_safe_phases(ref, halo))


def test_schedule_rejects_nonpositive_distance():
    for mod in (sweep, sweep_ref):
        with pytest.raises(ValueError, match="dist_search must be positive"):
            mod.build_schedule(25.0, 0.0, 0.01)


def test_vertex_buffer_matches_reference():
    rng = np.random.default_rng(0)
    for shape in [(5, 7), (4, 4), (3, 1)]:
        x, y, z = (rng.standard_normal(shape).astype(np.float32)
                   for _ in range(3))
        np.testing.assert_array_equal(auxiliary.rearrange_pad_buffer(x, y, z),
                                      aux_ref.rearrange_pad_buffer(x, y, z))
        buf = rng.standard_normal(int(np.prod(shape))).astype(np.float32)
        np.testing.assert_array_equal(auxiliary.pad_buffer(buf),
                                      aux_ref.pad_buffer(buf))
    bad = np.zeros((3, 3), np.float64)
    for mod in (auxiliary, aux_ref):
        with pytest.raises(TypeError):
            mod.rearrange_pad_buffer(bad, bad, bad)


def test_grid_helpers_match_reference():
    n0, n1 = 6, 9
    x1 = np.arange(n1, dtype=np.float32) * 25.0 + 100.0
    y1 = (n0 - 1 - np.arange(n0, dtype=np.float32)) * 30.0
    x, y = np.meshgrid(x1, y1)
    z = np.random.default_rng(1).uniform(0, 50, x.shape).astype(np.float32)
    buf = auxiliary.rearrange_pad_buffer(x, y, z)
    for a, b in zip(terrain.decompose_vert_grid(buf, n0, n1),
                    terrain_ref.decompose_vert_grid(buf, n0, n1)):
        np.testing.assert_array_equal(a, b)
    got = terrain.detect_regular_grid(x, y)
    ref = terrain_ref.detect_regular_grid(x, y)
    assert dataclasses.astuple(got) == dataclasses.astuple(ref)
    assert got.crop((1, 2), (3, 4)) == terrain.GridSpec(
        *dataclasses.astuple(ref.crop((1, 2), (3, 4))))
    np.testing.assert_array_equal(got.x_axis(), ref.x_axis())
    xc = x.copy()
    xc[2, 3] += 5.0                      # irregular: not a grid
    assert terrain.detect_regular_grid(xc, y) is None
    assert terrain_ref.detect_regular_grid(xc, y) is None
    vn = np.zeros((3, 4, 3), np.float32)
    vn[..., 2] = 1.0
    vno = np.zeros((3, 4, 3), np.float32)
    vno[..., 1] = 1.0
    for tilt in (0.0, 1e-3):
        vt = vn.copy()
        vt[0, 0, 0] = tilt
        assert terrain.is_default_planar_vectors(vt, vno) == \
            terrain_ref.is_default_planar_vectors(vt, vno)


def _same(a, b):
    """Equal outputs: arrays (or tuples of arrays) equal bit for bit."""
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def test_transform_matches_reference():
    rng = np.random.default_rng(2)
    lon = rng.uniform(-180.0, 180.0, (4, 5))
    lat = rng.uniform(-89.0, 89.0, (4, 5))
    h = rng.uniform(-100.0, 4000.0, (4, 5)).astype(np.float32)
    for ellps in ("sphere", "GRS80", "WGS84"):
        _same(transform.ellipsoid_params(ellps),
              transform_ref.ellipsoid_params(ellps))
        ecef = transform.lonlat2ecef(lon, lat, h, ellps)
        _same(ecef, transform_ref.lonlat2ecef(lon, lat, h, ellps))
        trans = transform.TransformerEcef2enu(7.5, 46.5, ellps)
        trans_ref = transform_ref.TransformerEcef2enu(7.5, 46.5, ellps)
        assert vars(trans) == vars(trans_ref)
        enu = transform.ecef2enu(*ecef, trans)
        _same(enu, transform_ref.ecef2enu(*ecef, trans_ref))
        # round trip ENU -> ECEF -> ENU, as tests/test_transform.py checks
        back = transform.enu2ecef(*enu, trans)
        _same(back, transform_ref.enu2ecef(*enu, trans_ref))
        np.testing.assert_allclose(transform.ecef2enu(*back, trans), enu,
                                   atol=0.05)
        vec = rng.standard_normal((4, 5, 3))
        _same(transform.ecef2enu_vector(vec, trans),
              transform_ref.ecef2enu_vector(vec, trans_ref))
    with pytest.raises(ValueError, match="ellps"):
        transform.lonlat2ecef(lon, lat, h, "mars")
    with pytest.raises(ValueError, match="lon_or"):
        transform.TransformerEcef2enu(190.0, 0.0, "WGS84")
    lon_ch, lat_ch = np.array([7.4, 8.5]), np.array([46.9, 47.3])
    h_ch = np.array([500.0, 800.0])
    e, n, hh = transform.wgs2swiss(lon_ch, lat_ch, h_ch)
    _same((e, n, hh), transform_ref.wgs2swiss(lon_ch, lat_ch, h_ch))
    _same(transform.swiss2wgs(e, n, hh), transform_ref.swiss2wgs(e, n, hh))
    north = rng.standard_normal((3, 4, 3))
    norm = rng.standard_normal((3, 4, 3))
    north /= np.linalg.norm(north, axis=-1, keepdims=True)
    norm /= np.linalg.norm(norm, axis=-1, keepdims=True)
    _same(transform.rotation_matrix_glob2loc(north, norm),
          transform_ref.rotation_matrix_glob2loc(north, norm))


def test_sun_position_matches_reference():
    times = ["2026-03-20T12:07:00", "2026-06-21T05:30:00",
             "2026-12-21T18:00:00"]
    _same(sun_position.julian_day(times), sun_ref.julian_day(times))
    _same(sun_position.sun_ra_dec(times), sun_ref.sun_ra_dec(times))
    _same(sun_position.sun_position_ecef(times),
          sun_ref.sun_position_ecef(times))
    _same(sun_position.sun_azimuth_elevation(times, lon=7.5, lat=46.5),
          sun_ref.sun_azimuth_elevation(times, lon=7.5, lat=46.5))
    trans = transform.TransformerEcef2enu(7.5, 46.5, "WGS84")
    trans_ref = transform_ref.TransformerEcef2enu(7.5, 46.5, "WGS84")
    _same(sun_position.sun_position_enu(times, trans),
          sun_ref.sun_position_enu(times, trans_ref))
    azim = np.linspace(0.0, 360.0, 7)
    for elev in (30.0, -5.0, np.linspace(-10.0, 80.0, 7)):
        _same(sun_position.sun_position_planar(azim, elev, dist=1.0e7),
              sun_ref.sun_position_planar(azim, elev, dist=1.0e7))


def test_direction_matches_reference():
    rng = np.random.default_rng(4)
    lon = rng.uniform(-180.0, 180.0, (5, 6))
    lat = rng.uniform(-85.0, 85.0, (5, 6))
    h = rng.uniform(-100.0, 4000.0, (5, 6)).astype(np.float32)
    vn = direction.surf_norm(lon, lat)
    _same(vn, direction_ref.surf_norm(lon, lat))
    for ellps in ("sphere", "GRS80", "WGS84"):
        ecef = transform.lonlat2ecef(lon, lat, h, ellps)
        _same(direction.north_dir(*ecef, vn, ellps),
              direction_ref.north_dir(*ecef, vn, ellps))
    for mod in (direction, direction_ref):
        with pytest.raises(ValueError, match="Inconsistent"):
            mod.surf_norm(lon, lat[:-1])
        with pytest.raises(ValueError, match="ellps"):
            mod.north_dir(*transform.lonlat2ecef(lon, lat, h, "sphere"), vn,
                          "mars")


def test_regrid_matches_reference():
    """``planarize`` (and with it ``invert_mapping`` and ``_bilinear``) on
    a curved ENU mesh, and the grid's helper methods."""
    n, dlat = 40, 0.002
    lat = 45.0 + (np.arange(n)[::-1] - n / 2) * dlat
    lon = 7.0 + (np.arange(n) - n / 2) * dlat
    lon2, lat2 = np.meshgrid(lon, lat)
    elev = (300.0 * np.exp(-((lon2 - 7.0) ** 2 + (lat2 - 45.0) ** 2)
                           / (2 * 0.01 ** 2))).astype(np.float32)
    trans = transform.TransformerEcef2enu(7.0, 45.0, "WGS84")
    x, y, z = transform.ecef2enu(
        *transform.lonlat2ecef(lon2, lat2, elev, "WGS84"), trans)
    got, ref = regrid.planarize(x, y, z), regrid_ref.planarize(x, y, z)
    assert dataclasses.astuple(got.grid) == dataclasses.astuple(ref.grid)
    for key in ("z", "valid", "fi", "fj"):
        _same(getattr(got, key), getattr(ref, key))
    _same(got.sample_source_field(lon2), ref.sample_source_field(lon2))
    _same(got.to_regular_indices(x[3:9, 4:7], y[3:9, 4:7]),
          ref.to_regular_indices(x[3:9, 4:7], y[3:9, 4:7]))
    _same(regrid.planarize(x, y, z, target_spacing=250.0).z,
          regrid_ref.planarize(x, y, z, target_spacing=250.0).z)
    rng = np.random.default_rng(5)
    a = rng.normal(size=(6, 7, 3))
    fi, fj = rng.uniform(-1, 6, (4, 5)), rng.uniform(-1, 7, (4, 5))
    _same(regrid._bilinear(a, fi, fj), regrid_ref._bilinear(a, fi, fj))
    _same(regrid.invert_mapping(x, y, x[::7, ::5], y[::7, ::5]),
          regrid_ref.invert_mapping(x, y, x[::7, ::5], y[::7, ::5]))
    for mod in (regrid, regrid_ref):
        with pytest.raises(ValueError, match="Inconsistent"):
            mod.planarize(x, y, z[:-1])


def _plane_tin():
    """tests/test_multires.py:85-101: two triangles over [0, 100] x
    [-100, 0] of a sloping plane."""
    verts = np.array([[0.0, 0.0, 10.0], [100.0, 0.0, 20.0],
                      [0.0, -100.0, 30.0], [100.0, -100.0, 40.0]],
                     dtype=np.float32).ravel()
    return verts, np.array([0, 1, 2, 1, 3, 2], dtype=np.int32)


@pytest.mark.parametrize("origin,shape", [((0.0, 0.0), (5, 5)),
                                          ((-50.0, 0.0), (2, 2)),
                                          ((12.5, -6.25), (7, 4))])
def test_rasterize_tin_matches_reference(origin, shape):
    verts, tris = _plane_tin()
    kw = dict(origin_xy=origin, spacing_xy=(25.0, -25.0), shape=shape)
    got = multires.rasterize_tin(verts, tris, **kw)
    want = multires_ref.rasterize_tin(verts, tris, **kw)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    if origin == (0.0, 0.0):
        xj = np.arange(5) * 25.0
        yi = np.arange(5) * -25.0
        np.testing.assert_allclose(
            got, 10.0 + 0.1 * xj[None, :] - 0.2 * yi[:, None], atol=1e-4)
    if origin == (-50.0, 0.0):
        assert (got[:, 0] < -1e4).all()     # outside all triangles


@pytest.mark.parametrize("ratio_log2,fine_shape", [(2, (40, 40)),
                                                   (1, (37, 45)),
                                                   (3, (64, 48))])
def test_coarse_grid_from_tin_matches_reference(ratio_log2, fine_shape):
    """A bumpy TIN over a fine grid with an odd shape: the rasterised,
    vertex-scattered and fine-overlaid coarse grid and its offset."""
    rng = np.random.default_rng(5)
    r = 2 ** ratio_log2
    dx, dy, dist = 25.0, -25.0, 600.0
    n = 14
    xs = np.linspace(-700.0, 1900.0, n)
    ys = np.linspace(700.0, -1900.0, n)
    xv, yv = np.meshgrid(xs, ys)
    zv = 300.0 * np.sin(xv / 400.0) * np.cos(yv / 500.0) + 20.0 * rng.normal(
        size=xv.shape)
    verts = np.stack([xv, yv, zv], -1).reshape(-1, 3).astype(np.float32)
    jj, ii = np.meshgrid(np.arange(n - 1), np.arange(n - 1))
    a = (ii * n + jj).ravel()
    tris = np.concatenate([np.stack([a, a + 1, a + n], -1),
                           np.stack([a + 1, a + n + 1, a + n], -1)]).astype(
                               np.int32).ravel()
    z_fine = (100.0 * rng.normal(size=fine_shape)).astype(np.float32)
    kw = dict(fine_shape=fine_shape, z_fine=z_fine, ratio_log2=ratio_log2,
              dist_search=dist)
    got, got_off = multires.coarse_grid_from_tin(
        verts.ravel(), tris, grid=terrain.GridSpec(
            x0=0.0, y0=0.0, dx=dx, dy=dy, shape=fine_shape), **kw)
    want, want_off = multires_ref.coarse_grid_from_tin(
        verts.ravel(), tris, grid=terrain_ref.GridSpec(
            x0=0.0, y0=0.0, dx=dx, dy=dy, shape=fine_shape), **kw)
    assert tuple(got_off) == tuple(want_off)
    assert got_off[0] % r == 0 and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert (got > -1e4).any()


@pytest.mark.parametrize("ratio_log2,offset,ok", [(2, (31, 31), False),
                                                  (1, (31, 33), True),
                                                  (4, (240, 250), True),
                                                  (5, (240, 250), False)])
def test_validate_fine_halo_matches_reference(ratio_log2, offset, ok):
    sched = sweep.build_schedule(25.0, 20000.0, sweep.default_rel_err(2.0))
    sched_ref = sweep_ref.build_schedule(25.0, 20000.0,
                                         sweep_ref.default_rel_err(2.0))
    inner = (8, 8)
    fine = (2 * offset[0] + 8, 2 * offset[1] + 8)
    args = (ratio_log2, 25.0, offset, inner, fine)
    if ok:
        assert multires.validate_fine_halo(sched, *args) == \
            multires_ref._validate_fine_halo(sched_ref, *args) == min(offset)
        return
    with pytest.raises(ValueError, match="halo") as e_ref:
        multires_ref._validate_fine_halo(sched_ref, *args)
    with pytest.raises(ValueError, match="halo") as e_got:
        multires.validate_fine_halo(sched, *args)
    assert str(e_got.value) == str(e_ref.value)


@pytest.mark.parametrize("dist,acc,halo,unroll,dxdy,tilted", [
    (2500.0, 0.25, 32, 8, (25.0, -25.0), False),
    (3000.0, 2.0, 24, 8, (25.0, -30.0), True),
    (825.0, 0.25, 12, 1, (24.7, -24.7), False),
])
def test_shift_tables_match_reference(dist, acc, halo, unroll, dxdy,
                                      tilted):
    """The XLA engine's per-(azimuth, sample) shift tables, padded and
    folded by ``unroll``, with the d1 pairing flags."""
    dx, dy = dxdy
    step = min(abs(dx), abs(dy))
    rel_err = sweep.default_rel_err(acc)
    sched = sweep.mark_safe_phases(sweep.build_schedule(step, dist, rel_err),
                                   halo)
    sched_ref = sweep_ref.mark_safe_phases(
        sweep_ref.build_schedule(step, dist, rel_err), halo)
    azim = ((2.0 * np.pi) / 7 * np.arange(7)).astype(np.float32)
    u_xy = None
    if tilted:
        u_xy = np.stack([np.sin(azim + 0.05), np.cos(azim) * 0.99], -1)
        u_xy /= np.linalg.norm(u_xy, axis=-1, keepdims=True)
    got = sweep.horizon_shift_tables(sched, azim, dx, dy, (halo, halo + 3),
                                     u_xy=u_xy, unroll=unroll)
    ref = sweep_ref.horizon_shift_tables(sched_ref, azim, dx, dy,
                                         (halo, halo + 3), u_xy=u_xy,
                                         unroll=unroll)
    assert len(got) == len(ref) == len(sched.phases)
    for g, r in zip(got, ref):
        assert sorted(g) == sorted(r)
        for k in r:
            assert g[k].dtype == r[k].dtype, k
            np.testing.assert_array_equal(g[k], r[k])
    for s_g, s_r in zip(sweep.shadow_s_phases(sched, unroll),
                        sched_ref.s_values):
        np.testing.assert_array_equal(
            s_g, sweep_ref._pad_unroll(s_r[None, :], unroll)[0].ravel())


def test_basis_fields_and_marching_directions_match_reference():
    rng = np.random.default_rng(3)
    norm = rng.normal(size=(9, 11, 3)) * 0.05
    norm[..., 2] = 1.0
    norm /= np.linalg.norm(norm, axis=-1, keepdims=True)
    north = np.zeros_like(norm)
    north[..., 1] = 1.0
    north -= np.sum(north * norm, axis=-1, keepdims=True) * norm
    north /= np.linalg.norm(north, axis=-1, keepdims=True)
    n32, e32 = norm.astype(np.float32), north.astype(np.float32)
    got = terrain.basis_fields(n32, e32)
    ref = terrain_ref.basis_fields(n32, e32)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], ref[k])
    azim = np.linspace(0.0, 2.0 * np.pi, 13)[:-1]
    np.testing.assert_array_equal(
        terrain.mean_marching_directions(azim, n32, e32),
        terrain_ref.mean_marching_directions(azim, n32, e32))
