"""The port's copies of the reference's host-side modules equal the
originals: ``auxiliary.get_path_aux_data``, ``download``, ``domain``,
``geoid``, ``load_dem``, ``ocean_masking`` and ``native/`` (the C++
sources and their ctypes bindings); ``utils/output`` is held in
``tests/test_torch_utils.py``.

Each copy is the original with its imports pointed at the port: its
syntax tree, docstrings and the package name aside, is the original's,
and its C++ sources are byte-equal.  Where a call needs no network and no
build of the reference's own native library (``tests/test_native.py`` and
``tests/test_load_dem.py`` build that one), copy and original give equal
outputs on the same inputs.  The reference's synthetic cases of
``tests/test_load_dem.py``, ``test_geoid.py``, ``test_ocean_masking.py``
and ``test_native.py`` run on the copies; ``test_bvh_baseline_matches_
sweep`` is held against the port's ``ops.sweep.horizon_sweep``.

Every test that builds the port's native library
(``horayzon_tpu_torch/native/_fastdem.so``, ``_bvhbase.so``, with g++)
lives in this file, so that two test workers never build it at once.
No test calls ``download``: there is no network.

CPU cost: about 15 s on one core, most of it the two g++ builds and the
BVH baseline.
"""

import ast
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from horayzon_tpu import auxiliary as aux_ref
from horayzon_tpu import domain as domain_ref
from horayzon_tpu import geoid as geoid_ref
from horayzon_tpu import load_dem as load_dem_ref
from horayzon_tpu import ocean_masking as ocean_ref
from horayzon_tpu import transform as transform_ref
from horayzon_tpu_torch import (auxiliary, domain, download, geoid,
                                load_dem, ocean_masking, transform)
from horayzon_tpu_torch.ops import mip, sweep

from reference_impl import brute_horizon, brute_shadow, \
    gaussian_bumps_terrain

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COPIES = ["download.py", "domain.py", "geoid.py", "load_dem.py",
          "ocean_masking.py", "native/__init__.py", "native/buildlib.py",
          "native/fastdem.py", "native/bvhbase.py", "utils/output.py"]


def _tree(path, package):
    """The module's syntax tree without docstrings, ``package`` renamed to
    ``horayzon_tpu``."""
    with open(path) as f:
        tree = ast.parse(f.read().replace(package, "horayzon_tpu"))
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body
                and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            body.pop(0)
    return ast.dump(tree)


@pytest.mark.parametrize("name", COPIES)
def test_copy_is_the_original(name):
    assert (_tree(os.path.join(_REPO, "horayzon_tpu_torch", name),
                  "horayzon_tpu_torch")
            == _tree(os.path.join(_REPO, "horayzon_tpu", name),
                     "horayzon_tpu"))


@pytest.mark.parametrize("name", ["fastdem.cpp", "bvhbase.cpp"])
def test_native_sources_are_the_originals(name):
    with open(os.path.join(_REPO, "horayzon_tpu_torch", "native", name),
              "rb") as a, open(os.path.join(_REPO, "horayzon_tpu", "native",
                                            name), "rb") as b:
        assert a.read() == b.read()


def test_get_path_aux_data_matches_reference(tmp_path, monkeypatch):
    monkeypatch.setenv("HORAYZON_TPU_AUX_DATA", str(tmp_path / "aux"))
    assert auxiliary.get_path_aux_data() == aux_ref.get_path_aux_data() \
        == os.path.join(str(tmp_path / "aux"), "")
    monkeypatch.delenv("HORAYZON_TPU_AUX_DATA")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    got = auxiliary.get_path_aux_data()
    assert got == aux_ref.get_path_aux_data()
    assert got == os.path.join(str(tmp_path / "home"), ".cache",
                               "horayzon_tpu", "")
    assert os.path.isdir(got)


def test_download_rejects_a_bad_mode_without_a_request(tmp_path):
    with pytest.raises(ValueError, match="invalid value for 'mode'"):
        download.files(["http://localhost/x"], str(tmp_path), mode="nope")


@pytest.mark.parametrize("ellps", ["sphere", "GRS80", "WGS84"])
def test_domain_matches_reference(ellps):
    planar = {"x_min": 668000.0, "x_max": 707000.0,
              "y_min": 172000.0, "y_max": 200000.0}
    assert domain.planar_grid(planar, 20.0) == \
        domain_ref.planar_grid(planar, 20.0)
    for dom, dist in [({"lon_min": 7.7, "lon_max": 8.3, "lat_min": 46.3,
                        "lat_max": 46.75}, 20.0),
                      ({"lon_min": -36.95, "lon_max": -35.65,
                        "lat_min": -54.75, "lat_max": -53.95}, 50.0),
                      ({"lon_min": 76.3, "lon_max": 76.75, "lat_min": 35.6,
                        "lat_max": 35.95}, 25.0)]:
        assert domain.curved_grid(dom, dist, ellps=ellps) == \
            domain_ref.curved_grid(dom, dist, ellps=ellps)
    bad = {"lon_min": 1.0, "lon_max": 0.0, "lat_min": 0.0, "lat_max": 1.0}
    for mod in (domain, domain_ref):
        with pytest.raises(ValueError, match="Invalid domain"):
            mod.curved_grid(bad, 1.0, ellps=ellps)
        with pytest.raises(ValueError, match="exceeds valid range"):
            mod.curved_grid({"lon_min": 179.0, "lon_max": 179.5,
                             "lat_min": 0.0, "lat_max": 1.0}, 100.0,
                            ellps=ellps)


def test_geoid_grid_sample_bilinear():
    """tests/test_geoid.py::test_grid_sample_bilinear on the copy, and
    every query equal to the original's."""
    kw = dict(lat=np.array([0.0, 1.0, 2.0]), lon=np.array([10.0, 11.0, 12.0]),
              values=np.arange(9.0).reshape(3, 3))
    g, g_ref = geoid.GeoidGrid(**kw), geoid_ref.GeoidGrid(**kw)
    queries = [([10.0, 12.0], [0.0, 2.0]), ([10.5], [0.5]),
               ([10.0], [2.0, 0.0]), ([9.0], [-1.0]),
               (np.linspace(9.5, 12.5, 7), np.linspace(2.2, -0.3, 5))]
    want = [[[0.0, 2.0], [6.0, 8.0]], [[2.0]], [[6.0], [0.0]], [[0.0]],
            None]
    for (lon_q, lat_q), w in zip(queries, want):
        got = g.sample(np.array(lon_q), np.array(lat_q))
        np.testing.assert_array_equal(
            got, g_ref.sample(np.array(lon_q), np.array(lat_q)))
        if w is not None:
            np.testing.assert_allclose(got, w)


def test_geoid_undulation_validation():
    for mod in (geoid, geoid_ref):
        with pytest.raises(NotImplementedError, match="not supported"):
            mod.undulation([0.0], [0.0], geoid="EGM2008")
        with pytest.raises(ValueError, match="coverage"):
            mod.undulation([181.0], [0.0])
        with pytest.raises(ValueError, match="coverage"):
            mod.undulation([-150.0], [48.0], geoid="GEOID12A")
        with pytest.raises(ValueError, match="monotonically increasing"):
            mod.undulation([1.0, 0.0], [0.0, 1.0])
        with pytest.raises(ValueError, match="monotonic"):
            mod.undulation([0.0, 1.0], [0.0, 2.0, 1.0])


def test_geoid_undulation_from_cached_grid(monkeypatch):
    """tests/test_geoid.py::test_undulation_from_cached_grid on the copy
    (EGM96's longitude wrap, descending latitudes), equal to the
    original on a random grid."""
    lon = np.linspace(0.0, 360.0, 145)
    lat = np.linspace(-90.0, 90.0, 73)
    vals = np.broadcast_to(lon, (lat.size, lon.size)).copy()
    monkeypatch.setitem(geoid._GRID_CACHE, "EGM96",
                        geoid.GeoidGrid(lat=lat, lon=lon, values=vals))
    out = geoid.undulation(np.array([-90.0, 0.0, 90.0]),
                           np.array([10.0, -45.0]))
    np.testing.assert_allclose(out, [[270.0, 0.0, 90.0]] * 2)
    out_desc = geoid.undulation(np.array([45.0]), np.array([30.0, -30.0]))
    np.testing.assert_allclose(out_desc, [[45.0], [45.0]])
    rnd = np.random.default_rng(3).normal(size=(lat.size, lon.size))
    monkeypatch.setitem(geoid._GRID_CACHE, "EGM96",
                        geoid.GeoidGrid(lat=lat, lon=lon, values=rnd))
    monkeypatch.setitem(geoid_ref._GRID_CACHE, "EGM96",
                        geoid_ref.GeoidGrid(lat=lat, lon=lon, values=rnd))
    lon_q, lat_q = np.linspace(-179.0, 179.0, 31), np.linspace(80, -80, 17)
    np.testing.assert_array_equal(geoid.undulation(lon_q, lat_q),
                                  geoid_ref.undulation(lon_q, lat_q))


def _write_asc(path, data, x0=600000.0, y0=180000.0, cell=25.0,
               nodata=True):
    """tests/test_load_dem.py's ESRI ASCII GRID writer."""
    with open(path, "w") as f:
        f.write(f"ncols {data.shape[1]}\n"
                f"nrows {data.shape[0]}\n"
                f"xllcorner {x0}\n"
                f"yllcorner {y0}\n"
                f"cellsize {cell}\n")
        if nodata:
            f.write("NODATA_value -9999\n")
        for row in data:
            f.write(" ".join(f"{v:.2f}" for v in row) + "\n")


def test_dhm25_numpy_loader_crop_and_nan(tmp_path):
    """tests/test_load_dem.py::test_dhm25_numpy_loader_crop_and_nan on the
    copy (its native parser: this builds the port's native library)."""
    rng = np.random.default_rng(0)
    data = rng.uniform(200, 3000, size=(40, 50)).astype(np.float32)
    data[5, 7] = -9999.0
    path = str(tmp_path / "dem.asc")
    _write_asc(path, data)
    dom = {"x_min": 600000.0 + 5 * 25, "x_max": 600000.0 + 45 * 25,
           "y_min": 180000.0 + 5 * 25, "y_max": 180000.0 + 35 * 25}
    x, y, elev = load_dem.dhm25(path, dom, engine="numpy")
    assert (np.diff(x) > 0).all() and (np.diff(y) < 0).all()
    assert x[0] - (600000.0 + 5 * 25 + 12.5) < 25
    assert elev.shape == (len(y), len(x))
    src_rows = slice(40 - 35, 40 - 5)
    assert np.isnan(elev).sum() == (data[src_rows, 5:45] == -9999).sum()


@pytest.mark.parametrize("nodata", [True, False])
def test_dhm25_matches_reference(tmp_path, monkeypatch, nodata):
    """The copy's dhm25 equals the original's on the same file, both on
    the NumPy parser (the native import made to fail on both sides, so
    the reference's library is not built here)."""
    monkeypatch.setitem(sys.modules, "horayzon_tpu.native.fastdem", None)
    monkeypatch.setitem(sys.modules, "horayzon_tpu_torch.native.fastdem",
                        None)
    data = np.random.default_rng(4).uniform(
        -50, 4000, size=(23, 31)).astype(np.float32)
    data[3, 4] = -9999.0
    path = str(tmp_path / "dem.asc")
    _write_asc(path, data, nodata=nodata)
    dom = {"x_min": 600000.0 + 3 * 25, "x_max": 600000.0 + 27 * 25,
           "y_min": 180000.0 + 2 * 25, "y_max": 180000.0 + 20 * 25}
    for got, want in zip(load_dem.dhm25(path, dom),
                         load_dem_ref.dhm25(path, dom)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_dhm25_native_parser_matches_numpy(tmp_path):
    from horayzon_tpu_torch.native import fastdem
    rng = np.random.default_rng(1)
    data = rng.uniform(0, 100, size=(30, 30)).astype(np.float32)
    path = str(tmp_path / "dem.asc")
    _write_asc(path, data)
    dom = {"x_min": 600000.0, "x_max": 600000.0 + 30 * 25,
           "y_min": 180000.0, "y_max": 180000.0 + 30 * 25}
    _, _, e1 = load_dem.dhm25(path, dom, engine="numpy")
    assert e1.shape == (30, 30)
    vals = fastdem.load_esri_ascii(path, 6)
    np.testing.assert_allclose(vals.reshape(30, 30), np.round(data, 2),
                               atol=5e-3)
    np.testing.assert_array_equal(e1, vals.reshape(30, 30))


def test_print_dem_info_matches_reference(capsys):
    elev = np.array([[1.0, np.nan], [3.0, 4.0]])
    load_dem.print_dem_info(elev)
    got = capsys.readouterr().out
    assert "NaN" in got
    load_dem_ref.print_dem_info(elev)
    assert capsys.readouterr().out == got


def test_crop_centres_cover_and_slices():
    lon = np.linspace(6.0, 8.0, 41)
    lat = np.linspace(47.0, 45.0, 41)
    elev = np.arange(41 * 41, dtype=np.float32).reshape(41, 41)
    dom = dict(x_min=6.5, x_max=7.5, y_min=45.5, y_max=46.5)
    e, x, y = load_dem._crop_centres(elev, lon, lat, **dom)
    assert x.min() >= 6.5 and x.max() <= 7.5
    assert y.min() >= 45.5 and y.max() <= 46.5
    i0 = np.flatnonzero(lat <= 46.5)[0]
    j0 = np.flatnonzero(lon >= 6.5)[0]
    np.testing.assert_array_equal(e, elev[i0:i0 + len(y), j0:j0 + len(x)])
    for got, want in zip((e, x, y),
                         load_dem_ref._crop_centres(elev, lon, lat, **dom)):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="cover"):
        load_dem._crop_centres(elev, lon, lat, 5.0, 7.0, 45.5, 46.5)


def test_nasadem_preprocess_trims_shared_margin():
    class FakeDs:
        def __init__(self, sizes):
            self.sizes = dict(sizes)
            self.trimmed = None

        def isel(self, **kw):
            self.trimmed = kw
            return self

    for sizes, want in [({"lon": 3601, "lat": 3601},
                         {"lon": slice(0, 3600), "lat": slice(0, 3600)}),
                        ({"lon": 3600, "lat": 3601},
                         {"lat": slice(0, 3600)}),
                        ({"lon": 3600, "lat": 3600}, None)]:
        assert load_dem.preprocess(FakeDs(sizes)).trimmed == want
        assert load_dem_ref.preprocess(FakeDs(sizes)).trimmed == want


def test_import_needs_no_optional_package(tmp_path):
    """Importing the port, its loaders and its writers needs none of the
    optional back-ends (each blocked in a fresh interpreter), and NASADEM
    without xarray says what it needs."""
    code = (
        "import sys\n"
        "for m in ('PIL', 'osgeo', 'xarray', 'shapely', 'fiona', 'skimage',"
        " 'requests', 'tqdm'):\n"
        "    sys.modules[m] = None\n"
        "import horayzon_tpu_torch\n"
        "from horayzon_tpu_torch import load_dem, ocean_masking, geoid\n"
        "from horayzon_tpu_torch.utils import output, streaming\n"
        "try:\n"
        "    load_dem.nasadem(['none.nc'], {'lon_min': 0.0, 'lon_max': 1.0,"
        " 'lat_min': 0.0, 'lat_max': 1.0})\n"
        "except ImportError as e:\n"
        "    assert 'xarray' in str(e), e\n"
        "    print('LAZY-OK')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and "LAZY-OK" in res.stdout, (
        res.stdout[-2000:] + res.stderr[-2000:])


def _island_mask(n=60):
    """tests/test_ocean_masking.py's island."""
    lat = -54.0 + np.arange(n) * 0.01
    lon = -37.0 + np.arange(n) * 0.01
    lon2, lat2 = np.meshgrid(lon, lat)
    land = ((lon2 + 36.7) ** 2 + (lat2 + 53.7) ** 2) < 0.04
    return lon, lat, land


def test_coastline_contours_points_near_boundary():
    lon, lat, land = _island_mask()
    contours = ocean_masking.coastline_contours(lon, lat,
                                                land.astype(np.uint8))
    want = ocean_ref.coastline_contours(lon, lat, land.astype(np.uint8))
    assert len(contours) == len(want) >= 1
    for a, b in zip(contours, want):
        np.testing.assert_array_equal(a, b)
    pts = np.vstack(contours)
    assert pts.shape[1] == 2
    assert pts[:, 0].min() >= lon.min() and pts[:, 0].max() <= lon.max()
    r = np.hypot(pts[:, 0] + 36.7, pts[:, 1] + 53.7)
    assert (np.abs(r - 0.2) < 0.03).mean() > 0.9


def test_coastline_distance_and_buffer():
    lon, lat, land = _island_mask()
    pts = np.vstack(ocean_masking.coastline_contours(
        lon, lat, land.astype(np.uint8)))
    pex, pey, pez = transform.lonlat2ecef(
        pts[:, 0], pts[:, 1], np.zeros(len(pts), np.float32), "WGS84")
    pts_ecef = np.stack([pex, pey, pez], axis=-1)
    lon2, lat2 = np.meshgrid(lon, lat)
    xe, ye, ze = transform.lonlat2ecef(lon2, lat2,
                                       np.zeros_like(lon2, np.float32),
                                       "WGS84")
    for a, b in zip((xe, ye, ze), transform_ref.lonlat2ecef(
            lon2, lat2, np.zeros_like(lon2, np.float32), "WGS84")):
        np.testing.assert_array_equal(a, b)
    dist = ocean_masking.coastline_distance(xe, ye, ze, land, pts_ecef)
    np.testing.assert_array_equal(
        dist, ocean_ref.coastline_distance(xe, ye, ze, land, pts_ecef))
    assert np.isnan(dist[land]).all()
    assert np.nanmin(dist) >= 0.0
    assert dist[0, 0] > 10000.0
    args = (xe, ye, ze, land, pts_ecef, lat, 10000.0, 0.01, "WGS84")
    buf = ocean_masking.coastline_buffer(*args, block_size=5)
    np.testing.assert_array_equal(
        buf, ocean_ref.coastline_buffer(*args, block_size=5))
    assert buf.dtype == bool
    assert not buf[land].any()
    assert buf[0, 0]
    near = (~land) & (dist < 5000.0)
    assert not buf[near].any()
    with pytest.raises(ValueError, match="uneven"):
        ocean_masking.coastline_buffer(*args, block_size=4)


# --- native/ (builds the port's native library) -----------------------------

@pytest.fixture(scope="module")
def fastdem():
    from horayzon_tpu_torch.native import fastdem as mod
    mod.get_lib()
    return mod


def test_load_esri_ascii(fastdem):
    data = np.random.default_rng(0).normal(size=(20, 30)).astype(np.float32)
    with tempfile.NamedTemporaryFile("w", suffix=".asc", delete=False) as f:
        f.write("ncols 30\nnrows 20\nxllcorner 0\nyllcorner 0\n"
                "cellsize 25\nNODATA_value -9999\n")
        for row in data:
            f.write(" ".join(f"{v:.6f}" for v in row) + "\n")
        path = f.name
    try:
        out = fastdem.load_esri_ascii(path, 6)
        assert out.size == data.size
        np.testing.assert_allclose(out.reshape(20, 30), data, atol=1e-5)
    finally:
        os.unlink(path)


def test_native_horizon_matches_numpy_oracle(fastdem):
    dx = 25.0
    z = gaussian_bumps_terrain(48, 48, seed=3, amp=300.0)
    azim = (2 * np.pi / 8) * np.arange(8)
    hori_c, samples = fastdem.horizon_march(
        z, dx, -dx, (18, 18), (8, 8), azim, 800.0, step=dx / 4)
    hori_np = brute_horizon(z, dx, -dx, (18, 18), (8, 8), azim, 800.0,
                            step_frac=0.25)
    assert samples > 0
    np.testing.assert_allclose(hori_c, hori_np, atol=1e-4)


def test_native_shadow_matches_numpy_oracle(fastdem):
    dx = 25.0
    z = gaussian_bumps_terrain(48, 48, seed=11, amp=600.0)
    sun = np.array([1.0e7, 0.0, 1.5e6])
    occ_c = fastdem.shadow_march(z, dx, -dx, (8, 8), (32, 32), sun,
                                 step=dx / 4)
    occ_np = brute_shadow(z, dx, -dx, (8, 8), (32, 32), sun,
                          step_frac=0.25)
    assert (occ_c.astype(bool) == occ_np).mean() > 0.99


def test_native_max_downsample2(fastdem):
    for shape in [(5, 6), (7, 3), (4, 4)]:
        z = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
        out = fastdem.max_downsample2(z)
        np.testing.assert_array_equal(
            out, mip.max_downsample2(torch.from_numpy(z)).numpy())


def test_native_build_is_reused(fastdem, monkeypatch):
    """A second ``ensure_built`` with the source unchanged reuses the
    library (its sidecar digest) and runs no compiler."""
    from horayzon_tpu_torch.native import buildlib

    def no_compiler(*a, **kw):
        raise AssertionError("g++ ran again")

    monkeypatch.setattr(buildlib.subprocess, "run", no_compiler)
    assert buildlib.ensure_built(fastdem._SRC, fastdem._SO) == fastdem._SO


def test_bvh_baseline_matches_sweep():
    """tests/test_native.py::test_bvh_baseline_matches_sweep on the copy,
    against the port's XLA engine (plain torch on the CPU)."""
    from horayzon_tpu_torch.native import bvhbase
    bvhbase.get_lib()
    z = gaussian_bumps_terrain(192, 192, seed=11, amp=500.0)
    dx = 25.0
    halo, inner = 80, 32
    azim_num = 16
    hori, n_rays, _, _ = bvhbase.horizon_rays(
        z, dx, -dx, (halo, halo), (inner, inner), azim_num, 1800.0,
        hori_acc=0.25)
    azim = (2 * np.pi / azim_num) * np.arange(azim_num)
    h_x, _ = sweep.horizon_sweep(
        torch.from_numpy(z), dx=dx, dy=-dx, offset=(halo, halo),
        inner_shape=(inner, inner), azim=azim, dist_search=1800.0,
        hori_acc=0.25)
    d = np.rad2deg(np.abs(h_x.numpy() - hori))
    assert d.max() < 1.0, f"BVH vs sweep max {d.max():.3f} deg"
    assert np.percentile(d, 99) < 0.5
    _, n_rays_360, _, _ = bvhbase.horizon_rays(
        z, dx, -dx, (halo, halo), (8, 8), 360, 1800.0, hori_acc=0.25)
    rpca = n_rays_360 / (8 * 8 * 360)
    assert rpca < 4.0, f"rays/(cell*azim) at 360 azimuths: {rpca:.2f}"
