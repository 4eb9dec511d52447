"""The curved geometry (``ops/geometry.py``) on the CPU.

* The plain version, the CPU route of ``CurvedPipeline.build_geometry``,
  is, bit for bit, the JAX package's ``CurvedPipeline.build_geometry``
  (NumPy on the meshgrid), and launches nothing.
* The wrapper's host factors (per-row and per-column arrays, the ENU
  origin, the rotation) equal ``transform``'s on the meshgrid, and the
  geometry kernel's arithmetic on them (``torch_scenes.geometry_model``,
  the kernel's operations in its order) gives the ENU mesh and the ECEF
  normals and norths of ``transform`` and ``direction`` bit for bit, on
  the sphere, GRS80 and WGS84, latitude descending and ascending, on small
  DEMs and once at ``srtm_alps_hz``'s 972 x 1350 cells.  The normals and
  norths rotated into ENU: within one float32 ulp (plus the float64
  rounding of the sum where its three terms cancel), because
  ``ecef2enu_vector``'s product runs through BLAS in the library's order;
  the kernel sums as OpenBLAS's x86-64 kernels do (a fused multiply-add
  chain), with which they are bit-equal.
* The ctypes parameter block mirrors the kernel's struct.

The kernel is held to the plain version on the card
(``tests/test_torch_cuda.py -k geometry``).  Imports the JAX package for
its NumPy ``CurvedPipeline.build_geometry``; a few seconds.
"""

import ctypes
import pathlib
import re

import numpy as np
import pytest

from horayzon_tpu.models import CurvedPipeline as CurvedPipelineRef
from horayzon_tpu_torch import direction, transform
from horayzon_tpu_torch.models import CurvedPipeline
from horayzon_tpu_torch.ops import geometry

from torch_scenes import (GEOMETRY_MESHES, curved_pipeline_scene,
                          geometry_mesh, geometry_model,
                          within_rotation_rounding)

SMALL = sorted(n for n in GEOMETRY_MESHES if n != "srtm_alps")


def _bits_equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return (got.dtype == want.dtype and got.shape == want.shape
            and np.array_equal(got.view(f"u{got.itemsize}"),
                               want.view(f"u{want.itemsize}")))


def _numpy_build(lon, lat, elevation, slice_in, trans):
    """``transform`` and ``direction`` on the meshgrid: the ECEF mesh, the
    ENU mesh and the inner block's ECEF normals and norths."""
    lon_2d, lat_2d = np.meshgrid(lon, lat)
    ecef = transform.lonlat2ecef(lon_2d, lat_2d, elevation, trans.ellps)
    enu = transform.ecef2enu(*ecef, trans)
    vn = direction.surf_norm(lon_2d[slice_in], lat_2d[slice_in])
    vnorth = direction.north_dir(*(a[slice_in] for a in ecef), vn,
                                 trans.ellps)
    return lon_2d, lat_2d, ecef, enu, vn, vnorth


@pytest.mark.parametrize("name", SMALL)
def test_axis_factors_equal_transforms_on_the_meshgrid(name):
    lon, lat, elevation, slice_in, trans = geometry_mesh(name)
    f = geometry.axis_factors(lon, lat, trans)
    lon_2d, lat_2d, ecef, _, _, _ = _numpy_build(lon, lat, elevation,
                                                 slice_in, trans)
    lon_r, lat_r = np.deg2rad(lon_2d), np.deg2rad(lat_2d)
    for got, want in ((f.sin_lat, np.sin(lat_r)[:, 0]),
                      (f.cos_lat, np.cos(lat_r)[:, 0]),
                      (f.sin_lon, np.sin(lon_r)[0]),
                      (f.cos_lon, np.cos(lon_r)[0])):
        assert _bits_equal(got, want)
    assert f.origin.tolist() == [trans.x_ecef_or, trans.y_ecef_or,
                                 trans.z_ecef_or]
    assert f.sphere == (trans.ellps == "sphere")
    assert f.b == transform.ellipsoid_params(trans.ellps)[1]
    # the rotation: ecef2enu_vector's matrix (its basis images, float32)
    basis = transform.ecef2enu_vector(np.eye(3)[None], trans)[0]
    assert _bits_equal(basis, f.rot.T.astype(np.float32))
    # the ECEF mesh rebuilt from the factors in lonlat2ecef's order
    x, y, z = geometry_model(lon, lat, elevation, slice_in, trans,
                             cells=(np.zeros(0, int),) * 2)[:3]
    enu = transform.ecef2enu(*ecef, trans)
    for got, want in zip((x, y, z), enu):
        assert _bits_equal(got, want)


@pytest.mark.parametrize("name", SMALL + ["srtm_alps"])
def test_kernel_arithmetic_matches_the_numpy_build(name):
    """The kernel's arithmetic against ``transform`` and ``direction``: the
    ENU mesh and the ECEF normals and norths bit-equal, the rotated ones
    within the rotation's rounding (at the full-size DEM on 2048 seeded
    inner cells: the exact fused multiply-add takes rational arithmetic)."""
    lon, lat, elevation, slice_in, trans = geometry_mesh(name)
    _, _, _, enu, vn, vnorth = _numpy_build(lon, lat, elevation, slice_in,
                                            trans)
    inner = vn.shape[:2]
    cells = None
    if name == "srtm_alps":
        rng = np.random.default_rng(1)
        cells = (rng.integers(0, inner[0], 2048),
                 rng.integers(0, inner[1], 2048))
    x, y, z, v_norm, v_north, r_norm, r_north = geometry_model(
        lon, lat, elevation, slice_in, trans, cells)
    for got, want in zip((x, y, z, v_norm, v_north), enu + (vn, vnorth)):
        assert _bits_equal(got, want)
    want_norm = transform.ecef2enu_vector(vn, trans)
    want_north = transform.ecef2enu_vector(vnorth, trans)
    if cells is not None:
        want_norm, want_north = want_norm[cells], want_north[cells]
    assert within_rotation_rounding(r_norm, want_norm)
    assert within_rotation_rounding(r_north, want_north)


@pytest.mark.parametrize("name", ["wgs84_north_down", "sphere_north_up"])
def test_cpu_route_is_the_plain_version(name):
    lon, lat, elevation, slice_in, trans = geometry_mesh(name)
    n0 = geometry.KERNEL_LAUNCHES
    got = geometry.build(lon, lat, elevation, slice_in, trans, device="cpu")
    assert geometry.KERNEL_LAUNCHES == n0
    want = geometry.plain(lon, lat, elevation, slice_in, trans)
    assert len(got) == 5
    for g, w in zip(got, want):
        assert _bits_equal(g, w)
    assert got[3].shape == got[4].shape == (
        slice_in[0].stop - slice_in[0].start,
        slice_in[1].stop - slice_in[1].start, 3)


def test_pipeline_geometry_is_the_reference_build():
    """``CurvedPipeline.build_geometry`` on the CPU against the JAX
    package's on the same DEM: the ENU mesh, normals and norths bit-equal,
    the same ENU frame."""
    pipe, _ = curved_pipeline_scene(n0=60, n1=80)
    pipe.build_geometry()
    ref = CurvedPipelineRef(pipe.lon, pipe.lat, pipe.elevation, pipe.domain,
                            pipe.dist_search, ellps=pipe.ellps)
    ref.build_geometry()
    for key in ("x", "y", "z", "vec_norm", "vec_north"):
        assert _bits_equal(getattr(pipe, key), getattr(ref, key)), key
    assert (pipe.trans.lon_or, pipe.trans.lat_or, pipe.trans.x_ecef_or) == (
        ref.trans.lon_or, ref.trans.lat_or, ref.trans.x_ecef_or)


def test_wrapper_refuses_other_devices():
    lon, lat, elevation, slice_in, trans = geometry_mesh("wgs84_north_down")
    with pytest.raises(ValueError, match="no geometry build"):
        geometry.build(lon, lat, elevation, slice_in, trans, device="meta")


def test_unpack_gives_views_of_the_packed_output():
    shape, inner = (4, 5), (2, 3)
    buf = np.arange(3 * 20 + 6 * 6, dtype=np.float32)
    x, y, z, vn, vnorth = geometry.unpack(buf, shape, inner)
    assert x.shape == y.shape == z.shape == shape
    assert vn.shape == vnorth.shape == inner + (3,)
    assert x[0, 0] == 0 and y[0, 0] == 20 and z[3, 4] == 59
    assert vn[0, 0, 0] == 60 and vn[1, 2, 2] == 77 and vnorth[0, 0, 0] == 78
    assert all(a.base is not None and np.shares_memory(a, buf)
               for a in (x, y, z, vn, vnorth))


def test_params_block_mirrors_the_kernel_struct():
    """``_GeoParams`` lists ``struct GeoParams``'s fields in order, with
    the same types, so the block the wrapper fills is the one the kernel
    reads (the library also compares the two sizes when it loads)."""
    src = (pathlib.Path(geometry.__file__).resolve().parent.parent
           / "csrc" / "geometry.cu").read_text()
    body = re.search(r"struct GeoParams \{(.*?)\};", src, re.S).group(1)
    fields = re.findall(r"^\s*(const float\*|const double\*|float\*|double|"
                        r"int)\s+(\w+);", body, re.M)
    kinds = {"const float*": ctypes.c_void_p, "const double*":
             ctypes.c_void_p, "float*": ctypes.c_void_p,
             "double": ctypes.c_double, "int": ctypes.c_int}
    assert [(n, kinds[t]) for t, n in fields] == list(
        geometry._GeoParams._fields_)
    assert ctypes.sizeof(geometry._GeoParams) == 4 * 8 + 13 * 8 + 8 * 4
