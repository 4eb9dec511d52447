# Copyright (c) 2026
# MIT License
"""The curved geometry of a lon/lat DEM on the pipeline's device.

:func:`build` is ``CurvedPipeline.build_geometry``'s work: the float32 ENU
mesh of the outer DEM (``transform.lonlat2ecef`` then ``ecef2enu``) and,
on the inner block, the surface normals and north vectors rotated into ENU
(``direction.surf_norm``, ``north_dir``, ``transform.ecef2enu_vector``),
all as float32 NumPy arrays in host memory:

* on the CPU, :func:`plain`: those NumPy functions on the meshgrid, as the
  JAX package builds it;
* on a CUDA device, the kernel ``csrc/geometry.cu`` (G1), one thread per
  outer cell, which repeats their float64 operations in their order from
  the per-axis factors of :func:`axis_factors`, so the mesh is bit-equal
  to :func:`plain`'s.  ``ecef2enu_vector``'s product runs through BLAS, in
  the library's order; the kernel sums it as OpenBLAS's x86-64 kernels do
  (a fused multiply-add chain), so the normals and norths are bit-equal
  with that library, and otherwise within one float32 ulp of each value
  or, where the three terms cancel, the float64 rounding of the sum.

A CUDA call uploads the heights and the factors, launches once and reads
one packed float32 buffer back; the arrays it returns are views of it.
"""

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from horayzon_tpu_torch import direction, transform
from horayzon_tpu_torch.ops import _build

#: Mesh rows a CUDA grid can hold (65,535 blocks of 8 rows).
MAX_ROWS = 65535 * 8

#: Launches of the geometry kernel made by this process (incremented only
#: where the wrapper launches it).
KERNEL_LAUNCHES = 0


class AxisFactors(NamedTuple):
    """What the kernel takes from the host, each from ``transform``'s own
    expressions: per row (latitude) ``sin_lat``, ``cos_lat``, the prime
    vertical radius ``n`` and the z factor ``zf`` (``b**2 / a**2 * n``;
    on the sphere both are the radius), per column (longitude) ``sin_lon``,
    ``cos_lon``, all float64; the ENU ``origin`` in ECEF (3,), the rotation
    ``rot`` (3, 3) of ``ecef2enu_vector``, whose rows also give
    ``ecef2enu``'s products, the polar semi-axis ``b`` and ``sphere``."""
    sin_lat: np.ndarray
    cos_lat: np.ndarray
    n: np.ndarray
    zf: np.ndarray
    sin_lon: np.ndarray
    cos_lon: np.ndarray
    origin: np.ndarray
    rot: np.ndarray
    b: float
    sphere: bool


def axis_factors(lon, lat, trans):
    """The :class:`AxisFactors` of the 1-D axes ``lon``, ``lat`` [degree]
    and the ENU frame ``trans`` (a ``transform.TransformerEcef2enu``):
    O(H + W) NumPy work, each value that of the meshgrid's cell."""
    lon_r = np.deg2rad(np.asarray(lon, dtype=np.float64))
    lat_r = np.deg2rad(np.asarray(lat, dtype=np.float64))
    a, b, e_2 = transform.ellipsoid_params(trans.ellps)
    sphere = trans.ellps == "sphere"
    if sphere:
        n = np.full_like(lat_r, a)
        zf = n
    else:
        n = a / np.sqrt(1.0 - e_2 * np.sin(lat_r) ** 2)
        zf = b ** 2 / a ** 2 * n
    # transform.ecef2enu_vector's matrix, as it forms it; ecef2enu's
    # products are its entries (-sin_lat * sin_lon is the negated product)
    sin_lon, cos_lon = (np.sin(np.deg2rad(trans.lon_or)),
                        np.cos(np.deg2rad(trans.lon_or)))
    sin_lat, cos_lat = (np.sin(np.deg2rad(trans.lat_or)),
                        np.cos(np.deg2rad(trans.lat_or)))
    rot = np.array([[-sin_lon, cos_lon, 0.0],
                    [-sin_lat * cos_lon, -sin_lat * sin_lon, cos_lat],
                    [cos_lat * cos_lon, cos_lat * sin_lon, sin_lat]],
                   dtype=np.float64)
    origin = np.array([trans.x_ecef_or, trans.y_ecef_or, trans.z_ecef_or])
    return AxisFactors(np.sin(lat_r), np.cos(lat_r), n, zf, np.sin(lon_r),
                       np.cos(lon_r), origin, rot, float(b), sphere)


def plain(lon, lat, elevation, slice_in, trans):
    """The plain version: ``(x, y, z, vec_norm, vec_north)`` from
    ``transform`` and ``direction`` on the meshgrid of ``lon``, ``lat``,
    the heights ``elevation`` (float32, (len(lat), len(lon))), the inner
    block ``slice_in`` (two slices) and the ENU frame ``trans``."""
    lon_2d, lat_2d = np.meshgrid(lon, lat)
    xe, ye, ze = transform.lonlat2ecef(lon_2d, lat_2d, elevation,
                                       trans.ellps)
    x, y, z = transform.ecef2enu(xe, ye, ze, trans)
    sl = slice_in
    vn_ecef = direction.surf_norm(lon_2d[sl], lat_2d[sl])
    vnorth_ecef = direction.north_dir(xe[sl], ye[sl], ze[sl], vn_ecef,
                                      trans.ellps)
    return (x, y, z, transform.ecef2enu_vector(vn_ecef, trans),
            transform.ecef2enu_vector(vnorth_ecef, trans))


class _GeoParams(ctypes.Structure):
    """Mirror of ``struct GeoParams`` in csrc/geometry.cu."""
    _fields_ = (
        [(n, ctypes.c_void_p) for n in ("height", "rows", "cols", "out")]
        + [(n, ctypes.c_double)
           for n in ("ox", "oy", "oz", "r00", "r01", "r02", "r10", "r11",
                     "r12", "r20", "r21", "r22", "b")]
        + [(n, ctypes.c_int)
           for n in ("hgt", "wid", "r0", "c0", "n0", "n1", "sphere")])


def _kernel_lib():
    """The loaded library of the geometry kernel (built with nvcc on first
    use)."""
    lib = _build.load("geometry")
    lib.geometry_launch.argtypes = [ctypes.POINTER(_GeoParams), ctypes.c_int,
                                    ctypes.c_void_p]
    lib.geometry_launch.restype = ctypes.c_int
    lib.geometry_error_string.argtypes = [ctypes.c_int]
    lib.geometry_error_string.restype = ctypes.c_char_p
    lib.geometry_params_size.argtypes = []
    lib.geometry_params_size.restype = ctypes.c_int
    size = lib.geometry_params_size()
    if size != ctypes.sizeof(_GeoParams):
        raise RuntimeError(f"GeoParams is {size} bytes in the kernel but "
                           f"{ctypes.sizeof(_GeoParams)} in _GeoParams")
    return lib


def _prepare(lon, lat, elevation, slice_in, trans, dev):
    """The host part of a CUDA build: the factors computed, the heights and
    the factors uploaded, the packed output allocated.  Returns
    ``(params, keep, out)``: the kernel's parameter block, the uploaded
    tensors it points into (to be kept alive until the launch) and the
    float32 output: x, y, z (H, W) each, then vec_norm and vec_north
    (n0, n1, 3) each."""
    elevation = np.ascontiguousarray(elevation, dtype=np.float32)
    hgt, wid = elevation.shape
    if (hgt, wid) != (len(lat), len(lon)):
        raise ValueError("Inconsistent shapes of input arrays")
    if hgt > MAX_ROWS:
        raise ValueError(f"a mesh of {hgt} rows exceeds the kernel's "
                         f"{MAX_ROWS}")
    (r0, r1, _), (c0, c1, _) = (s.indices(m) for s, m in
                                zip(slice_in, (hgt, wid)))
    f = axis_factors(lon, lat, trans)
    height = torch.from_numpy(elevation).to(dev)
    factors = torch.from_numpy(np.concatenate(
        [f.sin_lat, f.cos_lat, f.n, f.zf, f.sin_lon, f.cos_lon])).to(dev)
    n0, n1 = r1 - r0, c1 - c0
    out = torch.empty(3 * hgt * wid + 6 * n0 * n1, dtype=torch.float32,
                      device=dev)
    prm = _GeoParams()
    prm.height, prm.out = height.data_ptr(), out.data_ptr()
    prm.rows = factors.data_ptr()
    prm.cols = prm.rows + 4 * hgt * factors.element_size()
    prm.ox, prm.oy, prm.oz = f.origin.tolist()
    ((prm.r00, prm.r01, prm.r02), (prm.r10, prm.r11, prm.r12),
     (prm.r20, prm.r21, prm.r22)) = f.rot.tolist()
    prm.b = f.b
    prm.hgt, prm.wid, prm.r0, prm.c0, prm.n0, prm.n1 = (hgt, wid, r0, c0,
                                                        n0, n1)
    prm.sphere = int(f.sphere)
    return prm, (height, factors), out


def _launch(prm, dev):
    """One launch of the kernel on ``prm`` (from :func:`_prepare`) on
    ``dev``'s current stream; raises if the launch fails."""
    global KERNEL_LAUNCHES
    lib = _kernel_lib()
    err = lib.geometry_launch(
        ctypes.byref(prm),
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        msg = lib.geometry_error_string(err).decode()
        raise RuntimeError(f"geometry kernel launch failed: {msg}")
    KERNEL_LAUNCHES += 1


def unpack(buf, shape, inner_shape):
    """``(x, y, z, vec_norm, vec_north)`` as views of the packed float32
    output ``buf`` of a mesh of ``shape`` and an inner block of
    ``inner_shape``."""
    plane = shape[0] * shape[1]
    vec = inner_shape[0] * inner_shape[1] * 3
    x, y, z = buf[:3 * plane].reshape((3,) + tuple(shape))
    vec_norm = buf[3 * plane:3 * plane + vec].reshape(tuple(inner_shape)
                                                      + (3,))
    vec_north = buf[3 * plane + vec:].reshape(tuple(inner_shape) + (3,))
    return x, y, z, vec_norm, vec_north


def build(lon, lat, elevation, slice_in, trans, *, device="cuda"):
    """``(x, y, z, vec_norm, vec_north)`` of the lon/lat DEM: the float32
    ENU mesh of ``elevation`` ((len(lat), len(lon)) heights above the
    ellipsoid [m]) on the 1-D axes ``lon``, ``lat`` [degree] in the frame
    ``trans`` (a ``transform.TransformerEcef2enu``, whose ``ellps`` is the
    DEM's), and the inner block's (``slice_in``, two slices) normals and
    norths in ENU, float32 (n0, n1, 3), all in host memory.  The CPU runs
    :func:`plain`; a CUDA device the kernel (built with nvcc on first use;
    a failed build or launch raises), then reads its output back."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return plain(lon, lat, elevation, slice_in, trans)
    if dev.type != "cuda":
        raise ValueError(f"no geometry build for device {dev}")
    prm, keep, out = _prepare(lon, lat, elevation, slice_in, trans, dev)
    _launch(prm, dev)
    return unpack(out.cpu().numpy(), (prm.hgt, prm.wid), (prm.n0, prm.n1))
