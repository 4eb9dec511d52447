# Copyright (c) 2026
# MIT License
"""ctypes bindings for the native helpers (fastdem.cpp).

Copy of :mod:`horayzon_tpu.native.fastdem` with its imports pointed at this
package (importing ``horayzon_tpu`` loads JAX);
``tests/test_torch_host_modules.py`` holds it equal to the original.

The shared library is built lazily on first use with the system C++
toolchain (g++); all call sites have pure-NumPy fallbacks, so a missing
compiler only costs performance, never functionality.
"""

import ctypes
import os
import threading

import numpy as np

from horayzon_tpu_torch.native.buildlib import NativeBuildError, ensure_built

__all__ = ["NativeBuildError", "get_lib", "load_esri_ascii",
           "horizon_march", "shadow_march", "max_downsample2"]

_LOCK = threading.Lock()
_LIB = None
_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "fastdem.cpp")
_SO = os.path.join(_HERE, "_fastdem.so")


def get_lib():
    """Load (building if necessary) the native library."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        ensure_built(_SRC, _SO)
        lib = ctypes.CDLL(_SO)
        lib.load_esri_ascii.restype = ctypes.c_long
        lib.load_esri_ascii.argtypes = [
            ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_long]
        lib.horizon_march.restype = ctypes.c_longlong
        lib.horizon_march.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_long, ctypes.c_long,
            ctypes.c_double, ctypes.c_double,
            ctypes.c_long, ctypes.c_long, ctypes.c_long, ctypes.c_long,
            ctypes.POINTER(ctypes.c_double), ctypes.c_long,
            ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_double, ctypes.c_double, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float)]
        lib.shadow_march.restype = None
        lib.shadow_march.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_long, ctypes.c_long,
            ctypes.c_double, ctypes.c_double,
            ctypes.c_long, ctypes.c_long, ctypes.c_long, ctypes.c_long,
            ctypes.POINTER(ctypes.c_double), ctypes.c_double,
            ctypes.c_double, ctypes.c_int,
            ctypes.POINTER(ctypes.c_ubyte)]
        lib.max_downsample2.restype = None
        lib.max_downsample2.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_long, ctypes.c_long,
            ctypes.c_float, ctypes.POINTER(ctypes.c_float)]
        _LIB = lib
        return _LIB


def _fptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def load_esri_ascii(path, skip_lines):
    """Parse an ESRI ASCII GRID body into a flat float32 array."""
    lib = get_lib()
    size = os.path.getsize(path)
    # Worst case ~2 bytes per value ("0 ")
    capacity = size // 2 + 16
    out = np.empty(capacity, dtype=np.float32)
    n = lib.load_esri_ascii(path.encode(), int(skip_lines), _fptr(out),
                            capacity)
    if n < 0:
        raise IOError(f"failed to parse {path}")
    return out[:n].copy()


def horizon_march(z, dx, dy, offset, inner_shape, azim, dist, step=None,
                  ray_org_elev=0.01, elev_low_deg=-15.0, elev_up_deg=89.98,
                  num_threads=0):
    """CPU reference horizon (planar geometry).

    Returns (hori (in0, in1, A) float32 [radian], samples_taken)."""
    lib = get_lib()
    z = np.ascontiguousarray(z, dtype=np.float32)
    azim = np.ascontiguousarray(azim, dtype=np.float64)
    h, w = z.shape
    in0, in1 = inner_shape
    if step is None:
        step = min(abs(dx), abs(dy))
    hori = np.empty((in0, in1, len(azim)), dtype=np.float32)
    samples = lib.horizon_march(
        _fptr(z), h, w, float(dx), float(dy),
        int(offset[0]), int(offset[1]), in0, in1,
        azim.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(azim),
        float(dist), float(step), float(ray_org_elev),
        float(np.deg2rad(elev_low_deg)), float(np.deg2rad(elev_up_deg)),
        int(num_threads), _fptr(hori))
    return hori, int(samples)


def shadow_march(z, dx, dy, offset, inner_shape, sun_position, step=None,
                 ray_org_elev=0.05, num_threads=0):
    """CPU reference sun-occlusion test; returns a uint8 (in0, in1) mask."""
    lib = get_lib()
    z = np.ascontiguousarray(z, dtype=np.float32)
    sun = np.ascontiguousarray(sun_position, dtype=np.float64)
    h, w = z.shape
    in0, in1 = inner_shape
    if step is None:
        step = min(abs(dx), abs(dy))
    occ = np.empty((in0, in1), dtype=np.uint8)
    lib.shadow_march(
        _fptr(z), h, w, float(dx), float(dy),
        int(offset[0]), int(offset[1]), in0, in1,
        sun.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        float(step), float(ray_org_elev), int(num_threads),
        occ.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)))
    return occ


def max_downsample2(z, pad_value=-3.0e4):
    """2x2 max-pool (native)."""
    lib = get_lib()
    z = np.ascontiguousarray(z, dtype=np.float32)
    h, w = z.shape
    out = np.empty(((h + 1) // 2, (w + 1) // 2), dtype=np.float32)
    lib.max_downsample2(_fptr(z), h, w, np.float32(pad_value), _fptr(out))
    return out
