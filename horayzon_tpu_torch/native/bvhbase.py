# Copyright (c) 2026
# MIT License
"""ctypes bindings for the measured BVH-CPU baseline (bvhbase.cpp).

Copy of :mod:`horayzon_tpu.native.bvhbase` with its imports pointed at this
package (importing ``horayzon_tpu`` loads JAX);
``tests/test_torch_host_modules.py`` holds it equal to the original.

This is the calibration half of the benchmark story (BASELINE.md): the
reference's hot path is Embree ``rtcOccluded1`` over a triangulated DEM
with a warm-started elevation search (~2 rays per (cell, azimuth),
horizon_comp.cpp:384-496).  Embree itself is not installable here, so
``horizon_rays`` measures an Embree-class scalar BVH tracer running the
same search on the same machine, and reports (horizon angles, rays shot,
build seconds, trace seconds).
"""

import ctypes
import os
import threading
import time

import numpy as np

from horayzon_tpu_torch.native.buildlib import NativeBuildError, ensure_built

__all__ = ["NativeBuildError", "get_lib", "horizon_rays"]

_LOCK = threading.Lock()
_LIB = None
_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "bvhbase.cpp")
_SO = os.path.join(_HERE, "_bvhbase.so")


def get_lib():
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        ensure_built(_SRC, _SO)
        lib = ctypes.CDLL(_SO)
        lib.bvh_build.restype = ctypes.c_void_p
        lib.bvh_build.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_long, ctypes.c_long,
            ctypes.c_double, ctypes.c_double]
        lib.bvh_free.restype = None
        lib.bvh_free.argtypes = [ctypes.c_void_p]
        lib.bvh_horizon.restype = ctypes.c_longlong
        lib.bvh_horizon.argtypes = [
            ctypes.c_void_p,
            ctypes.c_long, ctypes.c_long, ctypes.c_long, ctypes.c_long,
            ctypes.c_long, ctypes.c_double, ctypes.c_double,
            ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_int, ctypes.POINTER(ctypes.c_float)]
        _LIB = lib
        return _LIB


def horizon_rays(z, dx, dy, offset, inner_shape, azim_num, dist_search,
                 hori_acc=0.25, elev_lims=(-15.0, 89.98),
                 ray_org_elev=0.01, n_threads=0):
    """BVH-traced horizon with the reference's ray accounting.

    Returns ``(hori (in0, in1, A) float32 [radian], num_rays, build_s,
    trace_s)``.
    """
    lib = get_lib()
    z = np.ascontiguousarray(z, dtype=np.float32)
    h, w = z.shape
    in0, in1 = inner_shape
    t0 = time.perf_counter()
    handle = lib.bvh_build(
        z.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        h, w, float(dx), float(dy))
    build_s = time.perf_counter() - t0
    hori = np.empty((in0, in1, azim_num), dtype=np.float32)
    t0 = time.perf_counter()
    try:
        n_rays = lib.bvh_horizon(
            handle, int(offset[0]), int(offset[1]), in0, in1,
            int(azim_num), float(dist_search), float(hori_acc),
            float(elev_lims[0]), float(elev_lims[1]), float(ray_org_elev),
            int(n_threads),
            hori.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    finally:
        lib.bvh_free(handle)
    trace_s = time.perf_counter() - t0
    return hori, int(n_rays), build_s, trace_s
