# Copyright (c) 2026
# MIT License
"""Ellipsoid surface-normal and north direction vectors.

Copy of :mod:`horayzon_tpu.direction`, made because importing
``horayzon_tpu`` loads JAX; ``tests/test_torch_schedule.py`` holds the copy
equal to the original.  Equivalent of reference ``horayzon/direction.pyx``
(surf_norm direction.pyx:15, north_dir :75); vectorised NumPy float64 with
float32 outputs, matching the reference's precision contract.
"""

import numpy as np

from horayzon_tpu_torch.transform import ellipsoid_params, _check_ellps


def surf_norm(lon, lat):
    """Surface normal unit vectors (n-vector) in ECEF coordinates.

    Mirrors reference direction.pyx:15-70.

    Parameters
    ----------
    lon, lat : ndarray
        Geographic longitude / latitude [degree] (any shape).

    Returns
    -------
    vec_norm_ecef : ndarray of float32, shape ``lon.shape + (3,)``
    """
    lon = np.asarray(lon, dtype=np.float64)
    lat = np.asarray(lat, dtype=np.float64)
    if lon.shape != lat.shape:
        raise ValueError("Inconsistent shapes of input arrays")
    lon_r = np.deg2rad(lon)
    lat_r = np.deg2rad(lat)
    out = np.stack([np.cos(lat_r) * np.cos(lon_r),
                    np.cos(lat_r) * np.sin(lon_r),
                    np.sin(lat_r)], axis=-1)
    return out.astype(np.float32)


def north_dir(x_ecef, y_ecef, z_ecef, vec_norm_ecef, ellps):
    """Unit vectors pointing towards North, perpendicular to surface normals.

    Mirrors reference direction.pyx:75-178: the vector from the location to
    the (ellipsoidal) North Pole is projected onto the plane perpendicular to
    the surface normal and normalised.
    """
    x_ecef = np.asarray(x_ecef, dtype=np.float64)
    y_ecef = np.asarray(y_ecef, dtype=np.float64)
    z_ecef = np.asarray(z_ecef, dtype=np.float64)
    vec_norm_ecef = np.asarray(vec_norm_ecef)
    if ((x_ecef.shape != y_ecef.shape) or (y_ecef.shape != z_ecef.shape)
            or (z_ecef.shape != vec_norm_ecef.shape[:-1])):
        raise ValueError("Inconsistent shapes of input arrays")
    _check_ellps(ellps)
    _, b, _ = ellipsoid_params(ellps)
    vn = vec_norm_ecef.astype(np.float64)
    # Vector to the North Pole (0, 0, b)
    vec = np.stack([-x_ecef, -y_ecef, b - z_ecef], axis=-1)
    dot = np.sum(vec * vn, axis=-1, keepdims=True)
    proj = vec - dot * vn
    norm = np.linalg.norm(proj, axis=-1, keepdims=True)
    return (proj / norm).astype(np.float32)
