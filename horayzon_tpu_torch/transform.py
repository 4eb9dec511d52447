# Copyright (c) 2026
# MIT License
"""Coordinate transformations (host-side, vectorised float64).

Copy of :mod:`horayzon_tpu.transform`, made because importing
``horayzon_tpu`` loads JAX; ``tests/test_torch_schedule.py`` holds the copy
equal to the original.  The reference symbols: lonlat2ecef
transform.pyx:15, ecef2enu :108, ecef2enu_vector :194, wgs2swiss :266,
swiss2wgs :349, TransformerEcef2enu :438, rotation_matrix_glob2loc :490.

These run once per dataset at preparation time, as vectorised NumPy in
float64 (the reference likewise computes in ``double`` and casts outputs to
float32 where appropriate); float32 precision would lose ~1 m at ECEF
magnitudes, so there are no torch variants.
"""

import numpy as np

# Ellipsoid parameters (PROJ values, as in reference transform.pyx:76-93)
_SPHERE_R = 6370997.0
_A = 6378137.0
_F = {"GRS80": 1.0 / 298.257222101, "WGS84": 1.0 / 298.257223563}


def _check_ellps(ellps):
    if ellps not in ("sphere", "GRS80", "WGS84"):
        raise ValueError("Unknown value for 'ellps'")


def ellipsoid_params(ellps):
    """Return (a, b, e^2) for the selected Earth approximation."""
    _check_ellps(ellps)
    if ellps == "sphere":
        return _SPHERE_R, _SPHERE_R, 0.0
    a = _A
    b = a * (1.0 - _F[ellps])
    e_2 = 1.0 - (b ** 2 / a ** 2)
    return a, b, e_2


def lonlat2ecef(lon, lat, h, ellps):
    """Geodetic lon/lat/h -> earth-centered earth-fixed (ECEF) coordinates.

    Mirrors reference transform.pyx:15-103 (sphere / GRS80 / WGS84).

    Parameters
    ----------
    lon, lat : ndarray
        Geographic longitude / latitude [degree] (any shape).
    h : ndarray
        Elevation above the ellipsoid [metre] (same shape).
    ellps : str
        "sphere", "GRS80" or "WGS84".

    Returns
    -------
    x_ecef, y_ecef, z_ecef : ndarray of float64 [metre]
    """
    lon = np.asarray(lon, dtype=np.float64)
    lat = np.asarray(lat, dtype=np.float64)
    h = np.asarray(h)
    if (lon.shape != lat.shape) or (lat.shape != h.shape):
        raise ValueError("Inconsistent shapes of input arrays")
    _check_ellps(ellps)
    lon_r = np.deg2rad(lon)
    lat_r = np.deg2rad(lat)
    if ellps == "sphere":
        r = _SPHERE_R + h
        x = r * np.cos(lat_r) * np.cos(lon_r)
        y = r * np.cos(lat_r) * np.sin(lon_r)
        z = r * np.sin(lat_r)
    else:
        a, b, e_2 = ellipsoid_params(ellps)
        n = a / np.sqrt(1.0 - e_2 * np.sin(lat_r) ** 2)
        x = (n + h) * np.cos(lat_r) * np.cos(lon_r)
        y = (n + h) * np.cos(lat_r) * np.sin(lon_r)
        z = (b ** 2 / a ** 2 * n + h) * np.sin(lat_r)
    return x, y, z


class TransformerEcef2enu:
    """Stores the ENU origin for ECEF <-> ENU transformations.

    Mirrors reference transform.pyx:438-485.  The ENU origin lies on the
    surface of the sphere/ellipsoid at (lon_or, lat_or).
    """

    def __init__(self, lon_or, lat_or, ellps):
        if (lon_or < -180.0) or (lon_or > 180.0):
            raise ValueError("Value for 'lon_or' is outside of valid range")
        if (lat_or < -90.0) or (lat_or > 90.0):
            raise ValueError("Value for 'lat_or' is outside of valid range")
        _check_ellps(ellps)
        self.lon_or = float(lon_or)
        self.lat_or = float(lat_or)
        self.ellps = ellps
        x, y, z = lonlat2ecef(np.array(lon_or), np.array(lat_or),
                              np.array(0.0, dtype=np.float32), ellps)
        self.x_ecef_or = float(x)
        self.y_ecef_or = float(y)
        self.z_ecef_or = float(z)


def ecef2enu(x_ecef, y_ecef, z_ecef, trans_ecef2enu):
    """ECEF -> local tangent plane (ENU) coordinates (float32 output).

    Mirrors reference transform.pyx:108-189: double-precision subtraction of
    the ENU origin followed by rotation; outputs cast to float32.
    """
    if not isinstance(trans_ecef2enu, TransformerEcef2enu):
        raise ValueError("Last input argument must be instance of class "
                         "'TransformerEcef2enu'")
    x_ecef = np.asarray(x_ecef, dtype=np.float64)
    y_ecef = np.asarray(y_ecef, dtype=np.float64)
    z_ecef = np.asarray(z_ecef, dtype=np.float64)
    if (x_ecef.shape != y_ecef.shape) or (y_ecef.shape != z_ecef.shape):
        raise ValueError("Inconsistent shapes of input arrays")
    t = trans_ecef2enu
    sin_lon, cos_lon = np.sin(np.deg2rad(t.lon_or)), np.cos(np.deg2rad(t.lon_or))
    sin_lat, cos_lat = np.sin(np.deg2rad(t.lat_or)), np.cos(np.deg2rad(t.lat_or))
    dx = x_ecef - t.x_ecef_or
    dy = y_ecef - t.y_ecef_or
    dz = z_ecef - t.z_ecef_or
    x_enu = (-sin_lon * dx + cos_lon * dy).astype(np.float32)
    y_enu = (-sin_lat * cos_lon * dx - sin_lat * sin_lon * dy
             + cos_lat * dz).astype(np.float32)
    z_enu = (+cos_lat * cos_lon * dx + cos_lat * sin_lon * dy
             + sin_lat * dz).astype(np.float32)
    return x_enu, y_enu, z_enu


def enu2ecef(x_enu, y_enu, z_enu, trans_ecef2enu):
    """Inverse of :func:`ecef2enu` (float64 output; new in this framework)."""
    if not isinstance(trans_ecef2enu, TransformerEcef2enu):
        raise ValueError("Last input argument must be instance of class "
                         "'TransformerEcef2enu'")
    t = trans_ecef2enu
    sin_lon, cos_lon = np.sin(np.deg2rad(t.lon_or)), np.cos(np.deg2rad(t.lon_or))
    sin_lat, cos_lat = np.sin(np.deg2rad(t.lat_or)), np.cos(np.deg2rad(t.lat_or))
    x_enu = np.asarray(x_enu, dtype=np.float64)
    y_enu = np.asarray(y_enu, dtype=np.float64)
    z_enu = np.asarray(z_enu, dtype=np.float64)
    x = (-sin_lon * x_enu - sin_lat * cos_lon * y_enu
         + cos_lat * cos_lon * z_enu) + t.x_ecef_or
    y = (+cos_lon * x_enu - sin_lat * sin_lon * y_enu
         + cos_lat * sin_lon * z_enu) + t.y_ecef_or
    z = (cos_lat * y_enu + sin_lat * z_enu) + t.z_ecef_or
    return x, y, z


def ecef2enu_vector(vec_ecef, trans_ecef2enu):
    """Rotate vectors from ECEF to ENU (no translation).

    Mirrors reference transform.pyx:194-261.  ``vec_ecef`` has vector
    components in the last dimension.
    """
    vec_ecef = np.asarray(vec_ecef)
    if (vec_ecef.ndim < 2) or (vec_ecef.shape[-1] != 3):
        raise ValueError("Incorrect shape of input array")
    if not isinstance(trans_ecef2enu, TransformerEcef2enu):
        raise ValueError("Last input argument must be instance of class "
                         "'TransformerEcef2enu'")
    t = trans_ecef2enu
    sin_lon, cos_lon = np.sin(np.deg2rad(t.lon_or)), np.cos(np.deg2rad(t.lon_or))
    sin_lat, cos_lat = np.sin(np.deg2rad(t.lat_or)), np.cos(np.deg2rad(t.lat_or))
    rot = np.array([[-sin_lon, cos_lon, 0.0],
                    [-sin_lat * cos_lon, -sin_lat * sin_lon, cos_lat],
                    [cos_lat * cos_lon, cos_lat * sin_lon, sin_lat]],
                   dtype=np.float64)
    out = vec_ecef.astype(np.float64) @ rot.T
    return out.astype(np.float32)


def wgs2swiss(lon, lat, h_wgs):
    """Ellipsoidal WGS84 -> Swiss LV95 projection coordinates (approximate).

    Mirrors reference transform.pyx:266-344 (swisstopo approximate formulas).
    """
    lon = np.asarray(lon, dtype=np.float64)
    lat = np.asarray(lat, dtype=np.float64)
    h_wgs = np.asarray(h_wgs)
    if (lon.shape != lat.shape) or (lat.shape != h_wgs.shape):
        raise ValueError("Inconsistent shapes of input arrays")
    lon_pr = ((lon * 3600.0) - 26782.5) / 10000.0
    lat_pr = ((lat * 3600.0) - 169028.66) / 10000.0
    e = (2600072.37
         + 211455.93 * lon_pr
         - 10938.51 * lon_pr * lat_pr
         - 0.36 * lon_pr * lat_pr ** 2
         - 44.54 * lon_pr ** 3)
    n = (1200147.07
         + 308807.95 * lat_pr
         + 3745.25 * lon_pr ** 2
         + 76.63 * lat_pr ** 2
         - 194.56 * lon_pr ** 2 * lat_pr
         + 119.79 * lat_pr ** 3)
    h_ch = (h_wgs - 49.55 + 2.73 * lon_pr + 6.94 * lat_pr).astype(np.float32)
    return e, n, h_ch


def swiss2wgs(e, n, h_ch):
    """Swiss LV95 -> ellipsoidal WGS84 coordinates (approximate).

    Mirrors reference transform.pyx:349-433.
    """
    e = np.asarray(e, dtype=np.float64)
    n = np.asarray(n, dtype=np.float64)
    h_ch = np.asarray(h_ch)
    if (e.shape != n.shape) or (n.shape != h_ch.shape):
        raise ValueError("Inconsistent shapes of input arrays")
    e_pr = (e - 2600000.0) / 1000000.0
    n_pr = (n - 1200000.0) / 1000000.0
    lon = (2.6779094
           + 4.728982 * e_pr
           + 0.791484 * e_pr * n_pr
           + 0.1306 * e_pr * n_pr ** 2
           - 0.0436 * e_pr ** 3) * (100.0 / 36.0)
    lat = (16.9023892
           + 3.238272 * n_pr
           - 0.270978 * e_pr ** 2
           - 0.002528 * n_pr ** 2
           - 0.0447 * e_pr ** 2 * n_pr
           - 0.0140 * n_pr ** 3) * (100.0 / 36.0)
    h_wgs = (h_ch + 49.55 - 12.60 * e_pr - 22.64 * n_pr).astype(np.float32)
    return lon, lat, h_wgs


def rotation_matrix_glob2loc(vec_north_enu, vec_norm_enu):
    """Per-cell rotation matrices from global to local ENU coordinates.

    Mirrors reference transform.pyx:490-530: rows are (east, north, norm);
    the output is padded by one NaN-filled cell on each side so its shape
    matches the slope-computation domain.
    """
    vec_north_enu = np.asarray(vec_north_enu)
    vec_norm_enu = np.asarray(vec_norm_enu)
    if vec_north_enu.shape != vec_norm_enu.shape:
        raise ValueError("Inconsistent shapes of input arrays")
    rot = np.full((vec_north_enu.shape[0] + 2, vec_north_enu.shape[1] + 2,
                   3, 3), np.nan, dtype=np.float32)
    rot[1:-1, 1:-1, 0, :] = np.cross(vec_north_enu, vec_norm_enu,
                                     axisa=2, axisb=2)
    rot[1:-1, 1:-1, 1, :] = vec_north_enu
    rot[1:-1, 1:-1, 2, :] = vec_norm_enu
    return rot
