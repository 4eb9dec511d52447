# Copyright (c) 2026
# MIT License
"""Solar ephemeris (no external dependency).

Copy of :mod:`horayzon_tpu.sun_position`, made because importing
``horayzon_tpu`` loads JAX; ``tests/test_torch_schedule.py`` holds the copy
equal to the original.  A built-in low-precision solar ephemeris (Meeus,
Astronomical Algorithms, ch. 25; accuracy ~0.01 degree, far below
terrain-shadow sensitivity) that yields the sun position in ECEF or local
ENU coordinates, ready for :class:`horayzon_tpu_torch.shadow.Terrain`.
"""

import datetime as _dt

import numpy as np

from horayzon_tpu_torch import transform as _transform

AU = 1.495978707e11  # astronomical unit [m]


def _to_datetime64(times):
    if isinstance(times, (list, tuple)):
        times = np.array([np.datetime64(t) for t in times])
    elif isinstance(times, (_dt.datetime, str)):
        times = np.array([np.datetime64(times)])
    elif isinstance(times, np.datetime64):
        times = np.array([times])
    return np.asarray(times, dtype="datetime64[s]")


def julian_day(times):
    """Julian day (UT1 ~= UTC) for datetime64 array."""
    times = _to_datetime64(times)
    epoch = np.datetime64("2000-01-01T12:00:00")
    return 2451545.0 + (times - epoch) / np.timedelta64(1, "D")


def sun_ecliptic(times):
    """Apparent ecliptic longitude [rad], distance [m], obliquity [rad]."""
    jd = julian_day(times)
    t = (jd - 2451545.0) / 36525.0
    # Geometric mean longitude and anomaly of the sun [deg]
    l0 = (280.46646 + 36000.76983 * t + 0.0003032 * t ** 2) % 360.0
    m = np.deg2rad((357.52911 + 35999.05029 * t - 0.0001537 * t ** 2)
                   % 360.0)
    e = 0.016708634 - 0.000042037 * t - 0.0000001267 * t ** 2
    c = ((1.914602 - 0.004817 * t - 0.000014 * t ** 2) * np.sin(m)
         + (0.019993 - 0.000101 * t) * np.sin(2 * m)
         + 0.000289 * np.sin(3 * m))
    true_lon = l0 + c
    nu = m + np.deg2rad(c)
    r = (1.000001018 * (1 - e ** 2)) / (1 + e * np.cos(nu)) * AU
    omega = np.deg2rad(125.04 - 1934.136 * t)
    app_lon = np.deg2rad(true_lon - 0.00569 - 0.00478 * np.sin(omega))
    eps0 = (23.0 + 26.0 / 60.0 + 21.448 / 3600.0
            - (46.8150 * t + 0.00059 * t ** 2 - 0.001813 * t ** 3) / 3600.0)
    eps = np.deg2rad(eps0 + 0.00256 * np.cos(omega))
    return app_lon, r, eps, jd


def sun_ra_dec(times):
    """Apparent right ascension / declination [rad] and distance [m]."""
    app_lon, r, eps, jd = sun_ecliptic(times)
    ra = np.arctan2(np.cos(eps) * np.sin(app_lon), np.cos(app_lon))
    dec = np.arcsin(np.sin(eps) * np.sin(app_lon))
    return ra, dec, r, jd


def greenwich_sidereal_angle(jd):
    """Greenwich mean sidereal angle [rad]."""
    t = (jd - 2451545.0) / 36525.0
    gmst = (280.46061837 + 360.98564736629 * (jd - 2451545.0)
            + 0.000387933 * t ** 2 - t ** 3 / 38710000.0)
    return np.deg2rad(gmst % 360.0)


def sun_position_ecef(times):
    """Sun position in ECEF coordinates [m] for UTC times; shape (T, 3)."""
    ra, dec, r, jd = sun_ra_dec(times)
    gha = greenwich_sidereal_angle(jd) - ra   # angle from Greenwich meridian
    x = r * np.cos(dec) * np.cos(-gha)
    y = r * np.cos(dec) * np.sin(-gha)
    z = r * np.sin(dec)
    return np.stack([x, y, z], axis=-1)


def sun_position_enu(times, trans_ecef2enu):
    """Sun position in local ENU coordinates [m] for UTC times; (T, 3).

    Drop-in for the Skyfield pipeline of the reference shadow examples:
    pass the result rows to Terrain.shadow / .sw_dir_cor (or the whole array
    to the ``*_batch`` variants)."""
    ecef = sun_position_ecef(times)
    x, y, z = _transform.ecef2enu(ecef[:, 0], ecef[:, 1], ecef[:, 2],
                                  trans_ecef2enu)
    return np.stack([x, y, z], axis=-1).astype(np.float32)


def sun_azimuth_elevation(times, lon, lat):
    """Topocentric solar azimuth (clockwise from N) / elevation [degree]."""
    ra, dec, r, jd = sun_ra_dec(times)
    lst = greenwich_sidereal_angle(jd) + np.deg2rad(lon)
    ha = lst - ra
    lat_r = np.deg2rad(lat)
    sin_el = (np.sin(lat_r) * np.sin(dec)
              + np.cos(lat_r) * np.cos(dec) * np.cos(ha))
    el = np.arcsin(np.clip(sin_el, -1.0, 1.0))
    az = np.arctan2(-np.sin(ha) * np.cos(dec),
                    np.sin(dec) * np.cos(lat_r)
                    - np.cos(dec) * np.sin(lat_r) * np.cos(ha))
    return np.rad2deg(az) % 360.0, np.rad2deg(el)


def sun_position_planar(azim_deg, elev_deg, dist=1.0e8):
    """Planar sun position from azimuth/elevation angles [degree].

    Matches the construction in the artificial-topography example
    (gridded_planar_DEM_artificial.py:150-153)."""
    az = np.deg2rad(np.asarray(azim_deg, dtype=np.float64))
    el = np.deg2rad(np.asarray(elev_deg, dtype=np.float64))
    x = dist * np.cos(el) * np.sin(az)
    y = dist * np.cos(el) * np.cos(az)
    z = dist * np.sin(el) * np.ones_like(x)
    return np.stack(np.broadcast_arrays(x, y, z), axis=-1).astype(np.float32)
