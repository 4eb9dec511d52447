# Copyright (c) 2026
# MIT License
"""Geoid undulation models (orthometric -> ellipsoidal height conversion).

Copy of :mod:`horayzon_tpu.geoid` with its imports pointed at this package
(importing ``horayzon_tpu`` loads JAX); ``tests/test_torch_host_modules.py``
holds it equal to the original.

Functional equivalent of the reference's geoid module
(``horayzon/geoid.py:16-129``), redesigned around a model registry: each
supported geoid is described by a :class:`GeoidModel` entry bundling its
spatial coverage with a loader that fetches + parses the published grid
into a :class:`GeoidGrid`.  Grids are kept in their *native* longitude
frame and queries are mapped into it (the EGM96 grid spans 0..360 deg
inclusive, so no seam handling is needed for queries in [-180, 180]);
interpolation is an in-house tensor-product bilinear sampler, so SciPy is
not required.

Supported models:

* ``EGM96``  — NGA 15-arcmin global grid (``WW15MGH.GRD``).
* ``GEOID12A`` — NGS 1-arcmin Alaska grid (``g2012aa0.asc.gz``).

Grid files are downloaded once into the user's aux-data directory and
reused afterwards.
"""

import dataclasses
import gzip
import os
import zipfile

import numpy as np

from horayzon_tpu_torch.auxiliary import get_path_aux_data
from horayzon_tpu_torch.download import file as _download_file


# ---------------------------------------------------------------------------
# Grid container + bilinear sampling
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GeoidGrid:
    """A regular lat/lon undulation grid (axes strictly ascending)."""
    lat: np.ndarray       # (NL,) degrees, ascending
    lon: np.ndarray       # (NC,) degrees, ascending (native frame)
    values: np.ndarray    # (NL, NC) undulation [m]

    def sample(self, lon_q, lat_q):
        """Bilinear undulation on the tensor grid ``lat_q x lon_q``.

        Queries may be in any order (each query point is located with a
        binary search on the ascending grid axes)."""
        i, wi = _bracket(self.lat, lat_q)
        j, wj = _bracket(self.lon, lon_q)
        g = self.values
        lo = (1.0 - wj) * g[np.ix_(i, j)] + wj * g[np.ix_(i, j + 1)]
        hi = (1.0 - wj) * g[np.ix_(i + 1, j)] + wj * g[np.ix_(i + 1, j + 1)]
        return (1.0 - wi)[:, None] * lo + wi[:, None] * hi


def _bracket(axis, q):
    """Lower bracket index and linear weight of each query on an
    ascending axis (clamped to the axis ends)."""
    idx = np.clip(np.searchsorted(axis, q) - 1, 0, len(axis) - 2)
    span = axis[idx + 1] - axis[idx]
    w = np.clip((np.asarray(q, dtype=np.float64) - axis[idx]) / span,
                0.0, 1.0)
    return idx, w


# ---------------------------------------------------------------------------
# Model loaders
# ---------------------------------------------------------------------------

def _cache_dir(name):
    d = os.path.join(get_path_aux_data(), name)
    return d + os.sep if not d.endswith(os.sep) else d


def _load_egm96():
    """EGM96: 15-arcmin global grid, rows from N to S, columns 0..360 deg
    (both ends inclusive).  Published as a zip holding ``WW15MGH.GRD``
    (ASCII: 6 header values, then row-major undulations)."""
    cache = _cache_dir("EGM96")
    grd = os.path.join(cache, "WW15MGH.GRD")
    if not os.path.isfile(grd):
        os.makedirs(cache, exist_ok=True)
        url = ("https://earth-info.nga.mil/php/"
               "download.php?file=egm-96interpolation")
        print("Download EGM96 data:")
        _download_file(url, cache)
        archive = os.path.join(cache, url.rsplit("/", 1)[-1])
        with zipfile.ZipFile(archive) as zf:
            zf.extractall(cache)
        os.remove(archive)
    raw = np.fromfile(grd, sep=" ", dtype=np.float64)
    vals = raw[6:]                       # skip the 6-value header
    n_lat = 721                          # 90..-90 at 0.25 deg
    n_lon = 1441                         # 0..360 at 0.25 deg
    grid = vals.reshape(n_lat, n_lon)[::-1]   # store south-to-north
    return GeoidGrid(
        lat=np.linspace(-90.0, 90.0, n_lat),
        lon=np.linspace(0.0, 360.0, n_lon),
        values=np.ascontiguousarray(grid))


def _load_geoid12a():
    """GEOID12A: 1-arcmin Alaska grid.  ASCII (gzip): 7 header values,
    then 1381 x 3721 undulations from the grid origin lat 49 N,
    lon -188 deg (= 172 E in the negative-west frame)."""
    cache = _cache_dir("GEOID12A")
    asc = os.path.join(cache, "g2012aa0.asc.gz")
    if not os.path.isfile(asc):
        os.makedirs(cache, exist_ok=True)
        url = ("https://www.ngs.noaa.gov/PC_PROD/GEOID12A/"
               "Format_ascii/g2012aa0.asc.gz")
        print("Download GEOID12A data:")
        _download_file(url, cache)
    with gzip.open(asc, "rt") as fh:
        raw = np.array(fh.read().split(), dtype=np.float64)
    vals = raw[7:]                       # skip the 7-value header
    n_lat, n_lon = 1381, 3721
    spacing = 1.0 / 60.0
    return GeoidGrid(
        lat=49.0 + spacing * np.arange(n_lat),
        lon=-188.0 + spacing * np.arange(n_lon),
        values=vals.reshape(n_lat, n_lon))


@dataclasses.dataclass(frozen=True)
class GeoidModel:
    """Registry entry: query-frame coverage + grid loader + the mapping of
    query longitudes into the stored grid's native frame."""
    coverage: tuple              # (lon_min, lon_max, lat_min, lat_max)
    load: callable
    to_native_lon: callable = staticmethod(lambda lon: lon)


_MODELS = {
    # EGM96 grid is stored 0..360: wrap western longitudes up
    "EGM96": GeoidModel(
        coverage=(-180.0, 180.0, -90.0, 90.0),
        load=_load_egm96,
        to_native_lon=lambda lon: np.mod(lon, 360.0)),
    "GEOID12A": GeoidModel(
        coverage=(-180.0, -126.0, 49.0, 72.0),
        load=_load_geoid12a),
}

_GRID_CACHE = {}


def undulation(lon_ip, lat_ip, geoid="EGM96"):
    """Geoid undulation [m] on the tensor grid ``lat_ip x lon_ip``.

    Behavioural equivalent of reference geoid.py:16-129: the selected
    model's grid is downloaded on first use, then bilinearly interpolated
    to the requested axes.  Heights convert as
    ``h_ellipsoid = h_orthometric + undulation``.

    Parameters
    ----------
    lon_ip : (NC,) array of float — longitudes [deg], ascending.
    lat_ip : (NL,) array of float — latitudes [deg], monotonic.
    geoid : "EGM96" or "GEOID12A"

    Returns
    -------
    (NL, NC) float64 undulation, ordered like the input axes.
    """
    lon_ip = np.atleast_1d(np.asarray(lon_ip, dtype=np.float64))
    lat_ip = np.atleast_1d(np.asarray(lat_ip, dtype=np.float64))
    model = _MODELS.get(geoid)
    if model is None:
        raise NotImplementedError("geoid " + str(geoid)
                                  + " is not supported")
    lon_min, lon_max, lat_min, lat_max = model.coverage
    if (lon_ip.min() < lon_min or lon_ip.max() > lon_max
            or lat_ip.min() < lat_min or lat_ip.max() > lat_max):
        raise ValueError("selected domain exceeds spatial coverage")
    if lon_ip.size > 1 and not (np.diff(lon_ip) > 0.0).all():
        raise ValueError("longitude values are not monotonically increasing")
    d_lat = np.diff(lat_ip)
    if lat_ip.size > 1 and not ((d_lat > 0.0).all() or (d_lat < 0.0).all()):
        raise ValueError("latitude values are not monotonic")

    if geoid not in _GRID_CACHE:
        _GRID_CACHE[geoid] = model.load()
    grid = _GRID_CACHE[geoid]
    # The sampler brackets each query independently, so descending
    # latitude axes need no flip/unflip bookkeeping.
    return grid.sample(model.to_native_lon(lon_ip), lat_ip)
