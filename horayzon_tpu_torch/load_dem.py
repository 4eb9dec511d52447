# Copyright (c) 2026
# MIT License
"""DEM product loaders (SRTM, NASADEM, DHM25, swissALTI3D, REMA).

Copy of :mod:`horayzon_tpu.load_dem` with its imports pointed at this
package (importing ``horayzon_tpu`` loads JAX);
``tests/test_torch_host_modules.py`` holds it equal to the original.

Equivalent of reference ``horayzon/load_dem.py`` (srtm load_dem.py:14,
nasadem :95, dhm25 :152, swissalti3d :243, rema :351, print_dem_info :431).
All loaders return ``(x_or_lon, y_or_lat, elevation)`` with cell-centre
coordinates and crop to the requested (outer) domain using cell-edge
comparisons, like the reference.

Backends: GeoTIFF files are read with Pillow by default (with GDAL as an
optional engine if installed); ESRI ASCII grids with NumPy (a native C++
fast parser is used automatically when built, see
:mod:`horayzon_tpu_torch.native`); NASADEM NetCDF tiles require ``xarray`` or
``netCDF4`` (optional dependencies).
"""

import glob
import os
from importlib import import_module

import numpy as np


# ---------------------------------------------------------------------------
# Shared raster helpers
# ---------------------------------------------------------------------------

def _read_geotiff(file_dem, engine):
    """Read a single-band GeoTIFF; return (elevation, x_ulc, y_ulc, dx, dy).

    ``dy`` is negative (north-up raster).  Mirrors the tag handling of
    reference load_dem.py:48-67."""
    if engine == "gdal":
        gdal = import_module("osgeo.gdal")
        ds = gdal.Open(file_dem)
        elevation = ds.GetRasterBand(1).ReadAsArray()
        nx, ny = ds.RasterXSize, ds.RasterYSize
        gt = ds.GetGeoTransform()
        return elevation, nx, ny, gt[0], gt[3], gt[1], gt[5]
    Image = import_module("PIL.Image")
    Image.MAX_IMAGE_PIXELS = 1300000000
    img = Image.open(file_dem)
    elevation = np.array(img)
    nx, ny = img.tag[256][0], img.tag[257][0]
    x_ulc, y_ulc = img.tag[33922][3], img.tag[33922][4]
    d_x, d_y = img.tag[33550][0], -img.tag[33550][1]
    return elevation, nx, ny, x_ulc, y_ulc, d_x, d_y


def _edges_and_centres(ulc, d, n):
    edge = np.linspace(ulc, ulc + d * n, n + 1)
    centre = edge[:-1] + np.diff(edge / 2.0)
    return edge, centre


def _crop(elevation, x_edge, y_edge, x, y, x_min, x_max, y_min, y_max,
          check_cover=True):
    """Crop to the domain using cell-edge comparisons
    (reference load_dem.py:77-90)."""
    if check_cover and any([x_min < x_edge.min(), x_max > x_edge.max(),
                            y_min < y_edge.min(), y_max > y_edge.max()]):
        raise ValueError("Provided tile does not cover domain")
    slice_x = slice(np.where(x_edge <= x_min)[0][-1],
                    np.where(x_edge >= x_max)[0][0])
    slice_y = slice(np.where(y_edge >= y_max)[0][-1],
                    np.where(y_edge <= y_min)[0][0])
    return (elevation[slice_y, slice_x], x[slice_x], y[slice_y])


# ---------------------------------------------------------------------------
# Product loaders
# ---------------------------------------------------------------------------

def srtm(file_dem, domain, engine="pillow"):
    """Load SRTM data from a single GeoTIFF (reference load_dem.py:14-92).

    Returns (lon, lat, elevation [float32, metre])."""
    if engine not in ("gdal", "pillow"):
        raise ValueError("Input for 'engine' must be either 'gdal' or "
                         "'pillow'")
    elevation, nx, ny, lon_ulc, lat_ulc, d_lon, d_lat = _read_geotiff(
        file_dem, engine)
    lon_edge, lon = _edges_and_centres(lon_ulc, d_lon, nx)
    lat_edge, lat = _edges_and_centres(lat_ulc, d_lat, ny)
    elevation, lon, lat = _crop(
        elevation, lon_edge, lat_edge, lon, lat,
        domain["lon_min"], domain["lon_max"],
        domain["lat_min"], domain["lat_max"])
    elevation = elevation.astype(np.float32)
    print_dem_info(elevation)
    return lon, lat, elevation


#: NASADEM tile core size: each 1-degree tile carries 3600 cells per axis
#: plus one margin sample duplicated with the neighbouring tile.
_NASADEM_TILE_CELLS = 3600


def _centre_slices(x, y, x_min, x_max, y_min, y_max):
    """Index slices keeping the cell CENTRES inside the closed domain
    interval (for mosaics that carry centre coordinates only, e.g. the
    NASADEM NetCDF tiles).  The domain must lie strictly inside the
    mosaic's centre extent; both axes may be ascending or descending."""
    if not (x.min() < x_min and x_max < x.max()
            and y.min() < y_min and y_max < y.max()):
        raise ValueError("Provided tile(s) does/do not cover domain")
    ix = np.flatnonzero((x >= x_min) & (x <= x_max))
    iy = np.flatnonzero((y >= y_min) & (y <= y_max))
    if ix.size == 0 or iy.size == 0:
        raise ValueError(
            "domain interval contains no cell centre on the "
            f"{'lon' if ix.size == 0 else 'lat'} axis — widen the domain "
            "beyond one cell spacing")
    return slice(ix[0], ix[-1] + 1), slice(iy[0], iy[-1] + 1)


def _crop_centres(elevation, x, y, x_min, x_max, y_min, y_max):
    """Crop a raster to the domain via :func:`_centre_slices`."""
    sl_x, sl_y = _centre_slices(x, y, x_min, x_max, y_min, y_max)
    return elevation[sl_y, sl_x], x[sl_x], y[sl_y]


def preprocess(ds):
    """Trim the margin sample a NASADEM tile shares with its neighbour.

    Tiles are ``_NASADEM_TILE_CELLS`` cells per axis plus one duplicated
    edge sample (cf. reference load_dem.py:144-147); dropping the trailing
    sample of any axis that has it leaves the multi-file mosaic with
    unique coordinates.  Passed as the ``preprocess=`` hook to xarray's
    ``open_mfdataset`` (public for callers composing their own open)."""
    trim = {}
    for axis in ("lon", "lat"):
        n = int(ds.sizes.get(axis, 0))
        if n % _NASADEM_TILE_CELLS == 1:
            trim[axis] = slice(0, n - 1)
    return ds.isel(**trim) if trim else ds


def nasadem(files_dem, domain):
    """Load NASADEM data from (multiple) NetCDF file(s)
    (reference load_dem.py:95-149).

    Tiles are margin-trimmed (:func:`preprocess`), merged into one mosaic
    and centre-cropped to the domain (:func:`_crop_centres`).  Requires
    the optional dependency ``xarray`` (with a NetCDF backend)."""
    try:
        xr = import_module("xarray")
    except ImportError as exc:
        raise ImportError(
            "NASADEM loading requires the optional dependency 'xarray' "
            "(with a NetCDF backend)") from exc
    with xr.open_mfdataset(files_dem, preprocess=preprocess) as ds:
        lon_all = ds["lon"].values
        lat_all = ds["lat"].values
        sl_x, sl_y = _centre_slices(
            lon_all, lat_all,
            domain["lon_min"], domain["lon_max"],
            domain["lat_min"], domain["lat_max"])
        # Slice the lazy mosaic BEFORE reading values so only the cropped
        # window is materialised (a large multi-tile mosaic read whole can
        # be GBs while the domain needs a fraction of it).
        elevation = ds["NASADEM_HGT"].isel(lat=sl_y, lon=sl_x).values
        lon = lon_all[sl_x]
        lat = lat_all[sl_y]
    print_dem_info(elevation)
    return lon, lat, elevation


def read_esri_ascii_header(file_dem):
    """Parse the 5/6-line ESRI ASCII GRID header."""
    header = {}
    with open(file_dem) as fh:
        for _ in range(6):
            parts = fh.readline().split()
            if len(parts) != 2:
                break
            key = parts[0].lower()
            if key in ("ncols", "nrows"):
                header[key] = int(parts[1])
            else:
                try:
                    header[key] = float(parts[1])
                except ValueError:
                    break
    return header


def dhm25(file_dem, domain, engine="numpy"):
    """Load DHM25 data from an ESRI ASCII GRID file
    (reference load_dem.py:152-239).

    Returns (x, y, elevation) with -9999 converted to NaN."""
    if engine not in ("gdal", "numpy"):
        raise ValueError("Input for 'engine' must be either 'gdal' or "
                         "'numpy'")
    if engine == "gdal":
        gdal = import_module("osgeo.gdal")
        ds = gdal.Open(file_dem)
        elevation = ds.GetRasterBand(1).ReadAsArray()
        nx, ny = ds.RasterXSize, ds.RasterYSize
        gt = ds.GetGeoTransform()
        x_ulc, y_ulc, d_x, d_y = gt[0], gt[3], gt[1], gt[5]
    else:
        header = read_esri_ascii_header(file_dem)
        skip = 6 if "nodata_value" in header else 5
        try:
            from horayzon_tpu_torch.native import fastdem
            elevation = fastdem.load_esri_ascii(file_dem, skip)
            elevation = elevation.reshape(header["nrows"], header["ncols"])
        except Exception:
            elevation = np.loadtxt(file_dem, skiprows=skip, dtype=np.float32)
        nx, ny = header["ncols"], header["nrows"]
        x_ulc = header["xllcorner"]
        y_ulc = header["yllcorner"] + header["nrows"] * header["cellsize"]
        d_x, d_y = header["cellsize"], -header["cellsize"]
    x_edge, x = _edges_and_centres(x_ulc, d_x, nx)
    y_edge, y = _edges_and_centres(y_ulc, d_y, ny)
    x = x.astype(np.float32)
    y = y.astype(np.float32)
    elevation, x, y = _crop(elevation, x_edge, y_edge, x, y,
                            domain["x_min"], domain["x_max"],
                            domain["y_min"], domain["y_max"])
    elevation = np.ascontiguousarray(elevation.astype(np.float32))
    elevation[elevation == -9999.0] = np.nan
    print_dem_info(elevation)
    return x, y, elevation


def swissalti3d(path_dem, domain, engine="pillow"):
    """Load swissALTI3D 2 m data from a 1 km tile mosaic
    (reference load_dem.py:243-348).

    Returns (x, y, elevation) in LV95 coordinates."""
    if engine not in ("gdal", "pillow"):
        raise ValueError("Input for 'engine' must be either 'gdal' or "
                         "'pillow'")
    tiles_gc = 500  # grid cells per 1 km tile
    file_format = "swissalti3d_????_eeee-nnnn_2_2056_5728.tif"
    tiles_east = list(range(int(np.floor(domain["x_min"] / 1000)),
                            int(np.ceil(domain["x_max"] / 1000))))
    tiles_north = list(range(int(np.floor(domain["y_min"] / 1000)),
                             int(np.ceil(domain["y_max"] / 1000))))[::-1]
    if engine == "gdal":
        gdal = import_module("osgeo.gdal")
    else:
        Image = import_module("PIL.Image")
    elevation = np.full((len(tiles_north) * tiles_gc,
                         len(tiles_east) * tiles_gc), np.nan,
                        dtype=np.float32)
    count = 0
    num_tiles = len(tiles_north) * len(tiles_east)
    for i in tiles_north:
        for j in tiles_east:
            pattern = (os.path.join(path_dem, file_format)
                       .replace("eeee", str(j)).replace("nnnn", str(i)))
            found = glob.glob(pattern)
            if len(found) == 0:
                print(f"Warning: no tile found for e{j}n{i}")
            else:
                slic = (slice((tiles_north[0] - i) * tiles_gc,
                              (tiles_north[0] - i + 1) * tiles_gc),
                        slice((j - tiles_east[0]) * tiles_gc,
                              (j - tiles_east[0] + 1) * tiles_gc))
                if engine == "gdal":
                    ds = gdal.Open(found[0])
                    elevation[slic] = ds.GetRasterBand(1).ReadAsArray()
                else:
                    elevation[slic] = np.array(Image.open(found[0]))
            count += 1
            if (count == 1) or (count % 200 == 0) or (count == num_tiles):
                print(f"Tiles imported: {count} of {num_tiles}")

    d_x, d_y = 2.0, -2.0
    x_edge, x = _edges_and_centres(tiles_east[0] * 1000.0, d_x,
                                   elevation.shape[1])
    y_edge, y = _edges_and_centres((tiles_north[0] + 1) * 1000.0, d_y,
                                   elevation.shape[0])
    x = x.astype(np.float32)
    y = y.astype(np.float32)
    elevation, x, y = _crop(elevation, x_edge, y_edge, x, y,
                            domain["x_min"], domain["x_max"],
                            domain["y_min"], domain["y_max"],
                            check_cover=False)
    print_dem_info(elevation)
    return x, y, elevation


def rema(file_dem, domain, engine="pillow"):
    """Load REMA (Antarctica) data from a single GeoTIFF
    (reference load_dem.py:351-428).

    Returns (x, y, elevation) in EPSG:3031 coordinates."""
    if engine not in ("gdal", "pillow"):
        raise ValueError("Input for 'engine' must be either 'gdal' or "
                         "'pillow'")
    elevation, nx, ny, x_ulc, y_ulc, d_x, d_y = _read_geotiff(file_dem,
                                                              engine)
    x_edge, x = _edges_and_centres(x_ulc, d_x, nx)
    y_edge, y = _edges_and_centres(y_ulc, d_y, ny)
    elevation, x, y = _crop(elevation, x_edge, y_edge, x, y,
                            domain["x_min"], domain["x_max"],
                            domain["y_min"], domain["y_max"])
    elevation = elevation.astype(np.float32)
    print_dem_info(elevation)
    return x, y, elevation


def print_dem_info(elevation):
    """Print DEM size / elevation range (reference load_dem.py:431-444)."""
    print("Size of loaded DEM domain: " + str(elevation.shape))
    txt = ("Elevation range of DEM: %.1f" % np.nanmin(elevation)
           + " - %.1f" % np.nanmax(elevation) + " m")
    if np.any(np.isnan(elevation)):
        txt += " (Warning: NaN values are present)"
    print(txt)
