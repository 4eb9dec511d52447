# Copyright (c) 2026
# MIT License
"""Result writers: compressed .npz always, NetCDF when xarray is present.

Copy of :mod:`horayzon_tpu.utils.output` with its imports pointed at this
package (importing ``horayzon_tpu`` loads JAX);
``tests/test_torch_utils.py`` holds it equal to the original.

The reference writes Ncview-compatible NetCDF from every example
(e.g. examples/horizon/gridded_planar_DEM.py:88-103).  xarray/netCDF4 are
optional dependencies here; :func:`write_dataset` uses them when available
and otherwise falls back to ``.npz`` with the same variable names.
"""

import os

import numpy as np


def write_dataset(path, coords, data_vars, attrs=None):
    """Write a gridded dataset.

    Parameters
    ----------
    path : str
        Output path; extension decides the format (".nc" requires xarray,
        anything else is written as compressed npz).
    coords : dict name -> (dims tuple, 1-D array, attrs dict)
    data_vars : dict name -> (dims tuple, array, attrs dict)
    attrs : optional dict of global attributes.

    Returns the path actually written (``.nc`` falls back to ``.npz`` with
    a printed notice when no NetCDF backend is installed).
    """
    if path.endswith(".nc"):
        try:
            import xarray as xr
            ds = xr.Dataset(
                coords={k: (list(v[0]), np.asarray(v[1]), v[2] if
                            len(v) > 2 else {}) for k, v in coords.items()},
                data_vars={k: (list(v[0]), np.asarray(v[1]), v[2] if
                               len(v) > 2 else {})
                           for k, v in data_vars.items()},
                attrs=attrs or {})
            encoding = {k: {"_FillValue": None} for k in coords}
            ds.to_netcdf(path, encoding=encoding)
            return path
        except ImportError:
            alt = os.path.splitext(path)[0] + ".npz"
            print(f"xarray not installed; writing {alt} instead of {path}")
            path = alt
    payload = {k: np.asarray(v[1]) for k, v in coords.items()}
    payload.update({k: np.asarray(v[1]) for k, v in data_vars.items()})
    np.savez_compressed(path, **payload)
    return path


def write_horizon(path, hori, azim, x=None, y=None, lon=None, lat=None):
    """Write a horizon cube in the reference layout (azim, y, x)."""
    hori = np.asarray(hori)
    coords = {"azim": (("azim",), np.asarray(azim), {"units": "radian"})}
    if x is not None:
        coords["x"] = (("x",), np.asarray(x), {"units": "m"})
        coords["y"] = (("y",), np.asarray(y), {"units": "m"})
        dims = ("azim", "y", "x")
    else:
        coords["lon"] = (("lon",), np.asarray(lon), {"units": "degree"})
        coords["lat"] = (("lat",), np.asarray(lat), {"units": "degree"})
        dims = ("azim", "lat", "lon")
    data = {"horizon": (dims, np.moveaxis(hori, 2, 0),
                        {"units": "radian"})}
    return write_dataset(path, coords, data)
