"""The lon/lat scene of the curved SRTM Alps deployment (upstream
``examples/horizon/gridded_curved_DEM.py``): the 3-arcsec cell centres of
the SRTM tile that holds the domain, cropped to the outer domain as
``load_dem.srtm`` crops a tile (by cell edges), and heights of gaussian
bumps over it.

The bumps are the bump model of ``examples/torch/horizon/
gridded_curved_dem.py::synthetic_srtm_like`` at commit dae790f (centres
uniform over the axes' range, sigma and amplitude uniform in the
configuration's ranges), drawn from the seed and the DEM's number and
evaluated on the device in float64.

The scene: ``lon``, ``lat`` (float64 axes, lat descending), ``z`` the
(H, W) float32 heights on the device, ``domain`` the inner lon/lat
bounds, ``offset`` and ``inner_shape`` of the inner block as
``CurvedPipeline`` slices it, and the configuration's sweep settings.
"""

import numpy as np
import torch

from hzbench import scenes


def axes(cfg):
    """(lon, lat): the tile's cell centres inside the outer domain, the
    cells whose edges the domain's bounds fall between (``load_dem.
    _crop``)."""
    t, o = cfg["tile"], cfg["outer"]
    d = 1.0 / float(t["cells_per_degree"])

    def crop(ulc, step, lo, hi):
        edge = ulc + step * np.arange(int(t["cells"]) + 1)
        centre = edge[:-1] + np.diff(edge / 2.0)
        if step > 0:
            sl = slice(np.where(edge <= lo)[0][-1],
                       np.where(edge >= hi)[0][0])
        else:
            sl = slice(np.where(edge >= hi)[0][-1],
                       np.where(edge <= lo)[0][0])
        return centre[sl]

    return (crop(float(t["lon_ulc"]), d, o["lon_min"], o["lon_max"]),
            crop(float(t["lat_ulc"]), -d, o["lat_min"], o["lat_max"]))


def make(cfg, seed, device, dem=0):
    lon, lat = axes(cfg)
    dom = cfg["domain"]
    b = cfg["bumps"]
    rng = scenes.rng_for(seed, 0, dem)
    n = int(b["count"])
    c_lon = rng.uniform(lon.min(), lon.max(), n)
    c_lat = rng.uniform(lat.min(), lat.max(), n)
    sig = rng.uniform(*b["sigma_deg"], n)
    amp = rng.uniform(*b["amp_m"], n)
    lon_t = torch.as_tensor(lon, dtype=torch.float64, device=device)
    lat_t = torch.as_tensor(lat, dtype=torch.float64, device=device)
    z = torch.zeros((len(lat), len(lon)), dtype=torch.float64, device=device)
    for i in range(n):
        g_lon = torch.exp(-(lon_t - c_lon[i]) ** 2 / (2.0 * sig[i] ** 2))
        g_lat = torch.exp(-(lat_t - c_lat[i]) ** 2 / (2.0 * sig[i] ** 2))
        z.addr_(g_lat, g_lon, alpha=float(amp[i]))
    # the inner block as CurvedPipeline slices it
    r0 = int(np.where(lat >= dom["lat_max"])[0][-1])
    r1 = int(np.where(lat <= dom["lat_min"])[0][0]) + 1
    c0 = int(np.where(lon <= dom["lon_min"])[0][-1])
    c1 = int(np.where(lon >= dom["lon_max"])[0][0]) + 1
    return dict(z=z.to(torch.float32).contiguous(), lon=lon, lat=lat,
                domain=dict(dom), offset=(r0, c0),
                inner_shape=(r1 - r0, c1 - c0),
                dist_search_km=float(cfg["dist_search_km"]),
                dist_search_m=float(cfg["dist_search_km"]) * 1000.0,
                azim_num=int(cfg["azim_num"]),
                hori_acc=float(cfg["hori_acc"]),
                elev_ang_low_lim=float(cfg["elev_ang_low_lim"]),
                ellps=cfg["ellps"])
