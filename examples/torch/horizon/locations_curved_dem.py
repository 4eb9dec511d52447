# Description: Compute terrain horizon (and distance to the horizon) for
#              arbitrary point locations — the PyTorch / CUDA port of
#              examples/horizon/locations_curved_dem.py, on the card by
#              default (the per-location sweep, plain torch as the
#              reference runs it in XLA).
#
# Copyright (c) 2026
# MIT License

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
import common  # noqa: E402  (puts the repository root on sys.path)

import numpy as np  # noqa: E402

import horayzon_tpu_torch as hray  # noqa: E402
from horayzon_tpu_torch import direction, transform  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dist-search", type=float, default=20.0)
    ap.add_argument("--azim-num", type=int, default=360)
    ap.add_argument("--plot", action="store_true",
                    help="render reference-style matplotlib figures")
    common.add_common_args(ap)
    args = ap.parse_args()
    dev = common.device(args.device)
    os.makedirs(args.out, exist_ok=True)

    # Synthetic curved terrain around a reference point; the reference uses
    # SRTM around four Swiss locations (locations_curved_DEM.py:30-36)
    locations = {
        "peak": (8.005, 46.505),
        "valley": (7.95, 46.45),
        "ridge": (8.06, 46.56),
    }
    lon0, lat0 = 8.0, 46.5
    n, dlat = 700, 0.0012
    lat = lat0 + (np.arange(n)[::-1] - n / 2) * dlat
    lon = lon0 + (np.arange(n) - n / 2) * dlat
    lon2, lat2 = np.meshgrid(lon, lat)
    rng = np.random.default_rng(1)
    elevation = np.zeros_like(lon2)
    for _ in range(25):
        clon = rng.uniform(lon.min(), lon.max())
        clat = rng.uniform(lat.min(), lat.max())
        sig = rng.uniform(0.01, 0.06)
        elevation += rng.uniform(300, 2000) * np.exp(
            -(((lon2 - clon) ** 2 + (lat2 - clat) ** 2) / (2 * sig ** 2)))
    elevation = elevation.astype(np.float32)

    # ENU geometry (reference pipeline: lonlat2ecef -> ecef2enu)
    trans = transform.TransformerEcef2enu(lon0, lat0, "WGS84")
    xe, ye, ze = transform.lonlat2ecef(lon2, lat2, elevation, "WGS84")
    x, y, z = transform.ecef2enu(xe, ye, ze, trans)
    vert_grid = hray.auxiliary.rearrange_pad_buffer(x, y, z)

    # Location coordinates + per-location unit vectors
    loc_lon = np.array([v[0] for v in locations.values()])
    loc_lat = np.array([v[1] for v in locations.values()])
    # surface point (h=0; the observer elevation is found on the terrain)
    lxe, lye, lze = transform.lonlat2ecef(
        loc_lon, loc_lat, np.zeros(len(locations), dtype=np.float32),
        "WGS84")
    lx, ly, lz = transform.ecef2enu(lxe, lye, lze, trans)
    coords = np.stack([lx, ly, lz], axis=-1).astype(np.float32)
    vn_ecef = direction.surf_norm(loc_lon, loc_lat)
    vnorth_ecef = direction.north_dir(lxe, lye, lze, vn_ecef, "WGS84")
    vec_norm = transform.ecef2enu_vector(vn_ecef, trans)
    vec_north = transform.ecef2enu_vector(vnorth_ecef, trans)

    hori, hori_dist, azim = (common.numpy(t) for t in
                             hray.horizon.horizon_locations(
                                 vert_grid, n, n, coords, vec_norm,
                                 vec_north, dist_search=args.dist_search,
                                 azim_num=args.azim_num, hori_dist_out=True,
                                 device=dev))

    for i, name in enumerate(locations):
        print(f"{name}: mean horizon {np.rad2deg(hori[i].mean()):.2f} deg, "
              f"max {np.rad2deg(hori[i].max()):.2f} deg, "
              f"mean horizon distance {hori_dist[i].mean() / 1000.0:.1f} km")
    common.check(hori.shape == (len(locations), args.azim_num)
                 and bool(np.isfinite(hori).all())
                 and bool(np.isfinite(hori_dist).all()),
                 "horizon and its distance finite")
    common.check(hori_dist.min() > 0.0, "horizon distances positive")
    path = os.path.join(args.out, "horizon_locations.npz")
    np.savez_compressed(path, horizon=hori, horizon_distance=hori_dist,
                        azim=azim, names=list(locations))
    print("saved:", path)

    if args.plot:
        common.plots_util().plot_location_horizons(
            args.out, hori, azim, list(locations))


if __name__ == "__main__":
    main()
