# Description: Compute a time track of terrain-shadow masks and shortwave
#              correction factors for a curved-Earth DEM, with atmospheric
#              refraction — the PyTorch / CUDA port of examples/shadow/
#              gridded_curved_dem_srtm.py (South Georgia), on the card by
#              default (kernel K2 over the planarised lattice).
#
# The sun track comes from the built-in solar ephemeris
# (horayzon_tpu_torch.sun_position) instead of Skyfield; pass --dem for
# real SRTM data, default is synthetic terrain.
#
# Copyright (c) 2026
# MIT License

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
import common  # noqa: E402  (puts the repository root on sys.path)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import horayzon_tpu_torch as hray  # noqa: E402
from horayzon_tpu_torch import (direction, sun_position,  # noqa: E402
                                transform)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dem", help="SRTM GeoTIFF tile (optional)")
    ap.add_argument("--date", default="2026-01-15")
    ap.add_argument("--plot", action="store_true",
                    help="render reference-style matplotlib figures")
    ap.add_argument("--steps", type=int, default=25,
                    help="hourly steps of the sun track")
    common.add_common_args(ap)
    args = ap.parse_args()
    dev = common.device(args.device)
    os.makedirs(args.out, exist_ok=True)

    # Domain: South Georgia (reference gridded_curved_DEM_SRTM.py:35-38)
    if args.dem:
        domain = {"lon_min": -36.95, "lon_max": -35.65,
                  "lat_min": -54.75, "lat_max": -53.95}
        domain_outer = hray.domain.curved_grid(domain, 50.0, ellps="WGS84")
        lon, lat, elevation = hray.load_dem.srtm(args.dem, domain_outer,
                                                 engine="pillow")
        elevation = np.nan_to_num(elevation, nan=0.0).astype(np.float32)
    else:
        lon0, lat0, n, dlat = -36.3, -54.35, 700, 0.0012
        lat = lat0 + (np.arange(n)[::-1] - n / 2) * dlat
        lon = lon0 + (np.arange(n) - n / 2) * dlat
        rng = np.random.default_rng(4)
        lon2, lat2 = np.meshgrid(lon, lat)
        elevation = np.zeros_like(lon2)
        for _ in range(20):
            clon = rng.uniform(lon.min(), lon.max())
            clat = rng.uniform(lat.min(), lat.max())
            sig = rng.uniform(0.01, 0.05)
            elevation += rng.uniform(300, 2500) * np.exp(
                -(((lon2 - clon) ** 2 + (lat2 - clat) ** 2)
                  / (2 * sig ** 2)))
        elevation = elevation.astype(np.float32)
        domain = {"lon_min": float(lon.min()) + 0.2,
                  "lon_max": float(lon.max()) - 0.2,
                  "lat_min": float(lat.min()) + 0.15,
                  "lat_max": float(lat.max()) - 0.15}

    # ---- ENU geometry (L2 of the reference pipeline) --------------------
    lon_or = float(np.mean([domain["lon_min"], domain["lon_max"]]))
    lat_or = float(np.mean([domain["lat_min"], domain["lat_max"]]))
    trans = transform.TransformerEcef2enu(lon_or, lat_or, "WGS84")
    lon2, lat2 = np.meshgrid(lon, lat)
    xe, ye, ze = transform.lonlat2ecef(lon2, lat2, elevation, "WGS84")
    x, y, z = transform.ecef2enu(xe, ye, ze, trans)

    sl = (slice(np.where(lat >= domain["lat_max"])[0][-1],
                np.where(lat <= domain["lat_min"])[0][0] + 1),
          slice(np.where(lon <= domain["lon_min"])[0][-1],
                np.where(lon >= domain["lon_max"])[0][0] + 1))
    vn_ecef = direction.surf_norm(lon2[sl], lat2[sl])
    vec_norm = transform.ecef2enu_vector(vn_ecef, trans)

    # Tilted normals in global ENU (reference :120-130), on the device
    def on_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    sl1 = (slice(sl[0].start - 1, sl[0].stop + 1),
           slice(sl[1].start - 1, sl[1].stop + 1))
    vec_tilt = hray.topo_param.slope_vector_meth(
        on_dev(x[sl1]), on_dev(y[sl1]), on_dev(z[sl1]))[1:-1, 1:-1] \
        .contiguous()
    surf_enl_fac = hray.topo_param.surface_enlargement_factor(
        on_dev(vec_norm), vec_tilt)
    print("Surface enlargement factor (min/max): %.3f, %.3f"
          % (surf_enl_fac.min().item(), surf_enl_fac.max().item()))

    vert_grid = hray.auxiliary.rearrange_pad_buffer(x, y, z)
    mask = np.ones(tuple(vec_tilt.shape[:2]), dtype=np.uint8)
    terrain = hray.shadow.Terrain()
    terrain.initialise(vert_grid, elevation.shape[0], elevation.shape[1],
                       sl[0].start, sl[1].start, vec_tilt, vec_norm,
                       surf_enl_fac, np.ascontiguousarray(elevation[sl]),
                       mask, refrac_cor=True, device=dev)

    # ---- Sun track (built-in ephemeris replaces Skyfield) ---------------
    times = [np.datetime64(args.date) + np.timedelta64(h, "h")
             for h in range(args.steps)]
    sun_enu = sun_position.sun_position_enu(times, trans)

    t0 = time.perf_counter()
    sw = common.numpy(terrain.sw_dir_cor_batch(sun_enu))
    shadow = common.numpy(terrain.shadow_batch(sun_enu))
    dt = time.perf_counter() - t0
    print(f"{args.steps} sun positions in {dt:.2f} s "
          f"({dt / args.steps:.3f} s per step, batched on device)")
    frac_lit = (shadow == 0).mean(axis=(1, 2))
    print("illuminated fraction per step:",
          np.array2string(frac_lit, precision=2))
    common.check(bool(np.isfinite(sw).all()) and sw.min() >= 0.0,
                 "sw_dir_cor finite and non-negative")
    common.check(set(np.unique(shadow).tolist()) <= {0, 1, 2, 3},
                 "shadow codes in {0, 1, 2, 3}")
    common.check(bool((sw[(shadow == 1) | (shadow == 2)] == 0.0).all()),
                 "sw_dir_cor 0 on self- and terrain-shaded cells")

    path = os.path.join(args.out, "sw_dir_cor_srtm.npz")
    np.savez_compressed(path, sw_dir_cor=sw, shadow=shadow,
                        time=[str(t) for t in times])
    print("saved:", path)

    if args.plot:
        plots_util = common.plots_util()
        labels = [str(t)[11:16] for t in times]
        plots_util.plot_frames(args.out, sw, titles=labels,
                               name="sw_dir_cor_srtm.png", vmax=2.0)
        plots_util.plot_frames(args.out, shadow, titles=labels,
                               name="shadow_srtm.png", cmap="viridis",
                               vmin=0, vmax=3)
        # per-step timing figure (reference Performance.png,
        # gridded_curved_DEM_SRTM.py:272-284): each sun position alone
        step_times = []
        for sp in sun_enu:
            t0 = time.perf_counter()
            common.numpy(terrain.sw_dir_cor(sp))
            step_times.append(time.perf_counter() - t0)
        plots_util.plot_performance(args.out, step_times)


if __name__ == "__main__":
    main()
