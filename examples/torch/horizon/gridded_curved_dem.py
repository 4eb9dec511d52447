# Description: Compute gridded topographic parameters for a curved-Earth
#              lon/lat DEM — the PyTorch / CUDA port of examples/horizon/
#              gridded_curved_dem.py (SRTM, European Alps), on the card by
#              default (kernel K1's tilt-ramp variant).
#
# Pass --dem <SRTM GeoTIFF> for real data; default is synthetic terrain.
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


def synthetic_srtm_like(lat0=46.5, lon0=8.0, n=900, dlat=0.0009, seed=0):
    rng = np.random.default_rng(seed)
    lat = lat0 + (np.arange(n)[::-1] - n / 2) * dlat
    lon = lon0 + (np.arange(n) - n / 2) * dlat
    lon2, lat2 = np.meshgrid(lon, lat)
    z = np.zeros_like(lon2)
    for _ in range(30):
        clon, clat = rng.uniform(lon.min(), lon.max()), \
            rng.uniform(lat.min(), lat.max())
        sig = rng.uniform(0.01, 0.08)
        z += rng.uniform(300, 2500) * np.exp(
            -(((lon2 - clon) ** 2 + (lat2 - clat) ** 2) / (2 * sig ** 2)))
    return lon, lat, z.astype(np.float32)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dem", help="SRTM GeoTIFF tile (optional)")
    ap.add_argument("--dist-search", type=float, default=20.0)
    ap.add_argument("--azim-num", type=int, default=120)
    ap.add_argument("--ellps", default="WGS84")
    ap.add_argument("--plot", action="store_true",
                    help="render reference-style matplotlib figures")
    ap.add_argument("--geoid", action="store_true",
                    help="apply EGM96 undulation (downloads aux data)")
    common.add_common_args(ap)
    args = ap.parse_args()
    dev = common.device(args.device)
    os.makedirs(args.out, exist_ok=True)

    if args.dem:
        # Reference domain (gridded_curved_DEM.py:27-31)
        domain = {"lon_min": 7.70, "lon_max": 8.30,
                  "lat_min": 46.3, "lat_max": 46.75}
        domain_outer = hray.domain.curved_grid(domain, args.dist_search,
                                               ellps=args.ellps)
        lon, lat, elevation = hray.load_dem.srtm(args.dem, domain_outer,
                                                 engine="pillow")
        elevation = np.nan_to_num(elevation, nan=0.0).astype(np.float32)
    else:
        lon, lat, elevation = synthetic_srtm_like()
        pad = 0.25
        domain = {"lon_min": float(lon.min()) + pad,
                  "lon_max": float(lon.max()) - pad,
                  "lat_min": float(lat.min()) + pad,
                  "lat_max": float(lat.max()) - pad}

    # Orthometric -> ellipsoidal heights (reference geoid.undulation)
    if args.geoid:
        undul = hray.geoid.undulation(lon, lat, geoid="EGM96")
        elevation = (elevation + undul).astype(np.float32)

    pipe = hray.models.CurvedPipeline(
        lon, lat, elevation, domain, dist_search=args.dist_search,
        azim_num=args.azim_num, ellps=args.ellps, device=dev)
    out = {k: common.numpy(v) for k, v in pipe.run().items()}

    hori, svf = out["hori"], out["svf"]
    print("horizon:", hori.shape,
          "range [deg]: %.2f .. %.2f" % (np.rad2deg(hori.min()),
                                         np.rad2deg(hori.max())))
    print("svf range: %.3f .. %.3f" % (svf.min(), svf.max()))
    common.check(bool(np.isfinite(hori).all()), "horizon finite")
    common.check(bool(np.isfinite(svf).all()) and svf.min() > 0.0
                 and svf.max() <= 1.0 + 1e-3, "svf in (0, 1.001]")
    path = os.path.join(args.out, "topo_par_curved.npz")
    np.savez(   # uncompressed, as the planar example writes its cube
        path, horizon=hori, azim=out["azim"], svf=svf, slope=out["slope"],
        aspect=out["aspect"], elevation=out["elevation"], lon=out["lon"],
        lat=out["lat"])
    print("saved:", path)

    if args.plot:
        common.plots_util().plot_topo_panels(
            args.out, elevation=out["elevation"], svf=svf,
            slope=out["slope"], hori=hori, azim=out["azim"],
            name="topo_panels_curved.png")


if __name__ == "__main__":
    main()
