# Description: Terrain horizon and sky view factor for a very high
#              resolution (2 m) planar DEM with a multi-resolution far
#              field — the PyTorch / CUDA port of examples/horizon/
#              gridded_planar_dem_2m.py (swissALTI3D), on the card by
#              default (kernel K1 over the combined pyramid).
#
#              The reference decimates the outer domain into a simplified
#              TIN with the external `hmm` tool under a vertical error
#              budget and attaches it to the Embree scene (:130-265).  Here
#              the far field is the same DEM max-pooled to coarse cells and
#              fed to the sweep as upper mip levels (ops/multires.py) — the
#              same two-component accuracy budget, no external tool, no
#              skirt geometry.
#
# Pass --dem-dir <swissALTI3D tile dir> for real data; default synthetic.
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
import torch  # noqa: E402

import horayzon_tpu_torch as hray  # noqa: E402
from horayzon_tpu_torch.ops import multires  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dem-dir", help="swissALTI3D tile directory")
    ap.add_argument("--dist-search", type=float, default=20.0,
                    help="search distance [km]")
    ap.add_argument("--azim-num", type=int, default=60)
    ap.add_argument("--plot", action="store_true",
                    help="render reference-style matplotlib figures")
    ap.add_argument("--inner", type=int, default=1024,
                    help="inner cells per side at 2 m")
    ap.add_argument("--ratio-log2", type=int, default=4,
                    help="log2 of far-field coarsening (2 m -> 32 m)")
    ap.add_argument("--engine", choices=("auto", "sweep"), default="auto",
                    help="auto: the fused sweep (K1 on the card); sweep: "
                         "the reference's XLA engine in plain torch")
    ap.add_argument("--validate", action="store_true",
                    help="also run the XLA multires sweep and report the "
                         "max deviation (error-budget check)")
    common.add_common_args(ap)
    args = ap.parse_args()
    dev = common.device(args.device)
    os.makedirs(args.out, exist_ok=True)

    dx = 2.0
    r = 2 ** args.ratio_log2
    # Fine grid must cover the inner domain + the halo marched at fine
    # levels (validated by the multires sweeps)
    halo_fine = 2048
    n_fine = args.inner + 2 * halo_fine

    if args.dem_dir:
        x0, y0 = 2669000.0, 1241000.0  # LV95 (reference :27-29)
        dom_fine = {"x_min": x0, "x_max": x0 + n_fine * dx,
                    "y_min": y0, "y_max": y0 + n_fine * dx}
        xf, yf, z_fine = hray.load_dem.swissalti3d(args.dem_dir, dom_fine)
        dom_coarse = hray.domain.planar_grid(
            {"x_min": x0 + halo_fine * dx,
             "x_max": x0 + (halo_fine + args.inner) * dx,
             "y_min": y0 + halo_fine * dx,
             "y_max": y0 + (halo_fine + args.inner) * dx},
            args.dist_search)
        xc, yc, z_coarse_full = hray.load_dem.swissalti3d(args.dem_dir,
                                                          dom_coarse)
        # max-pool to the coarse spacing
        hh = z_coarse_full.shape[0] - z_coarse_full.shape[0] % r
        ww = z_coarse_full.shape[1] - z_coarse_full.shape[1] % r
        z_coarse = z_coarse_full[:hh, :ww] \
            .reshape(hh // r, r, ww // r, r).max(axis=(1, 3))
        coarse_offset = (0, 0)  # fine grid starts at the coarse origin
    else:
        # Synthetic 2 m alpine terrain over the full coarse extent
        rng = np.random.default_rng(2)
        n_coarse = int(np.ceil((n_fine * dx + 2 * args.dist_search * 1000.0)
                               / (r * dx)))
        yy, xx = np.mgrid[0:n_coarse, 0:n_coarse].astype(np.float64)
        zc = np.zeros((n_coarse, n_coarse))
        for _ in range(30):
            cy, cx = rng.uniform(0, n_coarse, 2)
            sig = rng.uniform(10, n_coarse / 6)
            zc += rng.uniform(200, 2000) * np.exp(
                -(((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sig ** 2)))
        z_coarse = zc.astype(np.float32)
        # Fine grid: upsample the coarse window + add 2 m-scale detail
        fo_c = (n_coarse - n_fine // r) // 2
        window = z_coarse[fo_c:fo_c + n_fine // r,
                          fo_c:fo_c + n_fine // r]
        z_fine = np.repeat(np.repeat(window, r, 0), r, 1)
        z_fine = z_fine + 3.0 * rng.standard_normal(z_fine.shape) \
            .astype(np.float32)
        z_fine = z_fine.astype(np.float32)
        coarse_offset = (fo_c * r, fo_c * r)

    off = halo_fine
    inner = (args.inner, args.inner)
    print(f"fine grid {z_fine.shape} @ {dx} m, "
          f"coarse {z_coarse.shape} @ {r * dx} m")
    kw = dict(ratio_log2=args.ratio_log2, coarse_offset=coarse_offset,
              dx=dx, dy=-dx, offset=(off, off), inner_shape=inner,
              dist_search=args.dist_search * 1000.0, hori_acc=0.25)
    azim = hray.azimuth_angles(args.azim_num)
    z_f = torch.from_numpy(np.ascontiguousarray(z_fine)).to(dev)
    z_c = torch.from_numpy(np.ascontiguousarray(z_coarse)).to(dev)
    if args.engine == "auto":
        print("engine: fused multires sweep")
        hori = multires.horizon_sweep_multires_fused(
            z_f, z_c, azim_num=args.azim_num, **kw)
    else:
        print("engine: XLA multires sweep (plain torch)")
        hori = multires.horizon_sweep_multires(z_f, z_c, azim=azim, **kw)
    if args.validate and args.engine == "auto":
        hori_x = multires.horizon_sweep_multires(z_f, z_c, azim=azim, **kw)
        dev_max = float((hori - hori_x).abs().max())
        print(f"fused vs XLA multires max dev: {np.rad2deg(dev_max):.4f} "
              f"deg (budget: hori_acc = 0.25 deg)")
    mean_per_azim = common.numpy(hori.mean(dim=(0, 1)))
    print("horizon mean [deg]: %.2f, max [deg]: %.2f"
          % (float(np.rad2deg(hori.mean().item())),
             float(np.rad2deg(hori.max().item()))))
    common.check(tuple(hori.shape) == inner + (args.azim_num,)
                 and bool(torch.isfinite(hori).all()), "horizon finite")
    # save a summary only: the full cube is 1024^2 x azimuths
    path = os.path.join(args.out, "hori_2m_summary.npz")
    np.savez_compressed(path, hori_mean_per_azim=mean_per_azim, azim=azim)
    print("saved:", path)

    if args.plot:
        common.plots_util().plot_location_horizons(
            args.out, mean_per_azim[None, :], azim, ["domain mean"],
            name="horizon_2m_mean.png")


if __name__ == "__main__":
    main()
