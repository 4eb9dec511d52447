# Description: Compute the gridded correction factor for downward direct
#              shortwave radiation from artificial topography (hemispherical
#              mountain, rotating sun) and check the spatial mean against
#              the analytic expectation (~1).  The PyTorch / CUDA port of
#              examples/shadow/gridded_planar_dem_artificial.py, on the
#              card by default (kernel K2).
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dx", type=float, default=100.0)
    ap.add_argument("--azim-steps", type=int, default=181)
    ap.add_argument("--elev", type=float, default=30.0)
    ap.add_argument("--plot", action="store_true",
                    help="render reference-style matplotlib figures")
    common.add_common_args(ap)
    args = ap.parse_args()
    dev = common.device(args.device)
    os.makedirs(args.out, exist_ok=True)

    # Artificial topography (reference :45-63): hemisphere of radius
    # 0.95 * 10 km in a 40 km padded domain
    dom_width_h = np.array([10000, 20000, 10000], dtype=np.float32)
    dx = dy = args.dx
    x = np.linspace(-(dom_width_h.sum() - dx / 2),
                    dom_width_h.sum() - dx / 2,
                    int(dom_width_h.sum() / dx) * 2, dtype=np.float32)
    y = x[::-1].copy()
    xx, yy = np.meshgrid(x, y)
    slice_in = (slice(int(dom_width_h[2] / dy), -int(dom_width_h[2] / dy)),
                slice(int(dom_width_h[2] / dx), -int(dom_width_h[2] / dx)))
    elevation = np.zeros(xx.shape, dtype=np.float32)
    sl_mod = (slice(int(dom_width_h[1:].sum() / dy),
                    -int(dom_width_h[1:].sum() / dy)),
              slice(int(dom_width_h[1:].sum() / dx),
                    -int(dom_width_h[1:].sum() / dx)))
    rad_sqrt = (dom_width_h[0] * 0.95) ** 2
    with np.errstate(invalid="ignore"):
        elevation[sl_mod] = np.sqrt(rad_sqrt - xx[sl_mod] ** 2
                                    - yy[sl_mod] ** 2)
    elevation[np.isnan(elevation)] = 0.0
    print("Inner domain size:", elevation[slice_in].shape)

    # Vectors / surface enlargement (reference :66-99), on the device
    def on_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    in_shape = elevation[slice_in].shape
    vec_norm = np.zeros(in_shape + (3,), dtype=np.float32)
    vec_norm[..., 2] = 1.0
    sl1 = (slice(slice_in[0].start - 1, slice_in[0].stop + 1),
           slice(slice_in[1].start - 1, slice_in[1].stop + 1))
    vec_tilt = hray.topo_param.slope_plane_meth(
        on_dev(xx[sl1]), on_dev(yy[sl1]),
        on_dev(elevation[sl1]))[1:-1, 1:-1].contiguous()
    surf_enl_fac = hray.topo_param.surface_enlargement_factor(
        on_dev(vec_norm), vec_tilt)
    print("Surface enlargement factor (min/max): %.3f, %.3f"
          % (surf_enl_fac.min().item(), surf_enl_fac.max().item()))

    vert_grid = hray.auxiliary.rearrange_pad_buffer(xx, yy, elevation)
    mask = np.ones(in_shape, dtype=np.uint8)
    terrain = hray.shadow.Terrain()
    terrain.initialise(vert_grid, elevation.shape[0], elevation.shape[1],
                       slice_in[0].start, slice_in[1].start,
                       vec_tilt, vec_norm, surf_enl_fac,
                       np.ascontiguousarray(elevation[slice_in]), mask,
                       ang_max=89.99, device=dev)

    # Rotating sun (reference :107-112); all time steps in ONE device call
    azim = np.deg2rad(np.linspace(0.0, 360.0, args.azim_steps))
    sun_positions = hray.sun_position.sun_position_planar(
        np.rad2deg(azim), args.elev, dist=1.0e7)
    sw = common.numpy(terrain.sw_dir_cor_batch(sun_positions))
    means = sw.mean(axis=(1, 2))
    print("spatial-mean sw_dir_cor: min %.3f max %.3f average %.3f "
          "(analytic expectation ~1)"
          % (means.min(), means.max(), means.mean()))
    common.check(bool(np.isfinite(sw).all()) and sw.min() >= 0.0,
                 "sw_dir_cor finite and non-negative")
    common.check(abs(means.mean() - 1.0) < 0.03,
                 "hemisphere mean sw_dir_cor within 1 +- 0.03")

    path = os.path.join(args.out, "sw_dir_cor_artificial.npz")
    np.savez_compressed(path, sw_dir_cor=sw, azim=np.rad2deg(azim),
                        elevation=elevation[slice_in],
                        surf_enl_fac=common.numpy(surf_enl_fac))
    print("saved:", path)

    if args.plot:
        plots_util = common.plots_util()
        plots_util.plot_series(
            args.out, np.rad2deg(azim), means,
            xlabel="Sun azimuth [deg]",
            ylabel="Spatial-mean sw_dir_cor [-]",
            name="sw_dir_cor_artificial_mean.png", hline=1.0,
            title="Artificial hemisphere: analytic expectation ~1")
        plots_util.plot_frames(args.out, sw,
                               name="sw_dir_cor_artificial.png", vmax=2.0)


if __name__ == "__main__":
    main()
