# Copyright (c) 2026
# MIT License
"""End-to-end drive of horayzon_tpu_torch through its public API, the port
of examples/verify_drive.py: the reference workflows of
examples/horizon/gridded_planar_dem.py and
examples/shadow/gridded_planar_dem_artificial.py on synthetic terrain,
then probes (a low sun, masked cells, per-location against gridded
horizons, bad arguments), each held to its check.  Runs on the card by
default:

    python examples/torch/verify_drive.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import common  # noqa: E402  (puts the repository root on sys.path)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import horayzon_tpu_torch as hray  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (the card, default) or cpu")
    dev = common.device(ap.parse_args().device)
    check = common.check

    def on_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    print("=== 1. Planar horizon pipeline (gridded_planar_DEM.py workflow) "
          "===")
    # Synthetic DEM: ridge + bumps, 25 m grid, as a user would load via
    # load_dem
    dx = 25.0
    n = 200
    x = np.arange(n, dtype=np.float32) * dx
    y = (np.arange(n, dtype=np.float32)[::-1]) * dx  # north-up
    xx, yy = np.meshgrid(x, y)
    elevation = (300.0 * np.exp(-((xx - 2500) ** 2 + (yy - 2500) ** 2)
                                / (2 * 700.0 ** 2))
                 + 150.0 * np.sin(xx / 400.0) * np.cos(yy / 600.0)).astype(
        np.float32)

    domain = {"x_min": 1250.0, "x_max": 3750.0,
              "y_min": 1250.0, "y_max": 3750.0}
    dist_search = 1.0  # km
    domain_outer = hray.domain.planar_grid(domain, dist_search)
    print("outer domain:", domain_outer)

    slice_in = (slice(np.where(y >= domain["y_max"])[0][-1],
                      np.where(y <= domain["y_min"])[0][0] + 1),
                slice(np.where(x <= domain["x_min"])[0][-1],
                      np.where(x >= domain["x_max"])[0][0] + 1))
    offset_0, offset_1 = slice_in[0].start, slice_in[1].start
    in_shape = elevation[slice_in].shape
    print("inner domain:", in_shape, "offsets:", offset_0, offset_1)

    dem_dim_0, dem_dim_1 = elevation.shape
    vec_norm = np.zeros(in_shape + (3,), dtype=np.float32)
    vec_norm[:, :, 2] = 1.0
    vec_north = np.zeros(in_shape + (3,), dtype=np.float32)
    vec_north[:, :, 1] = 1.0
    vert_grid = hray.auxiliary.rearrange_pad_buffer(xx, yy, elevation)

    hori, azim = hray.horizon.horizon_gridded(
        vert_grid, dem_dim_0, dem_dim_1, vec_norm, vec_north,
        offset_0, offset_1, dist_search=dist_search, azim_num=48,
        device=dev)
    print("hori shape:", tuple(hori.shape), "dtype:", hori.dtype,
          "device:", hori.device)
    print("hori range [deg]: %.2f .. %.2f"
          % (np.rad2deg(hori.min().item()), np.rad2deg(hori.max().item())))
    check(hori.device.type == dev.type
          and bool(torch.isfinite(hori).all()), "horizon finite on "
          f"{dev.type}")

    sl1 = (slice(slice_in[0].start - 1, slice_in[0].stop + 1),
           slice(slice_in[1].start - 1, slice_in[1].stop + 1))
    vec_tilt = hray.topo_param.slope_plane_meth(
        on_dev(xx[sl1]), on_dev(yy[sl1]), on_dev(elevation[sl1]))[1:-1, 1:-1]
    svf = hray.topo_param.sky_view_factor(azim, hori, vec_tilt)
    slope, aspect = hray.topo_param.slope_angle_aspect(vec_tilt)
    print("svf range: %.3f .. %.3f" % (svf.min().item(), svf.max().item()))
    print("slope max [deg]: %.1f" % np.rad2deg(slope.max().item()))
    check(0.5 < svf.min().item() <= svf.max().item() <= 1.001,
          "SVF in (0.5, 1.001]")

    print()
    print("=== 2. Shadow / sw_dir_cor (artificial hemisphere workflow) ===")
    dom_w = np.array([10000, 20000, 10000], dtype=np.float32)
    dxa = 200.0
    xa = np.linspace(-(dom_w.sum() - dxa / 2), dom_w.sum() - dxa / 2,
                     int(dom_w.sum() / dxa) * 2, dtype=np.float32)
    ya = xa.copy()[::-1]
    xxa, yya = np.meshgrid(xa, ya)
    h_in = int(dom_w[2] / dxa)
    slice_in_a = (slice(h_in, -h_in), slice(h_in, -h_in))
    elev_a = np.zeros(xxa.shape, dtype=np.float32)
    m = int(dom_w[1:].sum() / dxa)
    slice_mod = (slice(m, -m), slice(m, -m))
    rad_sqrt = (dom_w[0] * 0.95) ** 2
    with np.errstate(invalid="ignore"):
        elev_a[slice_mod] = np.sqrt(rad_sqrt - xxa[slice_mod] ** 2
                                    - yya[slice_mod] ** 2)
    elev_a[np.isnan(elev_a)] = 0.0
    in_sh = elev_a[slice_in_a].shape
    print("inner shape:", in_sh)

    vec_norm_a = np.zeros(in_sh + (3,), dtype=np.float32)
    vec_norm_a[:, :, 2] = 1.0
    sl1a = (slice(h_in - 1, xxa.shape[0] - h_in + 1),
            slice(h_in - 1, xxa.shape[1] - h_in + 1))
    vec_tilt_a = hray.topo_param.slope_plane_meth(
        on_dev(xxa[sl1a]), on_dev(yya[sl1a]),
        on_dev(elev_a[sl1a]))[1:-1, 1:-1].contiguous()
    surf_enl = hray.topo_param.surface_enlargement_factor(
        on_dev(vec_norm_a), vec_tilt_a)
    print("surf_enl_fac min/max: %.3f %.3f"
          % (surf_enl.min().item(), surf_enl.max().item()))

    vert_grid_a = hray.auxiliary.rearrange_pad_buffer(xxa, yya, elev_a)
    mask = np.ones(in_sh, dtype=np.uint8)
    terrain = hray.shadow.Terrain()
    terrain.initialise(vert_grid_a, elev_a.shape[0], elev_a.shape[1],
                       h_in, h_in, vec_tilt_a, vec_norm_a, surf_enl,
                       elev_a[slice_in_a], mask, ang_max=89.99, device=dev)

    azims = np.deg2rad(np.linspace(0.0, 360.0, 13))
    elev_sun = np.deg2rad(30.0)
    dist_sun = 1.0e7
    sun_pos = np.stack([dist_sun * np.cos(elev_sun) * np.sin(azims),
                        dist_sun * np.cos(elev_sun) * np.cos(azims),
                        dist_sun * np.sin(elev_sun) * np.ones_like(azims)],
                       axis=-1).astype(np.float32)
    sw = common.numpy(terrain.sw_dir_cor_batch(sun_pos))
    means = sw.mean(axis=(1, 2))
    print("sw_dir_cor spatial means per azimuth:",
          np.array2string(means, precision=3))
    print("overall mean: %.3f (analytic expectation ~1)" % means.mean())
    check(abs(means.mean() - 1.0) < 0.03,
          "hemisphere energy check: mean within 1 +- 0.03")

    sh = common.numpy(terrain.shadow(sun_pos[0]))
    vals, counts = np.unique(sh, return_counts=True)
    print("shadow codes:", dict(zip(vals.tolist(), counts.tolist())))
    check(set(vals.tolist()) <= {0, 1, 2, 3}, "shadow codes in {0..3}")

    print()
    print("=== 3. Probes ===")
    # Probe: sun below horizon -> everything self- or terrain-shaded
    sun_low = np.array([0.0, 1e7, -5e5], dtype=np.float32)
    frac_illum = float((common.numpy(terrain.shadow(sun_low)) == 0).mean())
    print("sun below horizon: illuminated fraction = %.4f" % frac_illum)
    check(frac_illum < 0.5, "a sun below the horizon lights less than "
          "half the cells")

    # Probe: masked cells -> code 3 / fill value
    mask2 = mask.copy()
    mask2[:10, :] = 0
    terrain2 = hray.shadow.Terrain()
    terrain2.initialise(vert_grid_a, elev_a.shape[0], elev_a.shape[1],
                        h_in, h_in, vec_tilt_a, vec_norm_a, surf_enl,
                        elev_a[slice_in_a], mask2, sw_dir_cor_fill=np.nan,
                        device=dev)
    sh2 = common.numpy(terrain2.shadow(sun_pos[0]))
    check(bool((sh2[:10] == 3).all()), "masked rows all code 3")
    sw2 = common.numpy(terrain2.sw_dir_cor(sun_pos[0]))
    check(bool(np.isnan(sw2[:10]).all()), "masked rows NaN fill")

    # Probe: locations API at a grid cell matches the gridded result
    coords = np.array([[2500.0, 2500.0, 0.0]], dtype=np.float32)
    vn1 = np.array([[0.0, 0.0, 1.0]], dtype=np.float32)
    vnn1 = np.array([[0.0, 1.0, 0.0]], dtype=np.float32)
    hori_loc, _ = hray.horizon.horizon_locations(
        vert_grid, dem_dim_0, dem_dim_1, coords, vn1, vnn1,
        dist_search=1.0, azim_num=48, elev_ang_low_lim=-15.0, device=dev)
    i_loc = np.argmin(np.abs(y - 2500.0))
    j_loc = np.argmin(np.abs(x - 2500.0))
    hg = common.numpy(hori[i_loc - offset_0, j_loc - offset_1])
    d = np.rad2deg(np.abs(common.numpy(hori_loc[0]) - hg)).max()
    print("locations vs gridded max diff [deg]: %.3f" % d)
    check(d < 0.3, "locations within 0.3 degree of the gridded horizon")

    # Probe: bogus arguments
    try:
        hray.horizon.horizon_gridded(
            vert_grid, dem_dim_0, dem_dim_1, vec_norm, vec_north, offset_0,
            offset_1, dist_search=1.0, ray_algorithm="nope", device=dev)
        check(False, "bad ray_algorithm raises")
    except ValueError as e:
        print("bad ray_algorithm ->", e)
    try:
        terrain.shadow(np.zeros(4, dtype=np.float32))
        check(False, "bad sun_position raises")
    except ValueError as e:
        print("bad sun_position ->", e)

    print()
    print("ALL VERIFICATION DRIVES COMPLETED")


if __name__ == "__main__":
    main()
