# Description: Recover a hidden terrain feature from horizon observations
#              by gradient descent through the fused sweep — the PyTorch /
#              CUDA port of examples/horizon/terrain_fit_gradient.py, on
#              the card by default (kernels K1-argmax and K3, the
#              winner-replay backward).
#
#              A "true" DEM contains a ridge the initial DEM is missing.
#              Per-cell, per-azimuth horizon angles observed on the true
#              terrain are the measurements; Adam on the elevation field
#              minimises the squared horizon mismatch.  A small Laplacian
#              regulariser keeps the solution smooth where horizons carry
#              no information (horayzon_tpu_torch.models.terrain_fit).
#
# --plot saves the true / initial / recovered elevation maps and the loss
# curve.
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

from horayzon_tpu_torch.models import terrain_fit  # noqa: E402
from horayzon_tpu_torch.ops import fused_sweep  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=192,
                    help="outer DEM cells per side")
    ap.add_argument("--inner", type=int, default=64)
    ap.add_argument("--dx", type=float, default=25.0)
    ap.add_argument("--dist-search", type=float, default=1.5,
                    help="horizon search distance [km]")
    ap.add_argument("--azim-num", type=int, default=16)
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--lr", type=float, default=2.0)
    ap.add_argument("--smooth", type=float, default=0.02,
                    help="Laplacian regulariser weight")
    ap.add_argument("--plot", action="store_true")
    common.add_common_args(ap)
    args = ap.parse_args()
    dev = common.device(args.device)

    n, inner = args.n, args.inner
    halo = (n - inner) // 2
    z_true_np, z_init_np = terrain_fit.terrains(n, args.dx, seed=3)
    kw = dict(dx=args.dx, inner=inner, azim_num=args.azim_num,
              dist_search=args.dist_search * 1000.0, smooth=args.smooth)
    hori_obs = fused_sweep.horizon_sweep_fused(
        torch.from_numpy(z_true_np).to(dev), dx=args.dx, dy=-args.dx,
        offset=(halo, halo), inner_shape=(inner, inner),
        azim_num=args.azim_num, dist_search=args.dist_search * 1000.0)
    print(f"observations: {inner}x{inner} cells x {args.azim_num} "
          f"azimuths on {dev}")
    model = terrain_fit.TerrainFit(z_init_np, hori_obs, **kw).to(dev)

    t0 = time.time()
    losses = terrain_fit.fit(model, args.steps, lr=args.lr)
    print(f"{args.steps} steps in {time.time() - t0:.1f} s; horizon MSE "
          f"{losses[0]:.3e} -> {losses[-1]:.3e} rad^2")

    # Horizon angles are invariant under a uniform elevation shift, so
    # elevation is recoverable only up to it: score after removing it.
    z_fit = common.numpy(model.z)
    e0 = terrain_fit.shift_adjusted_error(z_init_np, z_true_np, halo, inner)
    e1 = terrain_fit.shift_adjusted_error(z_fit, z_true_np, halo, inner)
    print(f"shift-adjusted elevation error over the constrained region: "
          f"{e0.mean():.2f} m -> {e1.mean():.2f} m "
          f"(max {e0.max():.1f} -> {e1.max():.1f})")
    if args.steps >= 100:     # smoke runs with few steps skip the check
        common.check(e1.max() < 0.5 * e0.max(),
                     "ridge recovered: max error below half its start")
        common.check(losses[-1] < 0.05 * losses[0],
                     "horizon misfit below 5% of the first step's")
        print("RECOVERY OK")

    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "terrain_fit_gradient.npz")
    np.savez_compressed(path, z_true=z_true_np, z_init=z_init_np,
                        z_fit=z_fit, losses=np.asarray(losses))
    print("saved:", path)
    if args.plot:
        plots_util = common.plots_util()
        sl = (slice(halo - 8, halo + inner + 8), slice(halo, halo + inner))
        frames = np.stack([z_true_np[sl], z_init_np[sl], z_fit[sl], e1])
        plots_util.plot_frames(
            args.out, frames,
            titles=["true elevation [m]", "initial (no ridge)",
                    "recovered by autograd", "abs error after fit [m]"],
            name="terrain_fit_gradient.png", cmap="viridis", vmin=None)
        plots_util.plot_series(
            args.out, np.arange(len(losses)), np.asarray(losses),
            xlabel="Adam step", ylabel="horizon MSE [rad^2]",
            name="terrain_fit_loss.png")


if __name__ == "__main__":
    main()
