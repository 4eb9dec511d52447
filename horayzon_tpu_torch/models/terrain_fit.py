# Copyright (c) 2026
# MIT License
"""Terrain fit by gradient descent through the horizon sweep: the
counterpart of ``examples/horizon/terrain_fit_gradient.py``.

A "true" DEM holds a ridge that the initial DEM lacks.  Horizon angles
observed on the true terrain are the data; Adam on the elevation field
minimises the squared horizon misfit plus a small Laplacian regulariser,
with gradients from the winner-replay backward (kernels K1-argmax and K3 on
the card, their plain versions on the CPU).
"""

import numpy as np
import torch

from horayzon_tpu_torch.ops import fused_sweep


def terrains(n, dx, seed=0):
    """(true, initial) DEM pair: smooth rolling base + a ridge only the
    true terrain has (``terrain_fit_gradient.py:33-48``)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:n, 0:n].astype(np.float64) * dx
    base = np.zeros((n, n))
    for _ in range(10):
        cx, cy = rng.uniform(0, n * dx, 2)
        sig = rng.uniform(n / 10, n / 4) * dx
        base += rng.uniform(80, 300) * np.exp(
            -(((x - cx) ** 2 + (y - cy) ** 2) / (2 * sig ** 2)))
    ridge = 220.0 * np.exp(-((y - 0.34 * n * dx) ** 2)
                           / (2 * (3.5 * dx) ** 2))
    ridge *= np.exp(-((x - 0.55 * n * dx) ** 2)
                    / (2 * (0.18 * n * dx) ** 2))
    return ((base + ridge).astype(np.float32), base.astype(np.float32))


class TerrainFit(torch.nn.Module):
    """The elevation field ``z`` (an ``nn.Parameter``) fitted to observed
    horizons ``hori_obs`` (in0, in1, azim_num) of the centred inner block.

    ``forward()`` returns ``(loss, data)``: the horizon mean squared error
    ``data`` plus ``smooth`` times the mean squared Laplacian
    (``terrain_fit_gradient.py:89-94``)."""

    def __init__(self, z_init, hori_obs, *, dx, inner, azim_num,
                 dist_search, smooth=0.02, hori_acc=0.25):
        super().__init__()
        z = torch.as_tensor(z_init, dtype=torch.float32)
        self.z = torch.nn.Parameter(z.clone())
        self.register_buffer("hori_obs", torch.as_tensor(hori_obs))
        halo = (z.shape[0] - inner) // 2
        self.dx, self.smooth = float(dx), float(smooth)
        self.sweep_kw = dict(dx=dx, dy=-dx, offset=(halo, halo),
                             inner_shape=(inner, inner), azim_num=azim_num,
                             dist_search=dist_search, hori_acc=hori_acc)

    def forward(self):
        z = self.z
        hori = fused_sweep.horizon_sweep_fused(z, **self.sweep_kw)
        data = torch.mean((hori - self.hori_obs) ** 2)
        lap = (z[1:-1, 1:-1] * 4 - z[:-2, 1:-1] - z[2:, 1:-1]
               - z[1:-1, :-2] - z[1:-1, 2:]) / self.dx
        return data + self.smooth * torch.mean(lap ** 2), data


def fit(model, steps, lr=2.0):
    """Adam on ``model.z`` with the example's update (``betas`` 0.9, 0.999,
    ``eps`` 1e-8); returns the per-step horizon MSE (``data``) as floats."""
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)
    losses = []
    for _ in range(steps):
        opt.zero_grad()
        loss, data = model()
        loss.backward()
        opt.step()
        losses.append(data.item())
    return losses


def shift_adjusted_error(z, z_true, halo, inner):
    """|z - z_true| over the region the horizons constrain, after removing
    the median shift: horizons do not change under a uniform elevation
    shift, so elevation is recoverable only up to it
    (``terrain_fit_gradient.py:119-130``)."""
    sl = (slice(halo - 8, halo + inner + 8), slice(halo, halo + inner))
    d = (np.asarray(z) - np.asarray(z_true))[sl]
    return np.abs(d - np.median(d))
