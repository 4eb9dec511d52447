"""The inputs of a run, made from the configuration, the traffic mix and
the seed: terrain, masks and sun tracks.

Copies rewritten in torch and NumPy (the originals are not imported):

* :func:`dhm25_like`: ``examples/torch/horizon/gridded_planar_dem.py::
  synthetic_dhm25_like`` at commit c632955, the DHM25 example's domain
  and spacing, the bumps evaluated on the device in float64, a terrain
  of its own for each DEM number ``dem``;
* :func:`hemisphere`: ``examples/torch/shadow/gridded_planar_dem_artificial
  .py`` (the upstream ``gridded_planar_DEM_artificial.py:45-63``);
* :func:`patch_mask`: ``bench.py``'s scattered glacier-style patches
  (``bench.py:388-396``), drawn from the seed on the device;
* :func:`sun_track`: ``horayzon_tpu_torch/sun_position.py::
  sun_position_planar`` over a rotating track.

A scene is a dict: ``z`` the (H, W) float32 heights on the device, ``x``
and ``y`` the float32 axes, ``dx``, ``dy`` (signed, as the program's grid
test reads them), ``offset`` and ``inner_shape`` of the inner block, and
the configuration's sweep settings.

A configuration's ``scene`` names a generator of :data:`SCENES` or else
the file ``hzbench/scene/<name>.py``, whose ``make(cfg, seed, device,
dem=0)`` returns the scene its driver and metric readers read, made from
the seed (:meth:`hzbench.harness.Manifest.scene`); a name in both places
is an error.
"""

import math

import numpy as np
import torch


def rng_for(seed, stream, *more):
    """A NumPy generator for one use (``stream``, and the whole numbers
    ``more``, such as a DEM's number) of the run's seed; any whole
    number is a seed."""
    return np.random.default_rng([int(seed) % 2 ** 64, stream, *more])


def _grid_fields(scene):
    x, y = scene["x"], scene["y"]
    scene["dx"] = float(x[1] - x[0])
    scene["dy"] = float(y[1] - y[0])
    scene["grid_origin"] = (float(x[0]), float(y[0]))
    h, w = len(y), len(x)
    x_axis = scene["grid_origin"][0] + np.arange(w) * scene["dx"]
    y_axis = scene["grid_origin"][1] + np.arange(h) * scene["dy"]
    scene["center"] = (float(0.5 * (x_axis[0] + x_axis[-1])),
                       float(0.5 * (y_axis[0] + y_axis[-1])))
    return scene


def dhm25_like(cfg, seed, device, dem=0):
    """Alpine-like terrain over the DHM25 example's outer domain (the
    inner domain plus the search distance on every side); each DEM
    number ``dem`` draws bumps of its own from the seed."""
    d = cfg["domain"]
    dx = float(cfg["dx"])
    pad = float(cfg["dist_search_km"]) * 1000.0
    x = np.arange(d["x_min"] - pad, d["x_max"] + pad + 0.5 * dx, dx)
    y = np.arange(d["y_max"] + pad, d["y_min"] - pad - 0.5 * dx, -dx)
    h, w = len(y), len(x)
    b = cfg["bumps"]
    rng = rng_for(seed, 0, dem)
    n = int(b["count"])
    cx = rng.uniform(0.0, w * dx, n)
    cy = rng.uniform(0.0, h * dx, n)
    sig = rng.uniform(*b["sigma_cells"], n) * dx
    amp = rng.uniform(*b["amp_m"], n)
    xl = torch.arange(w, dtype=torch.float64, device=device) * dx
    yl = torch.arange(h, dtype=torch.float64, device=device) * dx
    z = torch.zeros((h, w), dtype=torch.float64, device=device)
    for i in range(n):
        gx = torch.exp(-(xl - cx[i]) ** 2 / (2.0 * sig[i] ** 2))
        gy = torch.exp(-(yl - cy[i]) ** 2 / (2.0 * sig[i] ** 2))
        z.addr_(gy, gx, alpha=float(amp[i]))
    wv = b["wave"]
    z += wv["amp_m"] * (torch.sin(xl / wv["x_m"])[None, :]
                        * torch.cos(yl / wv["y_m"])[:, None])
    x32, y32 = x.astype(np.float32), y.astype(np.float32)
    # the inner block as the upstream example slices it
    r0 = int(np.where(y32 >= d["y_max"])[0][-1])
    r1 = int(np.where(y32 <= d["y_min"])[0][0]) + 1
    c0 = int(np.where(x32 <= d["x_min"])[0][-1])
    c1 = int(np.where(x32 >= d["x_max"])[0][0]) + 1
    scene = dict(z=z.to(torch.float32).contiguous(), x=x32, y=y32,
                 offset=(r0, c0), inner_shape=(r1 - r0, c1 - c0),
                 domain=dict(d), dist_search_m=pad,
                 dist_search_km=float(cfg["dist_search_km"]),
                 azim_num=int(cfg["azim_num"]),
                 hori_acc=float(cfg["hori_acc"]),
                 elev_ang_low_lim=float(cfg["elev_ang_low_lim"]))
    return _grid_fields(scene)


def hemisphere(cfg, seed, device, dem=0):
    """A hemisphere in a flat padded domain; neither the seed nor the
    DEM number enters."""
    dom = np.asarray(cfg["dom_width_h_m"], dtype=np.float32)
    dx = float(cfg["dx"])
    n = int(dom.sum() / dx) * 2
    x = np.linspace(-(dom.sum() - dx / 2), dom.sum() - dx / 2, n,
                    dtype=np.float32)
    y = x[::-1].copy()
    xx, yy = np.meshgrid(x, y)
    pin = int(dom[2] / dx)
    pmod = int(dom[1:].sum() / dx)
    el = np.zeros(xx.shape, dtype=np.float32)
    sl = (slice(pmod, -pmod), slice(pmod, -pmod))
    rad_sqrt = (dom[0] * np.float32(cfg["radius_share"])) ** 2
    with np.errstate(invalid="ignore"):
        el[sl] = np.sqrt(rad_sqrt - xx[sl] ** 2 - yy[sl] ** 2)
    el[np.isnan(el)] = 0.0
    scene = dict(z=torch.from_numpy(el).to(device), x=x, y=y,
                 offset=(pin, pin), inner_shape=(n - 2 * pin, n - 2 * pin),
                 acc=float(cfg["acc"]), ang_max=float(cfg["ang_max"]))
    return _grid_fields(scene)


SCENES = {"dhm25_like": dhm25_like, "hemisphere": hemisphere}


def patch_mask(spec, inner_shape, seed, device, dem=0):
    """(in0, in1) uint8: 1 inside any of ``spec["count"]`` discs of radius
    ``spec["radius_cells"]`` drawn from the seed for DEM number ``dem``,
    0 elsewhere."""
    rng = rng_for(seed, 1, dem)
    in0, in1 = inner_shape
    n = int(spec["count"])
    cy = rng.uniform(0, in0, n)
    cx = rng.uniform(0, in1, n)
    rr = rng.uniform(*spec["radius_cells"], n)
    ii = torch.arange(in0, dtype=torch.float64, device=device)[:, None]
    jj = torch.arange(in1, dtype=torch.float64, device=device)[None, :]
    m = torch.zeros((in0, in1), dtype=torch.bool, device=device)
    for k in range(n):
        m |= (ii - cy[k]) ** 2 + (jj - cx[k]) ** 2 <= rr[k] ** 2
    return m.to(torch.uint8).cpu().numpy()


def sun_track(spec, seed, day):
    """(T, 3) float32 sun positions of day ``day``: ``spec["steps"]``
    azimuths over ``spec["span_deg"]`` from a start drawn from the seed,
    turned by ``spec["turn_deg"]`` a day, at ``spec["elev_deg"]`` and
    ``spec["dist_m"]`` (planar)."""
    start = rng_for(seed, 2).uniform(0.0, 360.0)
    az = (start + day * float(spec["turn_deg"])
          + np.linspace(0.0, float(spec["span_deg"]), int(spec["steps"])))
    az = np.deg2rad(az)
    el = math.radians(float(spec["elev_deg"]))
    dist = float(spec["dist_m"])
    x = dist * np.cos(el) * np.sin(az)
    y = dist * np.cos(el) * np.cos(az)
    z = dist * np.sin(el) * np.ones_like(x)
    return np.stack([x, y, z], axis=-1).astype(np.float32)
