"""K1's tilt-ramp variant, the curved gridded ``horizon_gridded`` and
``CurvedPipeline`` on the CPU (their plain torch versions) against the JAX
package: ``_hz_fwd`` and ``horizon_sweep_pallas(tilt_ramp=...,
interpret=True)``, ``jax.grad`` through the latter, and the reference's
curved ``horizon_gridded`` and ``CurvedPipeline`` on its fused-kernel path
(``engine="pallas"``; the pipeline's ``engine="auto"`` with the TPU test
patched to true), the Pallas call in interpret mode and its masked-run tile
chooser fed a toy cost table, as ``tests/test_curved.py:240-316`` does.

The reference runs in one subprocess evaluated as written
(``test_torch_fused_sweep.AS_WRITTEN_XLA_FLAGS``).  The scenes are
``tests/test_curved.py``'s: the wall 13 km north, the flat sphere, the
masked island and the pipeline's bump.

Tolerances:
* raw ratios within 4 float32 ulp of the reference's (measured: equal),
  ids equal except at 1-ulp ties, D within rtol 1e-6;
* gradients w.r.t. ``z_outer`` and the ramp within 1e-5 of max|g| of
  ``jax.grad``;
* curved horizons within 1e-5 rad of the reference on unmasked cells: the
  two sweep the same lattice cells with the same plan except ``n_safe``
  (the reference pads its box to tile multiples and may move it), which
  changes no value on these scenes (ROADMAP Queue 3); the read-back is
  bit-equal to ``regrid._bilinear``;
* the pipeline's SVF, normals and slope within 1e-5, and the aspect's
  difference times the normal's horizontal length within 1e-5 (the aspect
  is an angle, and ill-conditioned where the slope vanishes).
"""

import numpy as np
import pytest
import torch

from horayzon_tpu import auxiliary as aux_ref
from horayzon_tpu import direction as direction_ref
from horayzon_tpu import regrid as regrid_ref
from horayzon_tpu import transform as transform_ref
from horayzon_tpu_torch import horizon, regrid
from horayzon_tpu_torch.models import CurvedPipeline
from horayzon_tpu_torch.ops import fused_sweep, replay

from reference_impl import gaussian_bumps_terrain
from test_torch_masked import _ORACLE as _MASK_ORACLE
from test_torch_masked import GRAD_RTOL, TOL, run_oracle
from torch_scenes import bumps, curved_setup, wall

# the pipeline call of the oracle: JAX CurvedPipeline on the kernel path
_ORACLE = _MASK_ORACLE.replace('''    else:
        args = dict(call["args"])''', '''    elif kind == "pipeline":
        from horayzon_tpu.models import CurvedPipeline
        hz._on_tpu = lambda: True
        pipe = CurvedPipeline(inputs[f"lon{i}"], inputs[f"lat{i}"],
                              inputs[f"z{i}"], call["domain"],
                              **call["args"])
        res = pipe.run()
    else:
        args = dict(call["args"])''')
assert _ORACLE != _MASK_ORACLE


def cap_ramps(n, off, inner, dx=25.0, dy=-25.0):
    """tests/test_pallas.py:208-245's spherical-cap normals as ramps."""
    r_earth = 6.371e6
    xs = (np.arange(n) - n / 2) * dx
    ys = (np.arange(n) - n / 2) * (-dy)
    xx, yy = np.meshgrid(xs, ys)
    norm = np.stack([-xx / r_earth, -yy / r_earth, np.ones_like(xx)],
                    axis=-1)
    norm /= np.linalg.norm(norm, axis=-1, keepdims=True)
    sl = (slice(off, off + inner), slice(off, off + inner))
    return ((norm[sl][..., 0] / norm[sl][..., 2]).astype(np.float32),
            (norm[sl][..., 1] / norm[sl][..., 2]).astype(np.float32))


def _kernel_cases():
    """(z, kw, tile, ramp, grad) of the kernel-level tilt comparisons."""
    halo, inner = int(6000.0 / 25) + 16, 64
    z_sp = np.zeros((inner + 2 * halo,) * 2, dtype=np.float32)
    z_sp[halo - 96, halo + 32] = 500.0
    rng = np.random.default_rng(3)
    return {
        # tests/test_pallas.py:208-252: spherical-cap ramps, 8 azimuths
        "tilt_cap_d800_a8": (
            gaussian_bumps_terrain(128, 128, seed=11, amp=400.0),
            dict(dx=25.0, dy=-25.0, offset=(32, 32), inner_shape=(64, 64),
                 azim_num=8, dist_search=800.0, hori_acc=0.25), (32, 64),
            cap_ramps(128, 32, 64), False),
        # the far spike only the mip phases read, with milliradian ramps
        "tilt_spike_d6000_a4": (
            z_sp, dict(dx=25.0, dy=-25.0, offset=(halo, halo),
                       inner_shape=(inner, inner), azim_num=4,
                       dist_search=6000.0, hori_acc=0.25), (inner, inner),
            tuple(rng.uniform(-2e-3, 2e-3, (inner, inner)).astype(np.float32)
                  for _ in range(2)), False),
        # tests/test_pallas.py:131-150's gradient case with uneven ramps
        "tilt_grad_d400_a4": (
            gaussian_bumps_terrain(64, 64, seed=6, amp=200.0),
            dict(dx=25.0, dy=-25.0, offset=(24, 24), inner_shape=(16, 16),
                 azim_num=4, dist_search=400.0, hori_acc=0.25), (16, 16),
            tuple(rng.uniform(-1e-3, 1e-3, (16, 16)).astype(np.float32)
                  for _ in range(2)), True),
    }


_curved_setup = curved_setup
_wall = wall(45.0 + 0.12, 400.0)
_bumps = bumps(4)


def _scene(name):
    """(setup, offset, inner, mask, horizon_gridded kwargs) of the curved
    scenes of tests/test_curved.py."""
    if name == "wall_13km":                  # test_curved.py:76-120
        return (_curved_setup(_wall, n=160), 78, 4, None,
                dict(dist_search=20.0, azim_num=4))
    if name == "flat_sphere":                # test_curved.py:62-73
        return (_curved_setup(lambda lon, lat: np.zeros_like(lon), n=120),
                50, 20, None, dict(dist_search=5.0, azim_num=8))
    mask = np.zeros((48, 48), dtype=np.uint8)
    mask[2:14, 28:44] = 1                    # test_curved.py:240-315
    return (_curved_setup(_bumps, n=160), 56, 48,
            mask if name == "island_masked" else None,
            dict(dist_search=4.0, azim_num=4, hori_fill=-9.0))


SCENES = ["wall_13km", "flat_sphere", "island_dense", "island_masked"]


def _pipeline_inputs():
    """tests/test_curved.py:187-208's pipeline case."""
    n, dlat = 100, 0.002
    lat = 45.0 + (np.arange(n)[::-1] - n / 2) * dlat
    lon = 7.0 + (np.arange(n) - n / 2) * dlat
    lon2, lat2 = np.meshgrid(lon, lat)
    elevation = (500.0 * np.exp(-((lon2 - 7.0) ** 2 + (lat2 - 45.0) ** 2)
                                / (2 * 0.02 ** 2))).astype(np.float32)
    domain = {"lon_min": 6.97, "lon_max": 7.03,
              "lat_min": 44.97, "lat_max": 45.03}
    return lon, lat, elevation, domain, dict(dist_search=5.0, azim_num=16,
                                             ellps="sphere")


KERNEL = _kernel_cases()


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    calls, arrays = [], {}
    for name, (z, kw, tile, ramp, grad) in KERNEL.items():
        i = len(calls)
        calls.append(dict(kind="kernel", kw=kw, tile=tile, grad=grad))
        arrays[f"z{i}"], (arrays[f"ra{i}"], arrays[f"rb{i}"]) = z, ramp
    for name in SCENES:
        s, off, inner, mask, args = _scene(name)
        i = len(calls)
        sl = (slice(off, off + inner),) * 2
        calls.append(dict(kind="gridded", args=dict(args, offset_0=off,
                                                    offset_1=off)))
        arrays.update({f"z{i}": s["z"], f"vn{i}": s["vec_norm"][sl],
                       f"vno{i}": s["vec_north"][sl],
                       f"vg{i}": aux_ref.rearrange_pad_buffer(
                           s["x"], s["y"], s["z"])})
        if mask is not None:
            arrays[f"mask{i}"] = mask
    lon, lat, elevation, domain, args = _pipeline_inputs()
    i = len(calls)
    calls.append(dict(kind="pipeline", domain=domain, args=args))
    arrays.update({f"z{i}": elevation, f"lon{i}": lon, f"lat{i}": lat})
    out = run_oracle(calls, arrays, tmp_path_factory.mktemp("curved_oracle"),
                     oracle=_ORACLE)
    return dict(zip(list(KERNEL) + SCENES + ["pipeline"], out))


@pytest.mark.parametrize("name", list(KERNEL))
def test_tilt_raw_matches_interpret_pallas(reference, name):
    z, kw, _, ramp, _ = KERNEL[name]
    ref = reference[name]
    args = fused_sweep.sweep_args(torch.from_numpy(z), tilt_ramp=ramp, **kw)
    raw, ids, aux = fused_sweep._ratio_plain(*args, emit_argmax=True)
    assert torch.equal(raw, fused_sweep._ratio_plain(*args))
    # the ids and D do not see the ramp
    untilted = fused_sweep._ratio_plain(*args[:6], emit_argmax=True)
    assert torch.equal(ids, untilted[1]) and torch.equal(aux, untilted[2])
    assert not torch.equal(raw, untilted[0])
    r_raw, r_ids, r_aux = replay.replay_state_from_jax(
        ref["raw"], ref["ids"], ref["aux"], kw["azim_num"], "cpu")
    rv, pv = r_raw.numpy(), raw.numpy()
    assert np.all(np.abs(rv - pv) <= 4 * np.spacing(np.abs(rv)))
    differ = (ids != r_ids).numpy()
    if differ.any():
        assert np.all(np.abs(rv[differ] - pv[differ])
                      <= np.spacing(np.abs(rv[differ])))
    quad = ((ids.numpy() % 2 == 1) & (ids.numpy() < 2 * args[4]["n_dense"])
            & ~differ)
    np.testing.assert_allclose(aux.numpy()[quad], r_aux.numpy()[quad],
                               rtol=1e-6, atol=0)
    got = fused_sweep.horizon_sweep_fused(torch.from_numpy(z),
                                          tilt_ramp=ramp, **kw)
    assert np.abs(got.numpy() - ref["hori"]).max() <= TOL


@pytest.mark.parametrize("name", [n for n, c in KERNEL.items() if c[4]])
def test_tilt_gradient_matches_jax(reference, name):
    z, kw, _, ramp, _ = KERNEL[name]
    zt = torch.from_numpy(z).requires_grad_(True)
    ra, rb = (torch.from_numpy(r).requires_grad_(True) for r in ramp)
    h = fused_sweep.horizon_sweep_fused(zt, tilt_ramp=(ra, rb), **kw)
    grads = torch.autograd.grad(torch.mean(h ** 2), (zt, ra, rb))
    for got, key in zip(grads, ("gz", "ga", "gb")):
        want = reference[name][key]
        assert np.isfinite(got.numpy()).all() and np.abs(want).max() > 0.0
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=GRAD_RTOL * np.abs(want).max())
    # only the ramp asks for a gradient: z's is not computed
    n0 = fused_sweep.ARGMAX_KERNEL_LAUNCHES
    h = fused_sweep.horizon_sweep_fused(torch.from_numpy(z),
                                        tilt_ramp=(ra, rb), **kw)
    ga, gb = torch.autograd.grad(torch.mean(h ** 2), (ra, rb))
    assert torch.equal(ga, grads[1]) and torch.equal(gb, grads[2])
    assert fused_sweep.ARGMAX_KERNEL_LAUNCHES == n0      # CPU: plain


def _port_gridded(name, device="cpu"):
    s, off, inner, mask, args = _scene(name)
    sl = (slice(off, off + inner),) * 2
    n0, n1 = s["z"].shape
    vg = aux_ref.rearrange_pad_buffer(s["x"], s["y"], s["z"])
    return horizon.horizon_gridded(vg, n0, n1, s["vec_norm"][sl],
                                   s["vec_north"][sl], off, off, mask=mask,
                                   verbose=False, device=device, **args)


@pytest.mark.parametrize("name", SCENES)
def test_curved_horizon_gridded_matches_reference(reference, name):
    hori, azim = _port_gridded(name)
    ref = reference[name]["hori"]
    assert hori.dtype == torch.float32 and hori.shape == ref.shape
    _, _, _, mask, args = _scene(name)
    np.testing.assert_array_equal(azim.numpy(), horizon.azimuth_angles(
        args["azim_num"]))
    sel = np.ones(ref.shape[:2], bool) if mask is None else mask == 1
    assert np.abs(hori.numpy()[sel] - ref[sel]).max() <= TOL
    if mask is not None:
        assert (hori.numpy()[~sel] == -9.0).all()
        # unmasked cells bit-equal to the dense run
        dense, _ = _port_gridded("island_dense")
        keep = torch.from_numpy(sel)
        assert torch.equal(hori[keep], dense[keep])


def test_curved_wall_angle_and_lattice():
    """The wall's angle (tests/test_curved.py:96-114's exact ENU geometry),
    and what the host preparation hands the sweep."""
    hori, _ = _port_gridded("wall_13km")
    s, off, inner, _, _ = _scene("wall_13km")
    o = np.array([s["x"][80, 80], s["y"][80, 80], s["z"][80, 80]],
                 dtype=np.float64)
    nvec = s["vec_norm"][80, 80].astype(np.float64)
    nnorth = s["vec_north"][80, 80].astype(np.float64)
    lat = 45.0 + (np.arange(160)[::-1] - 80) * 0.002
    best = max(np.arctan2((p - o) @ nvec, (p - o) @ nnorth) for p in (
        np.array([s["x"][i, 80], s["y"][i, 80], s["z"][i, 80]], np.float64)
        for i in np.where(np.abs(lat - 45.12) < 0.002)[0]))
    assert abs(np.rad2deg(float(hori[2, 2, 0]) - best)) < 0.3
    sl = (slice(off, off + inner),) * 2
    lat = horizon.curved_lattice(s["x"], s["y"], s["z"], s["vec_norm"][sl],
                                 off, off, device="cpu")
    i_lo, i_hi, j_lo, j_hi = lat["box"]
    assert lat["lat_mask"] is None
    assert lat["ramp"][0].shape == (i_hi - i_lo, j_hi - j_lo)
    assert lat["ramp"][0].dtype == torch.float32
    assert lat["norm_r"].dtype == torch.float64
    # the inner cells lie inside the box, one cell from its edge
    assert lat["fi"].min() >= i_lo + 1 and lat["fi"].max() <= i_hi - 2
    # a planarisation at hand is reused as it is
    again = horizon.curved_lattice(s["x"], s["y"], s["z"], s["vec_norm"][sl],
                                   off, off, pg=lat["pg"])
    assert again["pg"] is lat["pg"] and again["box"] == lat["box"]
    for a, b in zip(again["ramp"], lat["ramp"]):
        assert torch.equal(a, b)
    # an all-masked curved run sweeps nothing and fills every cell
    n0, n1 = s["z"].shape
    got, _ = horizon.horizon_gridded(
        aux_ref.rearrange_pad_buffer(s["x"], s["y"], s["z"]), n0, n1,
        s["vec_norm"][sl], s["vec_north"][sl], off, off,
        mask=np.zeros((inner, inner), np.uint8), hori_fill=-3.0,
        dist_search=20.0, azim_num=4, verbose=False, device="cpu")
    assert (got == -3.0).all()


def test_read_back_bit_equal_to_bilinear():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(9, 11, 5)).astype(np.float32)
    fi = rng.uniform(-0.5, 8.5, (6, 7))
    fj = rng.uniform(-0.5, 10.5, (6, 7))
    fi[0, 0], fj[0, 0] = 8.0, 10.0            # the last cell: clipped index
    want = regrid._bilinear(a.astype(np.float64), fi, fj).astype(np.float32)
    got = horizon.read_back(torch.from_numpy(a), fi, fj)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        want, regrid_ref._bilinear(a.astype(np.float64), fi, fj)
        .astype(np.float32))


def test_curved_pipeline_matches_reference(reference):
    lon, lat, elevation, domain, args = _pipeline_inputs()
    got = CurvedPipeline(lon, lat, elevation, domain, device="cpu",
                         **args).run()
    ref = reference["pipeline"]
    assert set(got) == set(ref)
    for key in ("azim", "elevation", "lon", "lat"):
        np.testing.assert_array_equal(got[key].numpy(), ref[key])
    assert np.abs(got["hori"].numpy() - ref["hori"]).max() <= TOL
    for key in ("svf", "vec_tilt", "slope"):
        np.testing.assert_allclose(got[key].numpy(), ref[key], rtol=0,
                                   atol=TOL)
    # aspect is an angle in [0, 2 pi) (due north may come out as 0 on one
    # side and 2 pi on the other) and is ill-conditioned where the slope
    # vanishes: held as the horizontal part of the normal it turns
    d = got["aspect"].numpy().astype(np.float64) - ref["aspect"]
    horiz = np.hypot(ref["vec_tilt"][..., 0], ref["vec_tilt"][..., 1])
    assert (np.abs(np.angle(np.exp(1j * d))) * horiz).max() <= TOL
    svf = got["svf"]
    assert torch.isfinite(svf).all() and (svf > 0.5).all() \
        and (svf <= 1.001).all()
    assert got["hori"].max().item() > np.deg2rad(1.0)


def test_curved_pipeline_mask_and_geometry():
    """``run(mask=)`` fills masked cells and leaves the others bit-equal to
    the unmasked run; the geometry equals the reference's host code."""
    lon, lat, elevation, domain, args = _pipeline_inputs()
    pipe = CurvedPipeline(lon, lat, elevation, domain, device="cpu", **args)
    dense = pipe.run()
    in0, in1 = dense["svf"].shape
    mask = np.zeros((in0, in1), np.uint8)
    mask[5:20, 10:30] = 1
    masked = pipe.run(mask=mask)
    keep = torch.from_numpy(mask == 1)
    assert torch.equal(masked["hori"][keep], dense["hori"][keep])
    assert (masked["hori"][~keep] == 0.0).all()     # the default fill
    lon2, lat2 = np.meshgrid(lon, lat)
    trans = transform_ref.TransformerEcef2enu(
        float(np.mean([domain["lon_min"], domain["lon_max"]])),
        float(np.mean([domain["lat_min"], domain["lat_max"]])), "sphere")
    xe, ye, ze = transform_ref.lonlat2ecef(lon2, lat2, elevation, "sphere")
    np.testing.assert_array_equal(
        pipe.x, transform_ref.ecef2enu(xe, ye, ze, trans)[0])
    sl = pipe.slice_in
    vn = direction_ref.surf_norm(lon2[sl], lat2[sl])
    np.testing.assert_array_equal(
        pipe.vec_norm, transform_ref.ecef2enu_vector(vn, trans))
