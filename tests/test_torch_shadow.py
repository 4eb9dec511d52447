"""The port's shadow slice on the CPU against the JAX package.

* :func:`shadow_sweep.shadow_metric_fused` (its plain torch version on the
  CPU) against ``pallas_sweep.shadow_metric_pallas(..., interpret=True,
  exact_metric=True)`` with the inner block as the tile.  Tolerance:
  :data:`METRIC_TOL` metres, and ``metric > 0`` equal wherever the
  reference's ``|metric| > 1e-3``.  The port performs the kernel's float32
  operations in the order its source writes them; on these cases the two
  agree to within :data:`METRIC_TOL`.
* :class:`horayzon_tpu_torch.shadow.Terrain` against JAX
  ``Terrain(engine="pallas")._run_pallas(..., interpret=True)``: shadow
  codes equal outside a tie zone (cells whose port metric is within 1e-3 m
  of 0, or whose sun dot products are within 1e-6 of a classification
  threshold; the reference runs its sign-exact mode there and forms its
  dot products in its own order), ``sw_dir_cor`` within :data:`SW_TOL`
  plus :data:`SW_RTOL` relative outside it.

The reference runs in one subprocess under
``test_torch_fused_sweep.AS_WRITTEN_XLA_FLAGS``, so XLA evaluates the
kernel's float32 arithmetic as written (no reassociation of ``s * m``, no
FMA).  The rest mirrors ``tests/test_shadow.py`` on the port, and holds the
refraction, the surface enlargement factor and ``Terrain.initialise``'s
validation against the JAX package.
"""

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from horayzon_tpu import shadow as shadow_ref
from horayzon_tpu import topo_param as topo_ref
from horayzon_tpu.ops import pallas_sweep
from horayzon_tpu.ops import refraction as refraction_ref
from horayzon_tpu.ops import sweep as sweep_ref
from horayzon_tpu_torch import auxiliary, shadow, topo_param
from horayzon_tpu_torch.ops import mip, refraction
from horayzon_tpu_torch.ops import shadow_sweep as ss

from reference_impl import brute_shadow, gaussian_bumps_terrain
from torch_scenes import refraction_numpy
from test_torch_fused_sweep import AS_WRITTEN_XLA_FLAGS

#: Metric tolerance [m] against the interpret-mode reference
METRIC_TOL = 1.0e-3
#: sw_dir_cor tolerance outside the tie zone: 1e-5 absolute plus 1e-6
#: relative (near a grazing sun the factor reaches ~100, where one float32
#: ulp is 7.6e-6 and the refraction's arccos, power and tan differ by an ulp)
SW_TOL = 1.0e-5
SW_RTOL = 1.0e-6
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_ORACLE = r"""
import json, sys
import numpy as np
from horayzon_tpu import shadow
from horayzon_tpu.ops import pallas_sweep, sweep
inputs = np.load(sys.argv[1])
calls = json.load(open(sys.argv[2]))
out = {}
for name, c in calls.items():
    a = {k[len(name) + 1:]: inputs[k] for k in inputs.files
         if k.startswith(name + ":")}
    if c["kind"] == "metric":
        z = a["z"]
        h, w = z.shape
        diag = float(np.hypot(w * abs(c["dx"]), h * abs(c["dy"])))
        sched = sweep.build_schedule(min(abs(c["dx"]), abs(c["dy"])), diag,
                                     sweep.default_rel_err(0.25))
        out[name + ":metric"] = np.asarray(pallas_sweep.shadow_metric_pallas(
            z, a["z_org"], a["z_inner"], a["table"], schedule=sched,
            offset=tuple(c["offset"]), inner_shape=tuple(c["inner_shape"]),
            dx=c["dx"], dy=c["dy"], grid_origin=tuple(c["grid_origin"]),
            tile=tuple(c["inner_shape"]), interpret=True, exact_metric=True))
        continue
    t = shadow.Terrain()
    t.initialise(a["vert_grid"], c["dem_dim"][0], c["dem_dim"][1],
                 c["offset"][0], c["offset"][1], a["vec_tilt"], a["vec_norm"],
                 a["surf_enl_fac"], a["elevation"], a["mask"],
                 sw_dir_cor_fill=c["fill"], refrac_cor=c["refrac_cor"],
                 engine="pallas")
    for mode in ("shadow", "sw_dir_cor"):
        out[name + ":" + mode] = np.asarray(
            t._run_pallas(a["suns"], mode, interpret=True))
        out[name + ":" + mode + "_single"] = np.asarray(
            t._run_pallas(a["suns"][1], mode, interpret=True))
    for p, lv in enumerate(t._pallas_pyramid):
        out[name + ":level" + str(p)] = np.asarray(lv)
np.savez(sys.argv[3], **out)
"""


def _suns_about(center, rel):
    """(T, 3) float32 sun positions ``center + rel`` (rel in metres)."""
    cx, cy = center
    return np.array([[cx + a, cy + b, c] for a, b, c in rel],
                    dtype=np.float32)


def _center(shape, dx, dy, origin=(0.0, 0.0)):
    h, w = shape
    return (origin[0] + 0.5 * (w - 1) * dx, origin[1] + 0.5 * (h - 1) * dy)


def _metric_case(z, offset, inner, dx, dy, rel, origin=(0.0, 0.0)):
    in0, in1 = inner
    z_inner = np.ascontiguousarray(z[offset[0]:offset[0] + in0,
                                     offset[1]:offset[1] + in1])
    center = _center(z.shape, dx, dy, origin)
    table, near_vert = ss.shadow_sun_table(_suns_about(center, rel), center,
                                           dx, dy)
    arrays = dict(z=z, z_inner=z_inner, z_org=z_inner + np.float32(0.05),
                  table=table)
    call = dict(kind="metric", offset=list(offset), inner_shape=list(inner),
                dx=dx, dy=dy, grid_origin=list(origin))
    return arrays, call, near_vert


def _spike():
    """A 500 m spike 8 km north-east of a 32^2 block in the south-west
    corner of a flat 256^2 grid: beyond the dense range (230 steps of
    25 m), so only the mip phases read it."""
    z = np.zeros((256, 256), dtype=np.float32)
    z[2, 250] = 500.0
    return z


def _metric_cases():
    z128 = gaussian_bumps_terrain(128, 128, seed=5, amp=400.0)
    return {
        # tests/test_pallas.py:153-181
        "pallas_128_inner64": _metric_case(
            z128, (32, 32), (64, 64), 25.0, -25.0,
            [(2.0e5, 1.0e5, 2.0e4), (-1.5e5, -0.5e5, 1.2e4),
             (0.3e5, -2.0e5, 3.0e4)]),
        # tests/test_shadow.py's 8-cell halo: masked d2 steps
        "halo8": _metric_case(
            gaussian_bumps_terrain(48, 48, seed=11, amp=600.0), (8, 8),
            (32, 32), 25.0, -25.0,
            [(1.0e7, 0.0, 1.5e6), (-4.0e6, 8.0e6, 1.5e6),
             (3.0e6, -9.0e6, 2.5e6)]),
        "dx_ne_dy": _metric_case(
            gaussian_bumps_terrain(64, 72, seed=2, amp=500.0), (12, 10),
            (32, 40), 25.0, -30.0,
            [(2.0e5, 1.0e5, 1.5e4), (-1.0e5, 2.0e5, 1.0e4),
             (-2.0e5, -0.4e5, 2.0e4), (0.5e5, -2.0e5, 0.8e4)],
            origin=(1000.0, 5.0e5)),
        "far_spike": _metric_case(
            _spike(), (216, 8), (32, 32), 25.0, -25.0,
            [(2.1e5, 2.1e5, 6.0e3), (2.0e5, 2.2e5, 8.0e3),
             (-2.0e5, 1.0e5, 6.0e3)]),
        # sun below the horizon: past the domain edge the sentinel
        # samples' clearance -3e4 - z_org - s*m turns positive (m ~ -10)
        "sun_below": _metric_case(
            z128, (32, 32), (64, 64), 25.0, -25.0,
            [(1.0e5, 0.0, -1.0e6), (-0.3e5, 0.6e5, -0.2e5)]),
        # sun straight above the centre: near_vertical, kx_u = 1, ky_u = 0
        # and the ray slope hits the 1e-4 floor of adv east of it
        "near_vertical": _metric_case(
            z128, (32, 32), (64, 64), 25.0, -25.0,
            [(0.0, 0.0, 2.0e4), (1.0e5, 1.0e5, 3.0e4)]),
    }


METRIC_CASES = _metric_cases()


def _planar_inputs(z, dx=25.0, off=(8, 8), inner=None, mask=None):
    """Terrain.initialise inputs as tests/test_shadow.py builds them (north
    up, x = j*dx, y = -i*dx), from the JAX package's topo_param."""
    h, w = z.shape
    if inner is None:
        inner = (h - 2 * off[0], w - 2 * off[1])
    in0, in1 = inner
    x1 = np.arange(w, dtype=np.float32) * dx
    y1 = -np.arange(h, dtype=np.float32) * dx
    xx, yy = np.meshgrid(x1, y1)
    vec_norm = np.zeros((in0, in1, 3), dtype=np.float32)
    vec_norm[..., 2] = 1.0
    sl1 = (slice(off[0] - 1, off[0] + in0 + 1),
           slice(off[1] - 1, off[1] + in1 + 1))
    vec_tilt = np.ascontiguousarray(topo_ref.slope_plane_meth(
        xx[sl1], yy[sl1], z[sl1])[1:-1, 1:-1])
    return dict(
        vert_grid=auxiliary.rearrange_pad_buffer(xx, yy, z),
        vec_tilt=vec_tilt, vec_norm=vec_norm,
        surf_enl_fac=topo_ref.surface_enlargement_factor(vec_norm,
                                                         vec_tilt),
        elevation=np.ascontiguousarray(z[off[0]:off[0] + in0,
                                         off[1]:off[1] + in1]),
        mask=(np.ones(inner, dtype=np.uint8) if mask is None else mask),
        dem_dim=(h, w), offset=off)


def _port_terrain(inp, **kw):
    t = shadow.Terrain()
    t.initialise(inp["vert_grid"], inp["dem_dim"][0], inp["dem_dim"][1],
                 inp["offset"][0], inp["offset"][1], inp["vec_tilt"],
                 inp["vec_norm"], inp["surf_enl_fac"], inp["elevation"],
                 inp["mask"], device="cpu", **kw)
    return t


def _terrain_cases():
    """48x160 outer, 32x128 inner at (8, 16): in1 = 128, so the JAX
    Terrain's Pallas engine pads nothing (horizon.py:327-343)."""
    z = gaussian_bumps_terrain(48, 160, seed=11, amp=600.0)
    mask = np.ones((32, 128), dtype=np.uint8)
    mask[:3, :20] = 0
    mask[20:, 100:] = 0
    inp = _planar_inputs(z, off=(8, 16), inner=(32, 128), mask=mask)
    suns = np.array([[1.0e7, 0.0, 1.5e6], [-4.0e6, 8.0e6, 1.5e6],
                     [2.0e6, -1.0e7, 3.0e6], [0.0, 1.0e7, -1.0e6],
                     [-1.0e7, -2.0e6, 6.0e5]], dtype=np.float32)
    return {"mask_nanfill": (inp, dict(sw_dir_cor_fill=np.nan,
                                       refrac_cor=False), suns),
            "refrac_mask_fill": (inp, dict(sw_dir_cor_fill=-7.0,
                                           refrac_cor=True), suns)}


TERRAIN_CASES = _terrain_cases()


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    """Every reference result of this file from one subprocess."""
    tmp = tmp_path_factory.mktemp("shadow_oracle")
    arrays, calls = {}, {}
    for name, (arr, call, _) in METRIC_CASES.items():
        calls[name] = call
        arrays.update({f"{name}:{k}": v for k, v in arr.items()})
    for name, (inp, kw, suns) in TERRAIN_CASES.items():
        calls[name] = dict(kind="terrain", dem_dim=list(inp["dem_dim"]),
                           offset=list(inp["offset"]),
                           fill=float(kw["sw_dir_cor_fill"]),
                           refrac_cor=kw["refrac_cor"])
        arrays.update({f"{name}:{k}": inp[k] for k in (
            "vert_grid", "vec_tilt", "vec_norm", "surf_enl_fac",
            "elevation", "mask")})
        arrays[f"{name}:suns"] = suns
    paths = [str(tmp / n) for n in ("in.npz", "calls.json", "out.npz")]
    np.savez(paths[0], **arrays)
    with open(paths[1], "w") as f:
        json.dump(calls, f)
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": AS_WRITTEN_XLA_FLAGS,
           "PYTHONPATH": os.pathsep.join(
               [_REPO, os.environ.get("PYTHONPATH", "")])}
    res = subprocess.run([sys.executable, "-c", _ORACLE, *paths], env=env,
                         capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    out = np.load(paths[2])
    return {k: out[k] for k in out.files}


# ---------------------------------------------------------------------------
# The metric against interpret-mode shadow_metric_pallas
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(METRIC_CASES))
def test_metric_matches_interpret_pallas(oracle, name):
    arr, call, near_vert = METRIC_CASES[name]
    n0 = ss.KERNEL_LAUNCHES
    got = ss.shadow_metric_fused(
        torch.from_numpy(arr["z"]), arr["z_org"], arr["z_inner"],
        arr["table"], offset=tuple(call["offset"]),
        inner_shape=tuple(call["inner_shape"]), dx=call["dx"],
        dy=call["dy"], grid_origin=tuple(call["grid_origin"]))
    assert ss.KERNEL_LAUNCHES == n0              # CPU: the plain version
    ref = oracle[f"{name}:metric"]
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert tuple(got.shape) == ref.shape
    got = got.numpy()
    assert np.isfinite(got).all()
    err = np.abs(got - ref)
    print(f"{name}: max |metric - ref| {err.max():.3e} m, "
          f"{int((err > 0).sum())} of {err.size} differ; |ref| up to "
          f"{np.abs(ref).max():.3e}")
    assert err.max() <= METRIC_TOL
    decided = np.abs(ref) > 1.0e-3
    np.testing.assert_array_equal((got > 0)[decided], (ref > 0)[decided])
    assert near_vert.any() == (name == "near_vertical")
    if name == "far_spike":
        # the first two suns look toward the spike: some cells see it, and
        # every one of them only through a mip phase
        plan = ss.plan_shadow(arr["z"].shape,
                              inner_shape=tuple(call["inner_shape"]),
                              offset=tuple(call["offset"]), dx=25.0,
                              dy=-25.0)
        assert plan["n_dense"] * 25.0 < 7000.0
        assert (got[:2] > 0).any() and not (got[2] > 0).any()
    if name == "sun_below":
        assert (got[0] > 0).mean() > 0.5         # sentinel clearance


def test_sun_table_and_plan_match_reference():
    center = _center((128, 128), 25.0, -25.0)
    suns = _suns_about(center, [(2.0e5, 1.0e5, 2.0e4), (0.0, 0.0, 1.0e4),
                                (-3.0e5, 1.0, -5.0e3)])
    got, nv = ss.shadow_sun_table(suns, center, 25.0, -30.0)
    ref, nv_ref = pallas_sweep.shadow_sun_table(suns, center, 25.0, -30.0)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(nv, nv_ref)
    assert nv.tolist() == [False, True, False]
    plan = ss.plan_shadow((128, 96), inner_shape=(64, 32), offset=(32, 32),
                          dx=25.0, dy=-30.0)
    sched = sweep_ref.build_schedule(
        25.0, math.hypot(96 * 25.0, 128 * 30.0), sweep_ref.default_rel_err(
            0.25))
    assert plan["pads"] == sched.pads and plan["dist"] == sched.dist


def test_plain_reads_stay_inside_padded_levels():
    """Rays to the domain diagonal from a block at the grid's corner, in
    eight directions: every read of the plain version lies inside the
    padded levels (its slices are bounds-checked and would raise), and the
    same sweep over levels with too small a pad does raise."""
    z = gaussian_bumps_terrain(40, 40, seed=3, amp=300.0)
    rel = [(1.0e5 * math.sin(a), 1.0e5 * math.cos(a), 1.0e4)
           for a in np.linspace(0.0, 2.0 * np.pi, 8, endpoint=False)]
    arr, call, _ = _metric_case(z, (0, 0), (40, 40), 25.0, -25.0, rel)
    kw = dict(offset=(0, 0), inner_shape=(40, 40), dx=25.0, dy=-25.0,
              grid_origin=(0.0, 0.0))
    zt = torch.from_numpy(z)
    got = ss.shadow_metric_fused(zt, arr["z_org"], arr["z_inner"],
                                 arr["table"], **kw)
    assert torch.isfinite(got).all()
    args = list(ss.metric_args(zt, arr["z_org"], arr["z_inner"],
                               arr["table"], **{k: kw[k] for k in (
                                   "offset", "inner_shape", "dx", "dy")}))
    plan = dict(args[4], pads=tuple(p - 3 for p in args[4]["pads"]))
    args[2], args[4] = mip.padded_levels(zt, plan["pads"]), plan
    with pytest.raises(IndexError, match="outside the padded level"):
        ss._metric_plain(*args, grid_origin=(0.0, 0.0))


def test_metric_entry_validation():
    arr, call, _ = METRIC_CASES["halo8"]
    zt = torch.from_numpy(arr["z"])
    kw = dict(offset=(8, 8), inner_shape=(32, 32), dx=25.0, dy=-25.0,
              grid_origin=(0.0, 0.0))
    with pytest.raises(ValueError, match="does not lie inside"):
        ss.shadow_metric_fused(zt, arr["z_org"], arr["z_inner"],
                               arr["table"], **dict(kw, offset=(20, 8)))
    with pytest.raises(ValueError, match="z_org_r has shape"):
        ss.shadow_metric_fused(zt, arr["z_org"][1:], arr["z_inner"],
                               arr["table"], **kw)
    with pytest.raises(ValueError, match="sun_table"):
        ss.shadow_metric_fused(zt, arr["z_org"], arr["z_inner"],
                               arr["table"][:, :7], **kw)
    with pytest.raises(ValueError, match="no shadow sweep for device"):
        ss.shadow_metric_fused(zt.to("meta"), arr["z_org"], arr["z_inner"],
                               arr["table"], **kw)


# ---------------------------------------------------------------------------
# Terrain against JAX Terrain(engine="pallas")
# ---------------------------------------------------------------------------

def _tie_zone(t, suns, mode):
    """Cells (T, in0, in1) where the port and the reference may round to
    another side of a decision: the metric within 1e-3 m of 0, dot_ts
    within 1e-6 of 0 (and, for sw_dir_cor, of cos(ang_max))."""
    metric, _ = t._metric(np.atleast_2d(suns))
    _, dot_ts = shadow.sun_dots(t._fields, np.atleast_2d(suns),
                                t.refrac_cor)
    tie = (metric.abs() <= 1.0e-3) | (dot_ts.abs() <= 1.0e-6)
    if mode == "sw_dir_cor":
        dot_min = np.float32(math.cos(math.radians(t.ang_max)))
        tie |= (dot_ts - float(dot_min)).abs() <= 1.0e-6
    return tie.numpy()


@pytest.mark.parametrize("name", sorted(TERRAIN_CASES))
def test_terrain_matches_jax_terrain(oracle, name):
    inp, kw, suns = TERRAIN_CASES[name]
    t = _port_terrain(inp, **kw)
    for mode, batch, single in (("shadow", t.shadow_batch, t.shadow),
                                ("sw_dir_cor", t.sw_dir_cor_batch,
                                 t.sw_dir_cor)):
        got = batch(suns)
        assert got.device.type == "cpu" and tuple(got.shape) == (5, 32, 128)
        got = got.numpy()
        ref = oracle[f"{name}:{mode}"]
        tie = _tie_zone(t, suns, mode)
        print(f"{name} {mode}: {int(tie.sum())} of {tie.size} cells in the "
              f"tie zone")
        assert tie.mean() < 0.01
        buf = np.zeros(got.shape[1:], dtype=got.dtype)
        one = single(suns[1], buf).numpy()
        np.testing.assert_array_equal(one, got[1])
        np.testing.assert_array_equal(buf, one)
        ref_one = oracle[f"{name}:{mode}_single"]
        if mode == "shadow":
            assert got.dtype == np.uint8
            np.testing.assert_array_equal(got[~tie], ref[~tie])
            np.testing.assert_array_equal(one[~tie[1]], ref_one[~tie[1]])
            assert set(np.unique(got)) <= {0, 1, 2, 3}
            assert (got[:, inp["mask"] == 0] == 3).all()
            assert (got == 2).any() and (got == 0).any()
        else:
            assert got.dtype == np.float32
            err = np.abs(got - ref)[~tie]
            print(f"{name}: max |sw_dir_cor - ref| {np.nanmax(err):.3e}, "
                  f"max |sw_dir_cor| {np.nanmax(np.abs(got)):.3e}")
            np.testing.assert_allclose(got[~tie], ref[~tie], rtol=SW_RTOL,
                                       atol=SW_TOL)
            np.testing.assert_allclose(one[~tie[1]], ref_one[~tie[1]],
                                       rtol=SW_RTOL, atol=SW_TOL)
            fill = got[:, inp["mask"] == 0]
            if np.isnan(kw["sw_dir_cor_fill"]):
                assert np.isnan(fill).all()
            else:
                assert (fill == kw["sw_dir_cor_fill"]).all()


def test_terrain_runs_on_the_jax_pyramid(oracle):
    """``mip.pyramid_from_jax`` lays the JAX Terrain's initialise-time
    pyramid out as the port's: equal to the port Terrain's own levels, and
    the port's metric on it is the same."""
    name = "mask_nanfill"
    inp, kw, suns = TERRAIN_CASES[name]
    t = _port_terrain(inp, **kw)
    jax_levels = [oracle[f"{name}:level{p}"]
                  for p in range(len(t.plan["pads"]))]
    levels = mip.pyramid_from_jax(jax_levels, t.plan["pads"], "cpu")
    for a, b in zip(levels, t._levels):
        assert torch.equal(a, b)
    want = t._metric(suns)[0]
    t._levels = levels
    assert torch.equal(t._metric(suns)[0], want)


# ---------------------------------------------------------------------------
# Analytic checks (tests/test_shadow.py on the port)
# ---------------------------------------------------------------------------

def test_flat_terrain_sun_up_and_below():
    t = _port_terrain(_planar_inputs(np.zeros((48, 48), np.float32)))
    up = np.array([0.0, 1.0e7, 1.0e7], dtype=np.float32)
    assert (t.shadow(up) == 0).all()
    np.testing.assert_allclose(t.sw_dir_cor(up).numpy(), 1.0, atol=1e-4)
    below = np.array([0.0, 1.0e7, -1.0e6], dtype=np.float32)
    assert (t.shadow(below) == 1).all()
    np.testing.assert_allclose(t.sw_dir_cor(below).numpy(), 0.0, atol=1e-6)


def test_shadow_matches_bruteforce():
    dx = 25.0
    z = gaussian_bumps_terrain(48, 48, seed=11, amp=600.0)
    inp = _planar_inputs(z, dx=dx, off=(8, 8), inner=(32, 32))
    t = _port_terrain(inp)
    sun = np.array([1.0e7, 0.0, 1.5e6], dtype=np.float32)
    sh = t.shadow(sun).numpy()
    occ_ref = brute_shadow(z, dx, -dx, (8, 8), (32, 32), sun, step_frac=0.25)
    sun_u = sun / np.linalg.norm(sun)
    facing = (inp["vec_tilt"] @ sun_u) > 0.0
    got_occ = sh == 2
    frac = (got_occ != occ_ref)[facing].mean()
    assert frac < 0.03, f"shadow mismatch fraction {frac:.3f}"
    assert got_occ.any() and (~got_occ).any()
    assert (~facing[sh == 1]).all()


def test_shadow_mask_and_fill_and_batch():
    z = np.zeros((48, 48), dtype=np.float32)
    inp = _planar_inputs(z)
    inp["vec_tilt"] = inp["vec_norm"].copy()
    inp["surf_enl_fac"] = np.ones((32, 32), dtype=np.float32)
    inp["mask"] = np.ones((32, 32), dtype=np.uint8)
    inp["mask"][:4] = 0
    t = _port_terrain(inp, sw_dir_cor_fill=-7.0)
    sun = np.array([0.0, 1e7, 1e7], dtype=np.float32)
    sh = t.shadow(sun)
    assert sh.dtype == torch.uint8
    assert (sh[:4] == 3).all() and (sh[4:] == 0).all()
    assert (t.sw_dir_cor(sun)[:4] == -7.0).all()
    zb = gaussian_bumps_terrain(48, 48, seed=5, amp=500.0)
    t = _port_terrain(_planar_inputs(zb))
    suns = np.array([[1e7, 0, 2e6], [0, 1e7, 5e6], [-1e7, 0, 1e6]],
                    dtype=np.float32)
    batch, swb = t.shadow_batch(suns), t.sw_dir_cor_batch(suns)
    for i in range(3):
        assert torch.equal(batch[i], t.shadow(suns[i]))
        assert torch.equal(swb[i], t.sw_dir_cor(suns[i]))


def test_sw_dir_cor_mueller_scherer_formula():
    """Unshaded tilted plane: sw_dir_cor = cos(incidence)/cos(zenith) *
    fac."""
    inp = _planar_inputs(np.zeros((48, 48), dtype=np.float32))
    tilt = np.zeros((32, 32, 3), dtype=np.float32)
    tilt[..., 0] = np.sin(np.deg2rad(30.0))
    tilt[..., 2] = np.cos(np.deg2rad(30.0))
    inp.update(vec_tilt=tilt, surf_enl_fac=np.full((32, 32), 1.3,
                                                   dtype=np.float32))
    t = _port_terrain(inp)
    sun = np.array([1e7, 0.0, 1e7], dtype=np.float32) / np.sqrt(2)
    sun_u = np.array([1, 0, 1]) / np.sqrt(2)
    t_u = np.array([np.sin(np.deg2rad(30)), 0, np.cos(np.deg2rad(30))])
    expect = (t_u @ sun_u) / (np.array([0, 0, 1]) @ sun_u) * 1.3
    np.testing.assert_allclose(t.sw_dir_cor(sun).numpy(), expect, atol=5e-3)


# ---------------------------------------------------------------------------
# Module parity and validation
# ---------------------------------------------------------------------------

def test_refraction_matches_reference():
    rng = np.random.default_rng(4)
    elev = np.linspace(-3.0, 92.0, 200).astype(np.float32)
    temp = rng.uniform(-30.0, 35.0, 200).astype(np.float32)
    pres = rng.uniform(50.0, 105.0, 200).astype(np.float32)
    got = refraction.atmos_refrac(torch.from_numpy(elev),
                                  torch.from_numpy(temp),
                                  torch.from_numpy(pres)).numpy()
    ref = np.asarray(refraction_ref.atmos_refrac(elev, temp, pres))
    # 4 float32 ulp: the divisions round once on both sides
    # (test_refraction_divisions_round_once); what remains is XLA's
    # float32 tan, which is not correctly rounded (3.7% of inputs one ulp
    # off) and which 1.02 / tan amplifies near 90 degrees
    assert (np.abs(got - ref) <= 4 * np.spacing(np.abs(ref))).all()
    sun = rng.standard_normal((64, 3)).astype(np.float32)
    sun[:, 2] = np.abs(sun[:, 2]) * 0.3
    sun /= np.linalg.norm(sun, axis=-1, keepdims=True)
    norm = rng.standard_normal((64, 3)).astype(np.float32) * 0.1
    norm[:, 2] = 1.0
    norm /= np.linalg.norm(norm, axis=-1, keepdims=True)
    h = rng.uniform(0.0, 4000.0, 64).astype(np.float32)
    got = refraction.refract_sun_vector(torch.from_numpy(sun),
                                        torch.from_numpy(norm),
                                        torch.from_numpy(h)).numpy()
    ref = np.asarray(refraction_ref.refract_sun_vector(sun, norm, h))
    # 2 ulp at 1: the two sides' float32 arccos, pow, cos and sin
    np.testing.assert_allclose(got, ref, rtol=0, atol=2.4e-7)
    assert (got[:, 2] > sun[:, 2]).mean() > 0.9       # lifts the sun
    theta = rng.uniform(-1.0, 1.0, 64).astype(np.float32)
    got = refraction.rodrigues_rotate(torch.from_numpy(norm),
                                      torch.from_numpy(theta),
                                      torch.from_numpy(sun)).numpy()
    ref = np.asarray(refraction_ref.rodrigues_rotate(norm, theta, sun))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    for name in ("TEMPERATURE_REF", "PRESSURE_REF", "LAPSE_RATE",
                 "BAROMETRIC_EXP"):
        assert getattr(refraction, name) == getattr(refraction_ref, name)


def _torch_fn(name, x):
    t = torch.from_numpy(x)
    if name == "tan":
        return torch.tan(t).numpy()
    return (t ** refraction.BAROMETRIC_EXP).numpy()


def test_refraction_divisions_round_once():
    """Each division of the refraction (``atmos_refrac``'s four,
    ``reference_atmosphere``'s one) bit-equal to NumPy's float32 division
    on the same 200,000 seeded inputs, the torch tan and power evaluated
    on the same values on both sides: a division of a tensor by a tensor
    rounds once, where ``scalar / tensor`` (a reciprocal times the
    scalar) rounds twice."""
    rng = np.random.default_rng(20)
    n = 200_000
    elev = rng.uniform(-2.0, 91.0, n).astype(np.float32)
    temp = rng.uniform(-30.0, 30.0, n).astype(np.float32)
    pres = rng.uniform(50.0, 105.0, n).astype(np.float32)
    height = rng.uniform(-100.0, 4800.0, n).astype(np.float32)
    want = refraction_numpy(elev, temp, pres, height, _torch_fn)
    got = refraction.atmos_refrac(torch.from_numpy(elev),
                                  torch.from_numpy(temp),
                                  torch.from_numpy(pres))
    np.testing.assert_array_equal(got.numpy(), want[0])
    t, p = refraction.reference_atmosphere(torch.from_numpy(height))
    np.testing.assert_array_equal(t.numpy(), want[1])
    np.testing.assert_array_equal(p.numpy(), want[2])


def test_surface_enlargement_factor_matches_reference():
    inp = _planar_inputs(gaussian_bumps_terrain(40, 40, seed=1, amp=800.0))
    got = topo_param.surface_enlargement_factor(inp["vec_norm"],
                                                inp["vec_tilt"])
    assert got.dtype == torch.float32
    np.testing.assert_allclose(
        got.numpy(), topo_ref.surface_enlargement_factor(inp["vec_norm"],
                                                         inp["vec_tilt"]),
        rtol=1e-6)
    assert got.min().item() >= 1.0


def _initialise_both(inp, **kw):
    """The exception (type, message) each package's initialise raises."""
    out = []
    for mod, extra in ((shadow_ref, {}), (shadow, dict(device="cpu"))):
        t = mod.Terrain()
        try:
            t.initialise(inp["vert_grid"], inp["dem_dim"][0],
                         inp["dem_dim"][1], inp["offset"][0],
                         inp["offset"][1], inp["vec_tilt"], inp["vec_norm"],
                         inp["surf_enl_fac"], inp["elevation"], inp["mask"],
                         **kw, **extra)
        except Exception as exc:    # noqa: BLE001 - compared below
            out.append((type(exc), str(exc)))
        else:
            out.append(None)
    return out


def test_initialise_validation_matches_reference():
    base = _planar_inputs(gaussian_bumps_terrain(40, 40, seed=2, amp=300.0))
    tilt_bad = base["vec_tilt"].copy()
    tilt_bad[0, 0] *= 1.1
    for change, kw in [
            (dict(dem_dim=(30, 40)), {}),
            (dict(vec_tilt=base["vec_tilt"][..., :2]), {}),
            (dict(vec_norm=base["vec_norm"][:-1]), {}),
            (dict(surf_enl_fac=base["surf_enl_fac"][:-1]), {}),
            (dict(mask=base["mask"][:, :-1]), {}),
            (dict(vec_tilt=tilt_bad), {}),
            (dict(mask=base["mask"].astype(np.int32)), {}),
            ({}, dict(geom_type="mesh")),
            ({}, dict(ang_max=84.0)),
            ({}, dict(ang_max=89.995)),
            ({}, dict(engine="fast"))]:
        got, ref = _initialise_both(dict(base, **change), **kw)
        assert ref is not None and got == ref, (change, kw, got, ref)


def test_branches_not_ported_raise():
    """Every engine is ported now: "sweep" and "scan" run the XLA engines
    (tests/test_torch_shadow_engines.py); what raises is misuse."""
    base = _planar_inputs(gaussian_bumps_terrain(40, 40, seed=2, amp=300.0))
    for engine in ("sweep", "scan"):
        te = _port_terrain(base, engine=engine)
        assert te.engine == engine
        assert tuple(te.shadow(np.array([1e7, 0.0, 1e6], np.float32))
                     .shape) == base["mask"].shape
    # an irregular (curved) mesh, x varying along rows, now initialises:
    # planarised, its box swept (tests/test_torch_curved_shadow.py)
    h, w = base["dem_dim"]
    xyz = base["vert_grid"][:h * w * 3].reshape(h, w, 3).copy()
    xyz[..., 0] += np.arange(h, dtype=np.float32)[:, None] * 3.0
    curved = dict(base, vert_grid=auxiliary.rearrange_pad_buffer(
        xyz[..., 0], xyz[..., 1], xyz[..., 2]))
    tc = _port_terrain(curved)
    assert tc._curved and tc._back is not None
    assert tuple(tc.shadow(np.array([1e7, 0.0, 1e6], np.float32)).shape) \
        == base["mask"].shape
    t = _port_terrain(base, engine="pallas")
    # sw_dir_cor_soft is ported (tests/test_torch_shadow_grad.py); it takes
    # the heights to differentiate as a tensor of the outer shape
    with pytest.raises(ValueError, match="elevation must be a tensor"):
        t.sw_dir_cor_soft(np.array([1e7, 0.0, 1e6], np.float32),
                          elevation=np.zeros(base["dem_dim"], np.float32))
    with pytest.raises(ValueError, match="incorrect shape"):
        t.shadow(np.zeros(4, np.float32))
    with pytest.raises(RuntimeError, match="not initialised"):
        shadow.Terrain().shadow(np.zeros(3, np.float32))
