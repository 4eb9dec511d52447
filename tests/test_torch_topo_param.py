"""The port's topographic parameters (``horayzon_tpu_torch.topo_param``) on
the CPU against the JAX package's.

* ``slope_vector_meth`` without and with ``rot_mat`` (and ``output_rot``),
  ``visible_sky_fraction``, ``topographic_openness`` and
  ``sky_view_factor`` (which shares the plane clamp with the visible sky
  fraction) against the JAX functions on a bumpy planar scene and a
  curved ENU mesh: the unit vectors within :data:`VEC_ULP` ulp of 1 of
  the reference's (measured: 1.5), the NaN border equal; the sky
  parameters within :data:`SKY_ULP` ulp of the reference's value (the
  azimuth sums run in another order; measured: at most 4).
* ``tests/test_topo_param.py:26-92``'s analytic checks on the port.
* The validation errors equal to the reference's.

The reference runs in one subprocess under
``test_torch_fused_sweep.AS_WRITTEN_XLA_FLAGS``.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from horayzon_tpu import topo_param as topo_ref
from horayzon_tpu_torch import topo_param

from reference_impl import gaussian_bumps_terrain
from test_torch_fused_sweep import AS_WRITTEN_XLA_FLAGS, _REPO
from torch_scenes import bumps, curved_setup

#: unit vectors: |port - reference| <= VEC_ULP * 2**-23
VEC_ULP = 4
#: sky parameters: |port - reference| <= SKY_ULP * ulp(reference)
SKY_ULP = 8

_ORACLE = r"""
import json, sys
import numpy as np
from horayzon_tpu import topo_param as tp
inputs = np.load(sys.argv[1])
calls = json.load(open(sys.argv[2]))
out = {}
for name, c in calls.items():
    a = {k[len(name) + 1:]: inputs[k] for k in inputs.files
         if k.startswith(name + ":")}
    if c["kind"] == "slope":
        rot = a.get("rot")
        out[name] = tp.slope_vector_meth(a["x"], a["y"], a["z"],
                                         rot_mat=rot,
                                         output_rot=c["output_rot"])
    else:
        out[name + ":vsf"] = tp.visible_sky_fraction(a["azim"], a["hori"],
                                                     a["tilt"])
        out[name + ":svf"] = tp.sky_view_factor(a["azim"], a["hori"],
                                                a["tilt"])
        out[name + ":open"] = tp.topographic_openness(a["azim"], a["hori"])
np.savez(sys.argv[3], **out)
"""


def _rotations(shape, seed):
    """Seeded per-cell rotation matrices (H, W, 3, 3) float32: a tilt of up
    to 0.2 rad about a random horizontal axis, then a turn about z."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.0, 2.0 * np.pi, shape)
    t = rng.uniform(0.0, 0.2, shape)
    b = rng.uniform(0.0, 2.0 * np.pi, shape)
    axis = np.stack([np.cos(b), np.sin(b), np.zeros(shape)], -1)
    k = np.zeros(shape + (3, 3))
    k[..., 0, 2], k[..., 2, 0] = axis[..., 1], -axis[..., 1]
    k[..., 1, 2], k[..., 2, 1] = -axis[..., 0], axis[..., 0]
    eye = np.eye(3)
    tilt = (eye + np.sin(t)[..., None, None] * k
            + (1 - np.cos(t))[..., None, None] * (k @ k))
    turn = np.zeros(shape + (3, 3))
    turn[..., 0, 0], turn[..., 0, 1] = np.cos(a), -np.sin(a)
    turn[..., 1, 0], turn[..., 1, 1] = np.sin(a), np.cos(a)
    turn[..., 2, 2] = 1.0
    return (turn @ tilt).astype(np.float32)


def _grids():
    """name -> (x, y, z) float32: a bumpy planar grid (north up, 25 m) and
    a curved ENU mesh (tests/test_curved.py's, 0.002 degree)."""
    z = gaussian_bumps_terrain(40, 52, seed=3, amp=800.0)
    x, y = np.meshgrid(np.arange(52, dtype=np.float32) * 25.0,
                       -np.arange(40, dtype=np.float32) * 25.0)
    s = curved_setup(bumps(4), n=48)
    return {"bumps": (x, y, z),
            "curved": tuple(s[k].astype(np.float32) for k in "xyz")}


GRIDS = _grids()
ROT = {"none": (False, False), "rot": (True, False),
       "rot_output": (True, True)}
SLOPE_CASES = [(g, r) for g in sorted(GRIDS) for r in ROT]


def _sky_inputs(grid):
    """(azim, hori, tilt) of a grid: 72 azimuths, a seeded horizon from
    -0.3 to 1.2 rad and the grid's interior tilted normals."""
    x, y, z = GRIDS[grid]
    tilt = np.asarray(topo_ref.slope_vector_meth(x, y, z))[1:-1, 1:-1]
    azim = (2.0 * np.pi / 72 * np.arange(72)).astype(np.float32)
    hori = np.random.default_rng(len(grid)).uniform(
        -0.3, 1.2, tilt.shape[:2] + (72,)).astype(np.float32)
    return azim, hori, np.ascontiguousarray(tilt)


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    """Every reference result of this file from one subprocess."""
    tmp = tmp_path_factory.mktemp("topo_oracle")
    arrays, calls = {}, {}
    for grid, rot in SLOPE_CASES:
        name = f"{grid}:{rot}"
        x, y, z = GRIDS[grid]
        use_rot, output_rot = ROT[rot]
        calls[name] = dict(kind="slope", output_rot=output_rot)
        arrays.update({f"{name}:x": x, f"{name}:y": y, f"{name}:z": z})
        if use_rot:
            arrays[f"{name}:rot"] = _rotations(x.shape, len(name))
    for grid in GRIDS:
        name = f"sky:{grid}"
        calls[name] = dict(kind="sky")
        azim, hori, tilt = _sky_inputs(grid)
        arrays.update({f"{name}:azim": azim, f"{name}:hori": hori,
                       f"{name}:tilt": tilt})
    paths = [str(tmp / n) for n in ("in.npz", "calls.json", "out.npz")]
    np.savez(paths[0], **arrays)
    with open(paths[1], "w") as f:
        json.dump(calls, f)
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": AS_WRITTEN_XLA_FLAGS,
           "PYTHONPATH": os.pathsep.join(
               [_REPO, os.environ.get("PYTHONPATH", "")])}
    res = subprocess.run([sys.executable, "-c", _ORACLE, *paths], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    out = np.load(paths[2])
    return {k: out[k] for k in out.files}


@pytest.mark.parametrize("grid, rot", SLOPE_CASES)
def test_slope_vector_meth_matches_jax(oracle, grid, rot):
    name = f"{grid}:{rot}"
    x, y, z = GRIDS[grid]
    use_rot, output_rot = ROT[rot]
    got = topo_param.slope_vector_meth(
        x, y, z, rot_mat=_rotations(x.shape, len(name)) if use_rot else None,
        output_rot=output_rot)
    assert got.dtype == torch.float32 and tuple(got.shape) == x.shape + (3,)
    got, ref = got.numpy(), oracle[name]
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    assert np.isnan(got[0]).all() and np.isnan(got[:, -1]).all()
    inner = got[1:-1, 1:-1]
    assert np.isfinite(inner).all()
    if not output_rot:
        assert (inner[..., 2] > 0.0).all()
    err = np.nanmax(np.abs(got - ref))
    print(f"{name}: max |vec - ref| {err:.3e} ({err / 2.0 ** -23:.1f} ulp "
          f"of 1)")
    assert err <= VEC_ULP * 2.0 ** -23


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_sky_parameters_match_jax(oracle, grid):
    azim, hori, tilt = _sky_inputs(grid)
    for key, got in (
            ("vsf", topo_param.visible_sky_fraction(azim, hori, tilt)),
            ("svf", topo_param.sky_view_factor(azim, hori, tilt)),
            ("open", topo_param.topographic_openness(azim, hori))):
        ref = oracle[f"sky:{grid}:{key}"]
        assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
        ulps = np.abs(got.numpy() - ref) / np.spacing(np.abs(ref))
        print(f"{grid} {key}: at most {ulps.max():.0f} ulp; range "
              f"[{ref.min():.4f}, {ref.max():.4f}]")
        assert ulps.max() <= SKY_ULP


# ---------------------------------------------------------------------------
# tests/test_topo_param.py:26-92 on the port
# ---------------------------------------------------------------------------

def _plane_grid(a=0.3, b=-0.2, n=8, d=10.0):
    x1 = np.arange(n) * d
    x, y = np.meshgrid(x1, x1)
    z = a * x + b * y
    return (x.astype(np.float32), y.astype(np.float32),
            z.astype(np.float32))


def test_slope_vector_meth_inclined_plane():
    a, b = 0.1, 0.25
    vec = topo_param.slope_vector_meth(*_plane_grid(a, b)).numpy()
    expect = np.array([-a, -b, 1.0])
    expect = expect / np.linalg.norm(expect)
    assert np.isnan(vec[0, 0]).all()
    assert np.allclose(vec[1:-1, 1:-1], expect, atol=1e-5)


def test_slope_methods_agree_on_smooth_terrain():
    n, d = 12, 25.0
    x, y = np.meshgrid(np.arange(n) * d, np.arange(n) * d)
    z = (100.0 * np.sin(x / 150.0) * np.cos(y / 200.0)).astype(np.float32)
    args = (x.astype(np.float32), y.astype(np.float32), z)
    v1 = topo_param.slope_plane_meth(*args).numpy()
    v2 = topo_param.slope_vector_meth(*args).numpy()
    dots = np.sum(v1[1:-1, 1:-1] * v2[1:-1, 1:-1], axis=-1)
    assert (dots > 0.999).all()


@pytest.mark.parametrize("method", ["slope_plane_meth",
                                    "slope_vector_meth"])
def test_slope_with_identity_rot(method):
    x, y, z = _plane_grid()
    rot = np.zeros(x.shape + (3, 3), dtype=np.float32)
    rot[...] = np.eye(3, dtype=np.float32)
    fn = getattr(topo_param, method)
    v_no = fn(x, y, z)
    for output_rot in (False, True):
        v_id = fn(x, y, z, rot_mat=rot, output_rot=output_rot)
        torch.testing.assert_close(v_id[1:-1, 1:-1], v_no[1:-1, 1:-1],
                                   rtol=0, atol=1e-6)


def _flat(shape, a_num):
    azim = np.linspace(0, 2 * np.pi, a_num, endpoint=False).astype(
        np.float32)
    tilt = np.zeros(shape + (3,), dtype=np.float32)
    tilt[..., 2] = 1.0
    return azim, tilt


def test_visible_sky_fraction_flat():
    azim, tilt = _flat((3, 3), 24)
    vsf = topo_param.visible_sky_fraction(
        azim, np.zeros((3, 3, 24), np.float32), tilt)
    assert np.allclose(vsf.numpy(), 1.0, atol=1e-5)


def test_sky_view_factor_flat_and_blocked():
    azim, tilt = _flat((4, 5), 36)
    svf = topo_param.sky_view_factor(azim, np.zeros((4, 5, 36), np.float32),
                                     tilt)
    assert np.allclose(svf.numpy(), 1.0, atol=1e-5)
    hori = np.full((4, 5, 36), np.pi / 2 - 1e-4, dtype=np.float32)
    assert np.allclose(topo_param.sky_view_factor(azim, hori, tilt).numpy(),
                       0.0, atol=1e-3)
    assert np.allclose(
        topo_param.visible_sky_fraction(azim, hori, tilt).numpy(), 0.0,
        atol=1e-3)


def test_topographic_openness():
    azim = np.linspace(0, 2 * np.pi, 8, endpoint=False).astype(np.float32)
    hori = np.full((2, 2, 8), np.deg2rad(10.0), dtype=np.float32)
    top = topo_param.topographic_openness(azim, hori)
    assert top.dtype == torch.float32
    assert np.allclose(top.numpy(), np.pi / 2 - np.deg2rad(10.0), atol=1e-6)


# ---------------------------------------------------------------------------
# Validation
# ---------------------------------------------------------------------------

def _both_raise(fn_name, *args, **kw):
    out = []
    for mod in (topo_ref, topo_param):
        with pytest.raises(ValueError) as info:
            getattr(mod, fn_name)(*args, **kw)
        out.append(str(info.value))
    return out


def test_validation_matches_reference():
    x, y, z = _plane_grid()
    rot = np.zeros(x.shape + (3, 3), dtype=np.float32)
    azim, tilt = _flat((3, 3), 24)
    hori = np.zeros((3, 3, 24), np.float32)
    for fn, args, kw in [
            ("slope_vector_meth", (x, y, z[:-1]), {}),
            ("slope_vector_meth", (x, y, z), dict(output_rot=True)),
            ("slope_vector_meth", (x, y, z), dict(rot_mat=rot[:-1])),
            ("slope_vector_meth", (x.astype(np.int32), y, z), {}),
            ("visible_sky_fraction", (azim[:-1], hori, tilt), {}),
            ("visible_sky_fraction", (azim, hori, tilt[:-1]), {}),
            ("visible_sky_fraction", (azim, hori, tilt[..., :2]), {}),
            ("visible_sky_fraction", (azim, hori.astype(np.int32), tilt),
             {}),
            ("topographic_openness", (azim[:-1], hori), {})]:
        got, ref = _both_raise(fn, *args, **kw)[::-1]
        assert got == ref, (fn, got, ref)
