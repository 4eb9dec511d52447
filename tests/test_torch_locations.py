"""The port's per-location horizon (``horizon.horizon_locations``,
``ops/locations.py``, plain torch) on the CPU, against the JAX package.

``tests/test_locations.py``'s five cases and
``tests/test_curved.py::test_curved_locations`` run on the port, and each
of their inputs also through JAX ``horizon_locations`` in one subprocess
under ``test_torch_fused_sweep.AS_WRITTEN_XLA_FLAGS``:

* ``hori`` within :data:`HORI_TOL` rad of the reference's (measured: at
  most one float32 ulp, 6e-8 rad, where XLA's float32 arctan and the
  port's correctly rounded one differ);
* ``hori_dist`` (the distance to the winning sample over ``cos(hori)``)
  equal wherever ``hori`` is, and within :data:`DIST_RTOL` where ``hori``
  differs by that ulp.  A different winner would move it by a whole sample
  step (at least 1e-3 relative), so this holds the winners equal.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from horayzon_tpu import horizon as horizon_ref
from horayzon_tpu_torch import auxiliary, horizon
from horayzon_tpu_torch.ops import locations

from reference_impl import gaussian_bumps_terrain
from test_torch_fused_sweep import AS_WRITTEN_XLA_FLAGS, _REPO
from torch_scenes import curved_setup, wall

#: hori against the reference [rad]
HORI_TOL = 1.0e-6
#: hori_dist against the reference where hori differs by an ulp: 1/cos of
#: an angle one ulp away, relative
DIST_RTOL = 1.0e-6

_ORACLE = r"""
import json, sys
import numpy as np
from horayzon_tpu import horizon
inputs = np.load(sys.argv[1])
calls = json.load(open(sys.argv[2]))
out = {}
for name, c in calls.items():
    a = {k[len(name) + 1:]: inputs[k] for k in inputs.files
         if k.startswith(name + ":")}
    kw = dict(c["kw"])
    if "roe" in a:
        kw["ray_org_elev"] = a["roe"]
    hori, dist, azim = horizon.horizon_locations(
        a["vg"], c["dem"][0], c["dem"][1], a["coords"], a["vn"], a["vno"],
        hori_dist_out=True, **kw)
    out[name + ":hori"], out[name + ":dist"] = hori, dist
np.savez(sys.argv[3], **out)
"""


def _vert_grid_planar(z, dx=25.0):
    h, w = z.shape
    x1 = np.arange(w, dtype=np.float32) * dx
    y1 = -np.arange(h, dtype=np.float32) * dx
    x, y = np.meshgrid(x1, y1)
    return auxiliary.rearrange_pad_buffer(x, y, z), x, y


def _loc_vectors(n):
    vn = np.zeros((n, 3), dtype=np.float32)
    vn[:, 2] = 1.0
    vno = np.zeros((n, 3), dtype=np.float32)
    vno[:, 1] = 1.0
    return vn, vno


def _wall_north_of_row_30():
    z = np.zeros((64, 64), dtype=np.float32)
    z[10, :] = 200.0                       # a wall 500 m north of row 30
    return z


def _cases():
    """name -> (vert_grid, dem shape, coords, vn, vno, ray_org_elev or
    None, keywords): tests/test_locations.py's inputs and
    tests/test_curved.py::test_curved_locations'."""
    cases = {}
    z = gaussian_bumps_terrain(48, 48, seed=3, amp=300.0)
    vg, x, y = _vert_grid_planar(z)
    cells = [(20, 20), (23, 24), (27, 27)]
    coords = np.array([[x[i, j], y[i, j], z[i, j]] for i, j in cells],
                      dtype=np.float32)
    cases["gridded_cells"] = (vg, z.shape, coords, *_loc_vectors(3), None,
                              dict(dist_search=0.8, azim_num=12,
                                   elev_ang_low_lim=-15.0))
    z = _wall_north_of_row_30()
    vg, x, y = _vert_grid_planar(z)
    cases["wall"] = (vg, z.shape, np.array([[x[30, 32], y[30, 32], 0.0]],
                                           dtype=np.float32),
                     *_loc_vectors(1), None,
                     dict(dist_search=1.5, azim_num=4))
    z = np.zeros((32, 32), dtype=np.float32)
    z[10, :] = 100.0
    vg, x, y = _vert_grid_planar(z)
    cases["ray_org_elev"] = (
        vg, z.shape, np.array([[x[20, 16], y[20, 16], 0.0]] * 2,
                              dtype=np.float32), *_loc_vectors(2),
        np.array([0.01, 300.0], dtype=np.float32),
        dict(dist_search=1.0, azim_num=4, elev_ang_low_lim=-89.0))
    z = gaussian_bumps_terrain(48, 48, seed=11, amp=300.0)
    vg, x, y = _vert_grid_planar(z)
    rng = np.random.default_rng(0)
    ii, jj = rng.integers(16, 32, 37), rng.integers(16, 32, 37)
    cases["many"] = (vg, z.shape, np.stack([x[ii, jj], y[ii, jj], z[ii, jj]],
                                           axis=-1).astype(np.float32),
                     *_loc_vectors(37), None,
                     dict(dist_search=0.8, azim_num=12,
                          elev_ang_low_lim=-15.0))
    s = curved_setup(wall(45.0 + 0.03, 600.0), n=100)
    i, j = 50, 50
    cases["curved_wall"] = (
        auxiliary.rearrange_pad_buffer(s["x"], s["y"], s["z"]), (100, 100),
        np.array([[s["x"][i, j], s["y"][i, j], s["z"][i, j]]],
                 dtype=np.float32),
        s["vec_norm"][i:i + 1, j], s["vec_north"][i:i + 1, j], None,
        dict(dist_search=8.0, azim_num=8, elev_ang_low_lim=-15.0))
    return cases


CASES = _cases()


def _port(name, **kw):
    vg, dem, coords, vn, vno, roe, args = CASES[name]
    if roe is not None:
        args = dict(args, ray_org_elev=roe)
    return horizon.horizon_locations(vg, dem[0], dem[1], coords, vn, vno,
                                     device="cpu", **dict(args, **kw))


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    """Every reference result of this file from one subprocess."""
    tmp = tmp_path_factory.mktemp("locations_oracle")
    arrays, calls = {}, {}
    for name, (vg, dem, coords, vn, vno, roe, kw) in CASES.items():
        calls[name] = dict(dem=list(dem), kw=kw)
        arrays.update({f"{name}:vg": vg, f"{name}:coords": coords,
                       f"{name}:vn": vn, f"{name}:vno": vno})
        if roe is not None:
            arrays[f"{name}:roe"] = roe
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


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_jax_horizon_locations(oracle, name):
    hori, dist, azim = _port(name, hori_dist_out=True)
    assert hori.dtype == torch.float32 and hori.device.type == "cpu"
    hori, dist = hori.numpy(), dist.numpy()
    ref_h, ref_d = oracle[f"{name}:hori"], oracle[f"{name}:dist"]
    assert hori.shape == ref_h.shape == dist.shape
    np.testing.assert_array_equal(azim.numpy(),
                                  horizon_ref.azimuth_angles(hori.shape[1]))
    same = hori == ref_h
    print(f"{name}: max |hori - ref| {np.abs(hori - ref_h).max():.3e} rad, "
          f"{int((~same).sum())} of {hori.size} differ; "
          f"{int((dist != ref_d).sum())} distances differ")
    np.testing.assert_allclose(hori, ref_h, rtol=0, atol=HORI_TOL)
    np.testing.assert_array_equal(dist[same], ref_d[same])
    np.testing.assert_allclose(dist, ref_d, rtol=DIST_RTOL, atol=0)


# ---------------------------------------------------------------------------
# tests/test_locations.py and test_curved.py::test_curved_locations on the
# port
# ---------------------------------------------------------------------------

def test_locations_match_gridded():
    vg, _, coords, vn, vno, _, kw = CASES["gridded_cells"]
    vec_norm = np.zeros((8, 8, 3), dtype=np.float32)
    vec_norm[..., 2] = 1.0
    vec_north = np.zeros((8, 8, 3), dtype=np.float32)
    vec_north[..., 1] = 1.0
    hori_g, azim = horizon.horizon_gridded(
        vg, 48, 48, vec_norm, vec_north, 20, 20, dist_search=0.8,
        azim_num=12, elev_ang_low_lim=-15.0, verbose=False, device="cpu")
    hori_l, azim_l = _port("gridded_cells")
    torch.testing.assert_close(azim_l, azim)
    for k, (i, j) in enumerate([(0, 0), (3, 4), (7, 7)]):
        d = np.rad2deg((hori_l[k] - hori_g[i, j]).abs().max().item())
        assert d < 0.4, f"cell {i},{j}: max diff {d:.3f} deg"


def test_locations_hori_dist():
    hori, dist, _ = _port("wall", hori_dist_out=True)
    assert np.isclose(hori[0, 0].item(), np.arctan(200.0 / 500.0),
                      atol=np.deg2rad(0.6))
    assert np.isclose(dist[0, 0].item(), np.hypot(500.0, 200.0), rtol=0.08)


def _both_raise(**kw):
    """The (type, message) each package's horizon_locations raises."""
    z = np.zeros((16, 16), dtype=np.float32)
    vg, _, _ = _vert_grid_planar(z)
    coords = np.zeros((2, 3), dtype=np.float32)
    vn, vno = _loc_vectors(2)
    args = dict(dict(coords=coords, vec_norm=vn, vec_north=vno), **kw)
    out = []
    for fn, extra in ((horizon_ref.horizon_locations, {}),
                      (horizon.horizon_locations, dict(device="cpu"))):
        with pytest.raises((ValueError, TypeError)) as info:
            fn(vg, 16, 16, dist_search=0.2, **args, **extra)
        out.append((info.type, str(info.value)))
    return out


def test_locations_validation():
    vn, vno = _loc_vectors(2)
    for kw in (dict(ray_algorithm="bogus"),
               dict(ray_org_elev=np.array([0.0], dtype=np.float32)),
               dict(ray_org_elev=np.array([0.01] * 3, dtype=np.float32)),
               dict(coords=np.zeros((3, 3), np.float32)),
               dict(vec_north=vno[:, :2]),
               dict(hori_acc=11.0)):
        got, ref = _both_raise(**kw)
        assert got == ref, (kw, got, ref)
    assert _both_raise(ray_algorithm="bogus")[1][0] is ValueError
    assert _both_raise(ray_org_elev=np.float32([0.0]))[1][0] is TypeError


def test_locations_per_location_ray_org_elev():
    hori, _ = _port("ray_org_elev")
    assert hori[0, 0] > np.deg2rad(10.0)
    assert hori[1, 0] < 0.0


def test_locations_chunked_matches_unchunked(monkeypatch):
    h_one, d_one, _ = _port("many", hori_dist_out=True)
    # one location per chunk, through the padded-tail path too
    monkeypatch.setattr(locations, "MAX_GATHER_ELEMS", 1)
    h_chunk, d_chunk, _ = _port("many", hori_dist_out=True)
    assert torch.equal(h_chunk, h_one) and torch.equal(d_chunk, d_one)
    # three chunks of 16, the last padded with 11 copies
    sched_m = 12 * max(len(s) for s in locations._sweep.build_schedule(
        25.0, 800.0, locations._sweep.default_rel_err(0.25)).s_values)
    monkeypatch.setattr(locations, "MAX_GATHER_ELEMS", 16 * sched_m)
    h_16, d_16, _ = _port("many", hori_dist_out=True)
    assert torch.equal(h_16, h_one) and torch.equal(d_16, d_one)


def test_curved_locations():
    """A wall 3.3 km north of a location on a curved mesh (planarised)."""
    hori, _ = _port("curved_wall")
    expect = np.arctan(600.0 / (0.03 * 111.1e3))
    assert abs(hori[0, 0].item() - expect) < np.deg2rad(1.0)
    assert abs(hori[0, 4].item()) < np.deg2rad(0.5)
