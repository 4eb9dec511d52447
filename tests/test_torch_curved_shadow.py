"""The port's shadow engine on curved meshes on the CPU, against the JAX
package.

A curved (irregular) mesh is planarised onto a regular lattice; the sweep
runs over the box of the inner cells' lattice positions, and the metric is
read back at each cell's nearest lattice cell before the classification
(``horayzon_tpu/shadow.py:309-353, 118-121``).

* **State carried across:** the port's box (``offset``, ``comp_shape``),
  lattice ray origins ``z_org_r`` and heights ``z_inner_r``, the box's
  normal ``norm_r_z`` and the back-map ``(bi, bj)`` equal to the JAX
  ``Terrain``'s on the same mesh.
* **Queries:** ``shadow``/``sw_dir_cor`` and both ``*_batch`` calls against
  JAX ``Terrain(engine="pallas")._run_pallas(..., interpret=True)`` on two
  curved scenes, one plain, one with refraction, a mask and a numeric fill:
  codes equal outside the tie zone of ``tests/test_torch_shadow.py`` (the
  metric within 1e-3 m of 0, a sun dot product within 1e-6 of a
  threshold), ``sw_dir_cor`` within its ``SW_TOL`` + ``SW_RTOL``.  The
  reference pads its box to tile multiples and takes its safe steps from
  the padded box; the port sweeps the box as it is.  The scenes leave the
  lattice room for that padding (``horayzon_tpu/horizon.py:327-343``).
* **tests/test_curved.py:130-185 on the port:** the wall and the
  refraction smoke.
* **Soft path:** ``sw_dir_cor_soft``'s value and its gradient w.r.t. the
  lattice ``elevation`` against ``jax.vjp`` through the reference's
  ``sw_dir_cor_soft(..., interpret=True)``: the value within
  ``SW_TOL`` + ``SW_RTOL`` outside the tie zone (the fully soft value
  equal wherever the metrics agree), the gradient within :data:`GRAD_TOL`
  of max|g|.
* **Central differences** of the fully soft factor on a small curved
  scene: the classification fields stay at their ``initialise`` values, so
  the function differentiated is the one evaluated, and its gradient is
  held to central differences within :data:`FD_RTOL`.
* **The back-map's inverse:** the deterministic gather backward
  (:class:`horayzon_tpu_torch.shadow._GatherCells`) on a map where several
  cells share a lattice cell, equal to autograd's accumulating backward of
  the same index.

The reference runs in one subprocess under
``test_torch_fused_sweep.AS_WRITTEN_XLA_FLAGS``.
"""

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from horayzon_tpu_torch import shadow

from test_torch_fused_sweep import AS_WRITTEN_XLA_FLAGS, _REPO
from test_torch_shadow import SW_RTOL, SW_TOL
from torch_scenes import bumps, curved_setup, curved_terrain_inputs, wall

#: Gradient tolerance, relative to max |.| of the reference's gradient
#: (the two sum the same terms in another order)
GRAD_TOL = 1.0e-5
#: Central differences of the fully soft factor against the gradient's
#: directional derivative, relative (measured: 1.2e-3 along a smooth bump)
FD_RTOL = 2.0e-2
#: soft_tau [m] of the soft cases: the sigmoid's slope is not zero in
#: float32 at the metres of clearance the terrain gives
SOFT_TAU = 8.0

_ORACLE = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from horayzon_tpu import shadow
inputs = np.load(sys.argv[1])
calls = json.load(open(sys.argv[2]))
out = {}
for name, c in calls.items():
    a = {k[len(name) + 1:]: inputs[k] for k in inputs.files
         if k.startswith(name + ":")}
    t = shadow.Terrain()
    t.initialise(a["vert_grid"], c["dem_dim"][0], c["dem_dim"][1],
                 c["offset"][0], c["offset"][1], a["vec_tilt"], a["vec_norm"],
                 a["surf_enl_fac"], a["elevation"], a["mask"],
                 sw_dir_cor_fill=c["fill"], refrac_cor=c["refrac_cor"],
                 engine="pallas")
    out[name + ":box"] = np.array(list(t.offset) + list(t.comp_shape))
    out[name + ":padded"] = np.array(t._pallas_shape)
    for k in ("z_org_r", "z_inner_r", "norm_r_z", "bi", "bj"):
        out[name + ":" + k] = np.asarray(t._fields[k])
    for mode in ("shadow", "sw_dir_cor"):
        out[name + ":" + mode] = np.asarray(
            t._run_pallas(a["suns"], mode, interpret=True))
        out[name + ":" + mode + "_single"] = np.asarray(
            t._run_pallas(a["suns"][1], mode, interpret=True))
    for st in c["soft"]:
        val, vjp = jax.vjp(lambda zz: t.sw_dir_cor_soft(
            a["suns"], elevation=zz, soft_tau=c["soft_tau"],
            straight_through=st, interpret=True), t._z_outer)
        keep = jnp.asarray(a["mask"] == 1)
        (dz,) = vjp(jnp.where(keep, jnp.asarray(a["w"]), 0.0))
        out[f"{name}:soft{st}"] = np.asarray(val)
        out[f"{name}:dz{st}"] = np.asarray(dz)
np.savez(sys.argv[3], **out)
"""


def _scenes():
    """Two curved meshes on the sphere, 160^2 cells of 0.002 degree: one
    around (7, 45) (lattice 226 x 160 at 157 m), one around (-36.3,
    -54.35) (275 x 161 at 130 m) with refraction, a mask and a numeric fill.
    Each inner block sits near the west edge, so that the reference's box
    padded to 128 columns fits the lattice."""
    a = curved_setup(bumps(4), n=160)
    b = curved_setup(bumps(9, count=10, amp=(200.0, 900.0)), n=160,
                     lat0=-54.35, lon0=-36.3)
    mask = np.ones((40, 64), np.uint8)
    mask[:5, :12] = 0
    mask[25:, 50:] = 0
    suns = np.array([[1.0e7, 0.0, 1.5e6], [-4.0e6, 8.0e6, 1.0e6],
                     [2.0e6, -1.0e7, 3.0e6], [0.0, 1.0e7, -1.0e5],
                     [-1.0e7, -2.0e6, 6.0e5]], dtype=np.float32)
    return {
        "bumps45": (curved_terrain_inputs(a, (56, 16), (48, 64)),
                    dict(sw_dir_cor_fill=np.nan, refrac_cor=False), suns,
                    (True, False)),
        "south_refrac_mask": (curved_terrain_inputs(b, (60, 12), (40, 64),
                                                    mask),
                              dict(sw_dir_cor_fill=-7.0, refrac_cor=True),
                              suns, (True,)),
    }


SCENES = _scenes()
SOFT_CASES = [(name, st) for name in sorted(SCENES)
              for st in SCENES[name][3]]


def _port_terrain(inp, **kw):
    t = shadow.Terrain()
    t.initialise(inp["vert_grid"], inp["dem_dim"][0], inp["dem_dim"][1],
                 inp["offset"][0], inp["offset"][1], inp["vec_tilt"],
                 inp["vec_norm"], inp["surf_enl_fac"], inp["elevation"],
                 inp["mask"], device="cpu", **kw)
    return t


def _weights(name):
    """The seeded cotangent of a soft case: standard normal, zero on masked
    cells (the reference's fill there carries no gradient)."""
    inp, _, suns, _ = SCENES[name]
    w = np.random.default_rng(sorted(SCENES).index(name)).standard_normal(
        (suns.shape[0],) + inp["mask"].shape).astype(np.float32)
    return w * (inp["mask"] == 1)


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    """Every reference result of this file from one subprocess."""
    tmp = tmp_path_factory.mktemp("curved_shadow_oracle")
    arrays, calls = {}, {}
    for name, (inp, kw, suns, soft) in SCENES.items():
        calls[name] = dict(dem_dim=list(inp["dem_dim"]),
                           offset=list(inp["offset"]),
                           fill=float(kw["sw_dir_cor_fill"]),
                           refrac_cor=kw["refrac_cor"], soft=list(soft),
                           soft_tau=SOFT_TAU)
        arrays.update({f"{name}:{k}": inp[k] for k in (
            "vert_grid", "vec_tilt", "vec_norm", "surf_enl_fac",
            "elevation", "mask")})
        arrays[f"{name}:suns"] = suns
        arrays[f"{name}:w"] = _weights(name)
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


@pytest.fixture(scope="module")
def terrains():
    return {name: _port_terrain(inp, **kw)
            for name, (inp, kw, _, _) in SCENES.items()}


def _tie_zone(t, suns, mode):
    """Cells (T, in0, in1) where the port and the reference may round to
    another side of a decision: the metric read back at the cell within
    1e-3 m of 0, dot_ts within 1e-6 of 0 (and, for sw_dir_cor, of
    cos(ang_max))."""
    metric, _ = t._metric(np.atleast_2d(suns), plain=True)
    _, dot_ts = shadow.sun_dots(t._fields, np.atleast_2d(suns),
                                t.refrac_cor)
    tie = (t.at_cells(metric).abs() <= 1.0e-3) | (dot_ts.abs() <= 1.0e-6)
    if mode == "sw_dir_cor":
        dot_min = np.float32(math.cos(math.radians(t.ang_max)))
        tie |= (dot_ts - float(dot_min)).abs() <= 1.0e-6
    return tie.numpy()


# ---------------------------------------------------------------------------
# State and queries against JAX Terrain(engine="pallas")
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(SCENES))
def test_state_matches_jax_terrain(oracle, terrains, name):
    t = terrains[name]
    inp = SCENES[name][0]
    box = oracle[f"{name}:box"]
    assert t.offset == tuple(box[:2]) and t.comp_shape == tuple(box[2:])
    assert t._curved and t.inner_shape == inp["mask"].shape
    # the reference pads its box to tile multiples inside the lattice
    p0, p1 = oracle[f"{name}:padded"]
    assert p1 == 128 and t.offset[1] + p1 <= t._z_outer.shape[1]
    print(f"{name}: lattice {tuple(t._z_outer.shape)}, box {t.comp_shape} "
          f"at {t.offset} (reference padded to {(int(p0), int(p1))}), "
          f"planarised in {t.planarize_s:.3f} s")
    for key in ("z_org_r", "z_inner_r", "norm_r_z"):
        np.testing.assert_array_equal(t._fields[key].numpy(),
                                      oracle[f"{name}:{key}"])
    bi, bj, cells = t._back
    np.testing.assert_array_equal(bi.numpy(), oracle[f"{name}:bi"])
    np.testing.assert_array_equal(bj.numpy(), oracle[f"{name}:bj"])
    # every cell appears once in the inverse table, at its box cell
    flat = (bi * t.comp_shape[1] + bj).flatten()
    n = flat.numel()
    rows, ks = torch.nonzero(cells < n, as_tuple=True)
    assert rows.numel() == n
    assert torch.equal(flat[cells[rows, ks]], rows)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_queries_match_jax_terrain(oracle, terrains, name):
    inp, kw, suns, _ = SCENES[name]
    t = terrains[name]
    n0 = shadow._ss.KERNEL_LAUNCHES
    for mode, batch, single in (("shadow", t.shadow_batch, t.shadow),
                                ("sw_dir_cor", t.sw_dir_cor_batch,
                                 t.sw_dir_cor)):
        got = batch(suns)
        assert got.device.type == "cpu"
        assert tuple(got.shape) == (len(suns),) + t.inner_shape
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
            assert (got[:, inp["mask"] == 0] == 3).all()
            assert (got == 2).any() and (got == 0).any() and (got == 1).any()
        else:
            err = np.abs(got - ref)[~tie]
            print(f"{name}: max |sw_dir_cor - ref| {np.nanmax(err):.3e}")
            np.testing.assert_allclose(got[~tie], ref[~tie], rtol=SW_RTOL,
                                       atol=SW_TOL)
            np.testing.assert_allclose(one[~tie[1]], ref_one[~tie[1]],
                                       rtol=SW_RTOL, atol=SW_TOL)
            fill = got[:, inp["mask"] == 0]
            if np.isnan(kw["sw_dir_cor_fill"]):
                assert fill.size == 0 or np.isnan(fill).all()
            else:
                assert fill.size > 0 and (fill == -7.0).all()
    assert shadow._ss.KERNEL_LAUNCHES == n0          # CPU: the plain sweep


def test_codes_equal_plain_exact_metric(terrains):
    """The queries' codes from the sign-exact sweep (on the CPU the exact
    plain sweep) equal those from the plain exact metric read back at the
    cells, and the back-map reads the nearest lattice cell."""
    t = terrains["bumps45"]
    suns = SCENES["bumps45"][2]
    codes = t.shadow_batch(suns)
    assert torch.equal(codes, t._run(suns, "shadow", plain=True))
    bi, bj, _ = t._back
    fi = (t._fields["y_in"].double() - t.grid.y0) / t.grid.dy - t.offset[0]
    fj = (t._fields["x_in"].double() - t.grid.x0) / t.grid.dx - t.offset[1]
    assert (fi - bi).abs().max() <= 0.5 + 1e-6
    assert (fj - bj).abs().max() <= 0.5 + 1e-6


# ---------------------------------------------------------------------------
# tests/test_curved.py:130-185 on the port
# ---------------------------------------------------------------------------

def _wall_terrain(n, lat_wall, wall_h, off, inner, **kw):
    s = curved_setup(wall(lat_wall, wall_h), n=n, dlat=0.002)
    sl = (slice(off, off + inner),) * 2
    inp = curved_terrain_inputs(s, (off, off), (inner, inner))
    inp["vec_tilt"] = inp["vec_norm"].copy()
    inp["surf_enl_fac"] = np.ones((inner, inner), np.float32)
    inp["elevation"] = np.ascontiguousarray(s["elevation"][sl])
    return _port_terrain(inp, **kw)


def test_curved_shadow_wall():
    """A wall 5.5 km north shades the block when the sun is low in the
    north, and not when it is high in the south."""
    t = _wall_terrain(120, 45.05, 800.0, 50, 20)
    sh_n = t.shadow(np.array([0.0, 1.0e7, 0.7e6], dtype=np.float32))
    assert (sh_n == 2).float().mean() > 0.5
    sh_s = t.shadow(np.array([0.0, -1.0e7, 1.0e7], dtype=np.float32))
    assert (sh_s == 0).all()


def test_curved_shadow_refraction_smoke():
    """Flat terrain on the sphere, a sun just below the horizontal."""
    t = _wall_terrain(60, 45.0, 0.0, 20, 20, refrac_cor=True)
    sw = t.sw_dir_cor(np.array([0.0, 1.0e7, -2.0e4], dtype=np.float32))
    assert torch.isfinite(sw).all()


# ---------------------------------------------------------------------------
# The soft path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name, straight_through", SOFT_CASES)
def test_soft_matches_jax(oracle, terrains, name, straight_through):
    """``sw_dir_cor_soft``'s value and its gradient w.r.t. the planarised
    lattice against ``jax.vjp`` through the reference's
    ``sw_dir_cor_soft(..., interpret=True)``: the metric's replay on the
    box, the lattice ray origins rebuilt from the heights, the read-back at
    the cells and the Mueller-Scherer factor with its classification fields
    held at their initialise values."""
    inp, kw, suns, _ = SCENES[name]
    t = terrains[name]
    z = t._z_outer.clone().requires_grad_(True)
    out = t.sw_dir_cor_soft(suns, elevation=z, soft_tau=SOFT_TAU,
                            straight_through=straight_through)
    keep = torch.from_numpy(inp["mask"] == 1)
    torch.sum(torch.where(keep, out, 0.0)
              * torch.from_numpy(_weights(name))).backward()
    val = out.detach().numpy()
    ref = oracle[f"{name}:soft{straight_through}"]
    tie = _tie_zone(t, suns, "sw_dir_cor")
    np.testing.assert_allclose(val[~tie], ref[~tie], rtol=SW_RTOL,
                               atol=SW_TOL)
    if straight_through:
        assert torch.equal(out.detach(), t.sw_dir_cor_batch(suns))
    got, want = z.grad.numpy(), oracle[f"{name}:dz{straight_through}"]
    bad = ~np.isfinite(want)
    np.testing.assert_array_equal(~np.isfinite(got), bad)
    got, want = np.where(bad, 0.0, got), np.where(bad, 0.0, want)
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    print(f"{name} st={straight_through}: max |dz - ref| {err:.3e} of max "
          f"|ref| {scale:.3e}; {int((want != 0).sum())} nonzero")
    assert scale > 0.0 and err <= GRAD_TOL * scale
    # only the box's heights and the levels above it carry gradient
    (o0, o1), (c0, c1) = t.offset, t.comp_shape
    assert np.abs(got[o0:o0 + c0, o1:o1 + c1]).max() > 0.0


def test_soft_central_differences():
    """The gradient of the fully soft factor against central differences
    along a smooth bump of the lattice heights, on a small curved scene."""
    s = curved_setup(bumps(5, count=6, amp=(200.0, 700.0)), n=64)
    t = _port_terrain(curved_terrain_inputs(s, (22, 20), (16, 20)))
    suns = np.array([[8.0e6, 3.0e6, 1.2e6], [-3.0e6, 9.0e6, 9.0e5]],
                    dtype=np.float32)
    w = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 16, 20)).astype(np.float32))

    def loss(zz):
        out = t.sw_dir_cor_soft(suns, elevation=zz, soft_tau=SOFT_TAU,
                                straight_through=False)
        return torch.sum(out.double() * w.double())

    z0 = t._z_outer
    z = z0.clone().requires_grad_(True)
    loss(z).backward()
    h, wd = z0.shape
    yy, xx = np.mgrid[0:h, 0:wd]
    o0, o1 = t.offset
    c0, c1 = t.comp_shape
    v = torch.from_numpy(np.exp(
        -((yy - (o0 + c0 / 2)) ** 2 + (xx - (o1 + c1 / 2)) ** 2)
        / (2 * (0.4 * max(c0, c1)) ** 2)).astype(np.float32))
    an = float((z.grad.double() * v.double()).sum())
    eps = 0.05
    with torch.no_grad():
        fd = (loss(z0 + eps * v) - loss(z0 - eps * v)).item() / (2 * eps)
    print(f"directional derivative {an:.6e}, central difference {fd:.6e}, "
          f"relative error {abs(fd - an) / abs(an):.2e}")
    assert an != 0.0 and abs(fd - an) <= FD_RTOL * abs(an)


def test_soft_elevation_is_the_lattice(terrains):
    t = terrains["bumps45"]
    sun = SCENES["bumps45"][2][0]
    with pytest.raises(ValueError, match="planarised lattice"):
        t.sw_dir_cor_soft(sun, elevation=torch.zeros(
            SCENES["bumps45"][0]["dem_dim"]))
    soft = t.sw_dir_cor_soft(sun)
    assert soft.grad_fn is None and torch.equal(soft, t.sw_dir_cor(sun))


# ---------------------------------------------------------------------------
# The back-map's inverse
# ---------------------------------------------------------------------------

def test_gather_backward_is_the_index_backward():
    """Several cells per lattice cell (up to 4 here): the forward is the
    index, the backward equals autograd's accumulating backward of the same
    index (a few float32 ulp: the sum's order differs) and is the same on
    every run."""
    rng = np.random.default_rng(0)
    box = (7, 9)
    bi = rng.integers(0, box[0], (12, 10)).astype(np.int32)
    bj = rng.integers(0, box[1], (12, 10)).astype(np.int32)
    bi_t, bj_t, cells = (torch.from_numpy(a)
                         for a in shadow.back_map(bi, bj, box))
    assert cells.shape[1] >= 4 and (cells == 120).any()
    src = torch.from_numpy(rng.standard_normal((3,) + box).astype(
        np.float32)).requires_grad_(True)
    g = torch.from_numpy(rng.standard_normal((3, 12, 10)).astype(np.float32))
    got = shadow._GatherCells.apply(src, bi_t, bj_t, cells)
    assert torch.equal(got, src[:, bi_t, bj_t])
    (mine,) = torch.autograd.grad(got, src, g)
    (again,) = torch.autograd.grad(
        shadow._GatherCells.apply(src, bi_t, bj_t, cells), src, g)
    (ref,) = torch.autograd.grad(src[:, bi_t, bj_t], src, g)
    assert torch.equal(mine, again)
    torch.testing.assert_close(mine, ref, rtol=0, atol=4e-6)
