"""The port's multires path on the CPU (combined fine + coarse pyramid,
plain argmax sweep, plain replay, autograd through the pyramid) against the
JAX package's ``ops/multires.py``: ``combined_pyramid``, interpret-mode
``horizon_sweep_multires_pallas`` and ``jax.grad`` through it, and the TIN
route of ``horizon_gridded`` against an oracle composed from the
reference's own pieces.

The reference runs in one subprocess evaluated as written
(``test_torch_fused_sweep.AS_WRITTEN_XLA_FLAGS``), like the other sweep
tests.

Tolerances:
* the combined pyramid bit-equal to the reference's, cropped to the port's
  layout (maxima, pads and crops are exact);
* raw ratios within 2 float32 ulp of interpret-mode Pallas (measured: 0 ulp,
  bit-equal, and every winner id equal on these scenes), and 1e-5 rad after
  the arctan; winner ids equal except where the two sides' raw values tie
  within 1 ulp;
* gradients w.r.t. both grids: ``atol 1e-5 * max|g|``;
* central differences as ``tests/test_multires.py:242-259`` (5% relative);
* the TIN route within 1e-5 rad of the composed oracle and within
  ``2 * hori_acc`` of the full-resolution run.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from horayzon_tpu.ops import multires as multires_ref  # noqa: F401 (JAX side importable)
from horayzon_tpu_torch import auxiliary, horizon, terrain
from horayzon_tpu_torch.ops import fused_sweep, mip, multires, replay
from horayzon_tpu_torch.ops import sweep as sweep_port

from reference_impl import gaussian_bumps_terrain
from test_torch_fused_sweep import AS_WRITTEN_XLA_FLAGS, _REPO

TOL = 1.0e-5
ULPS = 2

_ORACLE = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from horayzon_tpu.ops import multires, sweep
from horayzon_tpu.ops import pallas_sweep as ps
from horayzon_tpu.terrain import GridSpec

inputs = np.load(sys.argv[1])
calls = json.load(open(sys.argv[2]))
out = {}
captured = []
_orig = multires._mr_hz


def _capture(cfg, zf, zc):
    captured.append(cfg)
    return _orig(cfg, zf, zc)


for i, call in enumerate(calls):
    kind, kw = call["kind"], dict(call.get("kw", {}))
    for key in ("offset", "inner_shape", "coarse_offset", "tile"):
        if key in kw:
            kw[key] = tuple(kw[key])
    res = {}
    if kind == "sweep":
        zf, zc = jnp.asarray(inputs[f"zf{i}"]), jnp.asarray(inputs[f"zc{i}"])
        mask = inputs[f"mask{i}"] if f"mask{i}" in inputs.files else None
        multires._mr_hz = _capture
        res["hori"] = multires.horizon_sweep_multires_pallas(
            zf, zc, interpret=True, mask=mask, **kw)
        multires._mr_hz = _orig
        cfg = captured[-1]
        pyr = multires._mr_pyramid(cfg, zf, zc)
        for l, a in enumerate(pyr):
            res[f"lvl{l}"] = a
        res["pads"] = np.asarray(cfg.pads)
        if mask is None:
            raw, ids, aux = multires._mr_fwd_value(cfg, zf, zc,
                                                   emit_argmax=True)
            res.update(raw=raw, ids=ids, aux=aux)
    elif kind == "grad":
        zf, zc = jnp.asarray(inputs[f"zf{i}"]), jnp.asarray(inputs[f"zc{i}"])

        def loss(a, b):
            h = multires.horizon_sweep_multires_pallas(a, b, interpret=True,
                                                       **kw)
            return jnp.mean(h ** 2)

        gf, gc = jax.grad(loss, argnums=(0, 1))(zf, zc)
        res.update(gf=gf, gc=gc)
    else:
        # the TIN route composed from the reference's pieces at the ratio
        # the port chose
        z = inputs[f"z{i}"]
        grid = GridSpec(shape=tuple(z.shape), **call["grid"])
        z_coarse, c_off = multires.coarse_grid_from_tin(
            inputs[f"verts{i}"], inputs[f"tris{i}"], grid=grid,
            fine_shape=z.shape, z_fine=z, ratio_log2=call["ratio_log2"],
            dist_search=kw["dist_search"])
        res["z_coarse"] = z_coarse
        res["coarse_offset"] = np.asarray(c_off)
        res["hori"] = multires.horizon_sweep_multires_pallas(
            z, z_coarse, ratio_log2=call["ratio_log2"], coarse_offset=c_off,
            dx=grid.dx, dy=grid.dy, interpret=True, **kw)
    for key, val in res.items():
        out[f"{i}/{key}"] = np.asarray(val)
np.savez(sys.argv[3], **out)
"""


def run_oracle(calls, arrays, tmp_dir):
    tmp_dir = str(tmp_dir)
    paths = [os.path.join(tmp_dir, n) for n in ("in.npz", "calls.json",
                                                "out.npz")]
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
    results = [{} for _ in calls]
    for key in out.files:
        i, name = key.split("/")
        results[int(i)][name] = out[key]
    return results


def _downsample_max(z, r):
    h, w = z.shape
    return z[:h - h % r, :w - w % r].reshape(h // r, r, w // r, r) \
        .max(axis=(1, 3))


def _scene_r2():
    """tests/test_multires.py:46-82: ratio_log2 2, halo 96, 4 km, acc 2.0,
    32^2 inner, 8 azimuths."""
    dx, dist, inner, halo_fine = 25.0, 4000.0, 32, 96
    halo_full = int(dist / dx) + 16
    n_full = inner + 2 * halo_full
    full = gaussian_bumps_terrain(n_full, n_full, seed=9, amp=500.0)
    i0 = halo_full - halo_fine
    z_fine = np.ascontiguousarray(full[i0:i0 + inner + 2 * halo_fine,
                                       i0:i0 + inner + 2 * halo_fine])
    z_coarse = _downsample_max(full, 4)
    kw = dict(ratio_log2=2, coarse_offset=(i0, i0), dx=dx, dy=-dx,
              offset=(halo_fine, halo_fine), inner_shape=(inner, inner),
              dist_search=dist, hori_acc=2.0, azim_num=8)
    return z_fine, z_coarse, kw, full, halo_full


def _scene_r1_odd():
    """ratio_log2 1, dx != |dy|, an odd fine shape, the inner block off
    centre."""
    full = gaussian_bumps_terrain(400, 400, seed=17, amp=500.0)
    z_fine = np.ascontiguousarray(full[100:233, 100:241])      # 133 x 141
    z_coarse = _downsample_max(full, 2)
    kw = dict(ratio_log2=1, coarse_offset=(100, 100), dx=25.0, dy=-30.0,
              offset=(50, 54), inner_shape=(32, 32), dist_search=3000.0,
              hori_acc=2.0, azim_num=8)
    return z_fine, z_coarse, kw


def _scene_ridge():
    """tests/test_multires.py:191-259: the r2 scene with an isolated 900 m
    ridge about 3 km north of the inner block, outside the fine grid."""
    z_fine, base_coarse, kw, _, halo_full = _scene_r2()
    ridge = np.zeros_like(base_coarse)
    ri = (halo_full - 120) // 4
    rj = slice((halo_full - 16) // 4, (halo_full + 48) // 4)
    ridge[ri, rj] = 900.0
    return z_fine, base_coarse + ridge, dict(kw, azim_num=4), ri, rj


def _scene_ties():
    """The shape of the 2 m example's synthetic scene: the fine grid is the
    coarse window repeated (no detail), and the coarse heights are rounded
    to 20 m plateaus, so the maxima of the pyramid tie exactly on both
    sides of the ratio."""
    z_fine, z_coarse, kw, _, _ = _scene_r2()
    z_coarse = (np.round(z_coarse / 20.0) * 20.0).astype(np.float32)
    i0 = kw["coarse_offset"][0] // 4
    n = z_fine.shape[0] // 4
    window = z_coarse[i0:i0 + n, i0:i0 + n]
    z_fine = np.repeat(np.repeat(window, 4, 0), 4, 1)
    return np.ascontiguousarray(z_fine), z_coarse, dict(kw, azim_num=4)


def _tin_scene():
    """tests/test_multires.py:104-169: 16^2 inner, 2 km, acc 2.0, a fine
    window of halo 48 and a TIN of the 4 x max-pooled terrain."""
    dx, dist_km, acc, inner, halo_fine, r = 25.0, 2.0, 2.0, 16, 48, 4
    halo_full = int(dist_km * 1000.0 / dx) + 16
    n_full = inner + 2 * halo_full
    full = gaussian_bumps_terrain(n_full, n_full, seed=13, amp=600.0)
    x = np.arange(n_full, dtype=np.float64) * dx
    y = -np.arange(n_full, dtype=np.float64) * dx
    i0 = halo_full - halo_fine
    n_fine = inner + 2 * halo_fine
    z_fine = np.ascontiguousarray(full[i0:i0 + n_fine, i0:i0 + n_fine])
    pooled = _downsample_max(full, r)
    nc = pooled.shape[0]
    xv, yv = np.meshgrid(x[:nc * r:r] - i0 * dx, y[:nc * r:r] + i0 * dx)
    verts = np.stack([xv, yv, pooled.astype(np.float64)],
                     axis=-1).reshape(-1, 3).astype(np.float32)
    q = np.arange(nc - 1)
    jj, ii = np.meshgrid(q, q)
    a = (ii * nc + jj).ravel()
    tris = np.concatenate([
        np.stack([a, a + 1, a + nc], -1),
        np.stack([a + 1, a + nc + 1, a + nc], -1)]).astype(np.int32).ravel()
    return dict(dx=dx, dist_km=dist_km, acc=acc, inner=inner,
                halo_fine=halo_fine, halo_full=halo_full, n_full=n_full,
                n_fine=n_fine, full=full, x=x, y=y, i0=i0, z_fine=z_fine,
                verts=verts, tris=tris)


def _vert_grid(xa, ya, za):
    x2, y2 = np.meshgrid(xa, ya)
    return auxiliary.rearrange_pad_buffer(
        x2.astype(np.float32), y2.astype(np.float32), za.astype(np.float32))


def _unit_vectors(inner):
    vec_norm = np.zeros((inner, inner, 3), np.float32)
    vec_norm[..., 2] = 1.0
    vec_north = np.zeros((inner, inner, 3), np.float32)
    vec_north[..., 1] = 1.0
    return vec_norm, vec_north


def _tin_call(s, **extra):
    vec_norm, vec_north = _unit_vectors(s["inner"])
    vg = _vert_grid(s["x"][s["i0"]:s["i0"] + s["n_fine"]] - s["i0"] * s["dx"],
                    s["y"][s["i0"]:s["i0"] + s["n_fine"]] + s["i0"] * s["dx"],
                    s["z_fine"])
    kw = dict(azim_num=8, hori_acc=s["acc"], verbose=False, device="cpu",
              vert_simp=s["verts"].ravel(), num_vert_simp=len(s["verts"]),
              tri_ind_simp=s["tris"], num_tri_simp=len(s["tris"]) // 3)
    kw.update(extra)
    return horizon.horizon_gridded(
        vg, s["n_fine"], s["n_fine"], vec_norm, vec_north, s["halo_fine"],
        s["halo_fine"], s["dist_km"], **kw)


def _tin_ratio(s):
    fine_grid = terrain.GridSpec(x0=0.0, y0=0.0, dx=s["dx"], dy=-s["dx"],
                                 shape=s["z_fine"].shape)
    return fine_grid, horizon.tin_ratio_log2(
        fine_grid, s["z_fine"].shape, s["verts"].ravel(), len(s["verts"]),
        s["tris"], len(s["tris"]) // 3,
        offset=(s["halo_fine"], s["halo_fine"]),
        inner_shape=(s["inner"], s["inner"]),
        dist_search=s["dist_km"] * 1000.0, hori_acc=s["acc"])


SWEEPS = {"r2_halo96": _scene_r2()[:3], "r1_dxdy_odd": _scene_r1_odd()}
GRADS = {"ridge": _scene_ridge()[:3], "ties": _scene_ties()}
MASK_CASE = "r2_halo96"


def _mask(shape):
    m = np.zeros(shape, dtype=np.uint8)
    m[3:20, 5:28] = 1
    m[25, 30] = 1
    return m


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    calls, arrays, names = [], {}, []

    def add(name, kind, zf, zc, kw, **more):
        i = len(calls)
        arrays[f"zf{i}"], arrays[f"zc{i}"] = zf, zc
        calls.append(dict(kind=kind, kw=kw, **more))
        names.append(name)
        return i

    for name, (zf, zc, kw) in SWEEPS.items():
        add(f"sweep/{name}", "sweep", zf, zc,
            dict(kw, tile=kw["inner_shape"], a_chunk=4))
    zf, zc, kw = SWEEPS[MASK_CASE]
    i = add("mask", "sweep", zf, zc,
            dict(kw, tile=(8, 32), a_chunk=4))
    arrays[f"mask{i}"] = _mask(kw["inner_shape"])
    for name, (zf, zc, kw) in GRADS.items():
        add(f"grad/{name}", "grad", zf, zc, dict(kw, tile=(8, 32), a_chunk=4))
    s = _tin_scene()
    fine_grid, ratio = _tin_ratio(s)
    i = len(calls)
    arrays[f"z{i}"], arrays[f"verts{i}"] = s["z_fine"], s["verts"].ravel()
    arrays[f"tris{i}"] = s["tris"]
    calls.append(dict(
        kind="tin", ratio_log2=ratio,
        grid=dict(x0=fine_grid.x0, y0=fine_grid.y0, dx=fine_grid.dx,
                  dy=fine_grid.dy),
        kw=dict(offset=(s["halo_fine"],) * 2, inner_shape=(s["inner"],) * 2,
                azim_num=8, dist_search=s["dist_km"] * 1000.0,
                hori_acc=s["acc"], tile=(s["inner"],) * 2, a_chunk=4)))
    names.append("tin")
    out = run_oracle(calls, arrays, tmp_path_factory.mktemp("mr_oracle"))
    return dict(zip(names, out))


def _port_pyramid(zf, zc, kw):
    geo = {k: kw[k] for k in ("dx", "dy", "offset", "inner_shape",
                              "dist_search", "hori_acc")}
    plan = fused_sweep.plan_sweep(zf.shape, **geo)
    return plan, multires.multires_levels(
        torch.from_numpy(zf), torch.from_numpy(zc),
        ratio_log2=kw["ratio_log2"], coarse_offset=kw["coarse_offset"], **geo)


_SWEEP_KEYS = ("dx", "dy", "offset", "inner_shape", "azim_num", "dist_search",
               "hori_acc")


@pytest.mark.parametrize("name", sorted(SWEEPS))
def test_combined_pyramid_bit_equal(reference, name):
    zf, zc, kw = SWEEPS[name]
    ref = reference[f"sweep/{name}"]
    plan, levels = _port_pyramid(zf, zc, kw)
    assert tuple(ref["pads"]) == tuple(plan["pads"])
    assert len(levels) > kw["ratio_log2"]       # coarse-derived levels exist
    want = mip.combined_pyramid_from_jax(
        [ref[f"lvl{l}"] for l in range(len(levels))], plan["pads"], zf.shape,
        "cpu")
    shapes = replay.padded_level_shapes(zf.shape, plan["pads"])
    for lvl, (got, exp) in enumerate(zip(levels, want)):
        assert tuple(got.shape) == shapes[lvl], lvl
        assert got.is_contiguous()
        assert torch.equal(got, exp), f"level {lvl}"
    # the coarse levels hold far-field terrain beyond the fine grid
    far = levels[-1][:, :plan["pads"][-1]]
    assert (far > mip.PAD_VALUE).any()
    # the cropped levels pass the single-grid check
    fused_sweep.check_pyramid(levels, torch.from_numpy(zf), plan["pads"])


@pytest.mark.parametrize("name", sorted(SWEEPS))
def test_plain_sweep_matches_interpret_pallas(reference, name):
    zf, zc, kw = SWEEPS[name]
    ref = reference[f"sweep/{name}"]
    a = kw["azim_num"]
    _, levels = _port_pyramid(zf, zc, kw)
    args = fused_sweep.sweep_args(torch.from_numpy(zf), pyramid=levels,
                                  **{k: kw[k] for k in _SWEEP_KEYS})
    raw, ids, aux = fused_sweep._ratio_plain(*args, emit_argmax=True)
    r_raw, r_ids, r_aux = replay.replay_state_from_jax(
        ref["raw"], ref["ids"], ref["aux"], a, "cpu")
    ulp = np.abs(raw.numpy() - r_raw.numpy()) / np.spacing(
        np.abs(r_raw.numpy()))
    assert ulp.max() <= ULPS, ulp.max()
    differ = (ids != r_ids).numpy()
    if differ.any():
        rv, pv = r_raw.numpy()[differ], raw.numpy()[differ]
        assert np.all(np.abs(rv - pv) <= np.spacing(np.abs(rv)))
    assert differ.mean() < 0.01
    # mip winners from the coarse-derived levels are there to compare
    n2 = 2 * args[4]["n_dense"]
    assert ((r_ids.numpy() >= n2) & ~differ).any()
    np.testing.assert_allclose(aux.numpy()[~differ], r_aux.numpy()[~differ],
                               rtol=1e-6, atol=0)
    # the entry point: clipped angles
    hori = multires.horizon_sweep_multires_fused(zf, zc, **kw)
    assert tuple(hori.shape) == kw["inner_shape"] + (a,)
    assert np.abs(hori.numpy() - ref["hori"]).max() <= TOL


def test_masked_multires_matches_reference(reference):
    zf, zc, kw = SWEEPS[MASK_CASE]
    mask = _mask(kw["inner_shape"])
    got = multires.horizon_sweep_multires_fused(zf, zc, mask=mask, **kw)
    want = reference["mask"]["hori"]
    keep = mask == 1
    assert np.abs(got.numpy()[keep] - want[keep]).max() <= TOL
    dense = multires.horizon_sweep_multires_fused(zf, zc, **kw)
    assert torch.equal(got[torch.from_numpy(keep)],
                       dense[torch.from_numpy(keep)])
    # masked cells hold the upper limit; no cell to sweep: the lower limit
    assert torch.all(got[torch.from_numpy(~keep)]
                     == np.float32(np.radians(89.98)))
    none = multires.horizon_sweep_multires_fused(
        zf, zc, mask=np.zeros_like(mask), **kw)
    assert torch.all(none == np.float32(np.radians(-15.0)))


def _port_grads(zf, zc, kw):
    tf = torch.from_numpy(zf).requires_grad_(True)
    tc = torch.from_numpy(zc).requires_grad_(True)
    h = multires.horizon_sweep_multires_fused(tf, tc, **kw)
    gf, gc = torch.autograd.grad(torch.mean(h ** 2), (tf, tc))
    return gf.numpy(), gc.numpy()


@pytest.mark.parametrize("name", sorted(GRADS))
def test_gradients_match_jax(reference, name):
    zf, zc, kw = GRADS[name]
    ref = reference[f"grad/{name}"]
    gf, gc = _port_grads(zf, zc, kw)
    for got, want in ((gf, ref["gf"]), (gc, ref["gc"])):
        assert np.isfinite(got).all() and np.abs(want).max() > 0.0
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def test_gradient_reaches_only_one_grid_when_asked():
    """A coarse grid alone that requires grad runs the Function (the
    levels are its inputs) and gives the same coarse gradient."""
    zf, zc, kw = GRADS["ridge"]
    _, gc = _port_grads(zf, zc, kw)
    tc = torch.from_numpy(zc).requires_grad_(True)
    h = multires.horizon_sweep_multires_fused(torch.from_numpy(zf), tc, **kw)
    (gc_only,) = torch.autograd.grad(torch.mean(h ** 2), tc)
    assert torch.equal(gc_only, torch.from_numpy(gc))


def test_ridge_gradient_finite_differences():
    """tests/test_multires.py:236-259 on the port: the ridge's coarse cells
    receive gradient; a fine directional and a coarse single-cell central
    difference agree within 5%."""
    zf, zc, kw, ri, rj = _scene_ridge()
    gf, gc = _port_grads(zf, zc, kw)
    assert np.abs(gf).max() > 0.0 and np.abs(gc).max() > 0.0
    assert np.abs(gc[ri:ri + 2, rj]).sum() > 0.0

    def loss(a, b):
        h = multires.horizon_sweep_multires_fused(a, b, **kw)
        return float(torch.mean(h ** 2))

    v = np.random.default_rng(13).normal(size=zf.shape).astype(np.float32)
    eps = 0.05
    fd = (loss(zf + eps * v, zc) - loss(zf - eps * v, zc)) / (2 * eps)
    d_an = float(np.vdot(gf, v))
    assert abs(d_an - fd) < 0.05 * (abs(fd) + abs(d_an)) + 1e-9, (d_an, fd)
    ci, cj = np.unravel_index(np.abs(gc).argmax(), gc.shape)
    e = np.zeros_like(zc)
    e[ci, cj] = 1.0
    eps_c = 0.5
    fd_c = (loss(zf, zc + eps_c * e) - loss(zf, zc - eps_c * e)) / (2 * eps_c)
    assert abs(float(gc[ci, cj]) - fd_c) \
        < 0.05 * (abs(fd_c) + abs(float(gc[ci, cj]))) + 1e-10, (
            float(gc[ci, cj]), fd_c)


def test_horizon_gridded_tin_route(reference):
    s = _tin_scene()
    ref = reference["tin"]
    _, ratio = _tin_ratio(s)
    assert ratio >= 1
    h_tin, azim = _tin_call(s)
    assert tuple(h_tin.shape) == (s["inner"], s["inner"], 8)
    assert tuple(azim.shape) == (8,)
    # the composed oracle: the reference's coarse grid and interpret-mode
    # multires sweep at the port's ratio
    assert np.abs(h_tin.numpy() - ref["hori"]).max() <= TOL
    # the full-resolution run
    vec_norm, vec_north = _unit_vectors(s["inner"])
    h_ref, _ = horizon.horizon_gridded(
        _vert_grid(s["x"], s["y"], s["full"]), s["n_full"], s["n_full"],
        vec_norm, vec_north, s["halo_full"], s["halo_full"], s["dist_km"],
        azim_num=8, hori_acc=s["acc"], verbose=False, device="cpu")
    d = np.rad2deg(np.abs(h_tin.numpy() - h_ref.numpy()))
    assert d.max() < 2 * s["acc"], f"TIN route max diff {d.max():.3f} deg"
    # a mask: unmasked cells unchanged, masked cells the fill
    mask = _mask((32, 32))[:s["inner"], :s["inner"]].copy()
    h_m, _ = _tin_call(s, mask=mask, hori_fill=-9.0)
    keep = torch.from_numpy(mask == 1)
    assert torch.equal(h_m[keep], h_tin[keep])
    assert torch.all(h_m[~keep] == -9.0)


def test_tin_route_errors():
    s = _tin_scene()
    with pytest.raises(ValueError, match="together"):
        _tin_call(s, tri_ind_simp=None)
    # engine="sweep" takes the XLA multires engine
    # (tests/test_torch_multires_xla.py); the fused route's result is the
    # other estimator
    h_sweep, _ = _tin_call(s, engine="sweep")
    assert torch.isfinite(h_sweep).all()
    # a curved (irregular) grid takes no TIN
    vec_norm, vec_north = _unit_vectors(s["inner"])
    n = s["n_fine"]
    xa = np.arange(n, dtype=np.float64) * s["dx"]
    x2, y2 = np.meshgrid(xa, -xa)
    x2 = x2 + 0.2 * (y2 / y2.min()) ** 2 * s["dx"] * np.arange(n)[None, :]
    vg = auxiliary.rearrange_pad_buffer(
        x2.astype(np.float32), y2.astype(np.float32),
        s["z_fine"].astype(np.float32))
    with pytest.raises(ValueError, match="planar regular grids"):
        horizon.horizon_gridded(
            vg, n, n, vec_norm, vec_north, s["halo_fine"], s["halo_fine"],
            s["dist_km"], azim_num=8, verbose=False, device="cpu",
            vert_simp=s["verts"].ravel(), num_vert_simp=len(s["verts"]),
            tri_ind_simp=s["tris"], num_tri_simp=len(s["tris"]) // 3)


def test_halo_validation():
    """tests/test_multires.py:172-180 on the port's entry."""
    z_fine = np.zeros((64, 64), dtype=np.float32)
    z_coarse = np.zeros((128, 128), dtype=np.float32)
    with pytest.raises(ValueError, match="halo"):
        multires.horizon_sweep_multires_fused(
            z_fine, z_coarse, ratio_log2=2, coarse_offset=(0, 0), dx=25.0,
            dy=-25.0, offset=(28, 28), inner_shape=(8, 8), azim_num=2,
            dist_search=50000.0, hori_acc=0.25)


def test_alignment_validation():
    """tests/test_multires.py:183-188."""
    z = torch.zeros((64, 64))
    sched = sweep_port.build_schedule(25.0, 5000.0, 0.005)
    with pytest.raises(ValueError, match="aligned"):
        multires.combined_pyramid(z, z, 2, (3, 0), sched)


def test_pyramid_gradient_path_through_fused_entry():
    """``horizon_sweep_fused(pyramid=...)`` with a grid that requires grad:
    with ``z``'s own levels built under autograd the gradient is the one
    of the path that builds them itself."""
    z = gaussian_bumps_terrain(96, 96, seed=4, amp=300.0)
    kw = dict(dx=25.0, dy=-25.0, offset=(32, 32), inner_shape=(32, 32),
              azim_num=4, dist_search=900.0, hori_acc=0.25)
    zt = torch.from_numpy(z).requires_grad_(True)
    (want,) = torch.autograd.grad(
        torch.mean(fused_sweep.horizon_sweep_fused(zt, **kw) ** 2), zt)
    plan = fused_sweep.sweep_args(zt.detach(), **kw)[4]
    levels = mip.padded_levels(zt, plan["pads"])
    h = fused_sweep.horizon_sweep_fused(zt, pyramid=levels, **kw)
    (got,) = torch.autograd.grad(torch.mean(h ** 2), zt)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-6 * want.abs().max().item())
    # detached levels: only the ray origins' share reaches z, with a warning
    with pytest.warns(UserWarning, match="ray origins' share"):
        h = fused_sweep.horizon_sweep_fused(
            zt, pyramid=[t.detach() for t in levels], **kw)
    (part,) = torch.autograd.grad(torch.mean(h ** 2), zt)
    outside = torch.ones_like(part, dtype=torch.bool)
    outside[32:64, 32:64] = False
    assert not part[outside].any() and part.abs().max().item() > 0.0
