"""The port's horizon gradient on the CPU (plain argmax sweep, plain replay
backward, pyramid VJP) against the JAX package's custom VJP: the argmax
forward ``_pallas_core(..., emit_argmax=True)``, the winner-replay
backward ``_hz_bwd_replay`` and ``jax.grad`` through
``horizon_sweep_pallas``, all in interpret mode.

The reference runs in a subprocess evaluated as written
(``test_torch_fused_sweep.AS_WRITTEN_XLA_FLAGS``), like the forward tests.

Tolerances:
* raw ratios 1e-5 rad after the arctan (as the forward tests); winner ids
  equal except where the two sides' raw values tie within 1 ulp; D within
  rtol 1e-6 on parabola winners;
* backward on the reference's own forward record: ``rtol 1e-5`` of
  ``max|dz|`` (sums run in another order: the reference overlap-adds
  per-tile windows);
* end-to-end gradients: ``atol 1e-5 * max|g|``;
* central finite differences as ``tests/test_pallas.py:118-128``, and
  along a smooth direction within 2% relative;
* the pyramid VJP bit-equal (a max is exact, ties halve exactly);
* three terrain-fit Adam steps: losses within rtol 1e-4.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horayzon_tpu import horizon as horizon_ref
from horayzon_tpu.ops import mip as mip_ref
from horayzon_tpu_torch import topo_param
from horayzon_tpu_torch.models import terrain_fit
from horayzon_tpu_torch.ops import fused_sweep, mip, replay

from reference_impl import gaussian_bumps_terrain
from test_torch_fused_sweep import AS_WRITTEN_XLA_FLAGS, _REPO

TOL = 1.0e-5

_ORACLE = r"""
import json, math, sys
import numpy as np
import jax, jax.numpy as jnp
from horayzon_tpu import topo_param
from horayzon_tpu.horizon import azimuth_angles
from horayzon_tpu.ops import pallas_sweep as ps

inputs = np.load(sys.argv[1])
calls = json.load(open(sys.argv[2]))
out = {}
GEO = ("inner_shape", "offset", "azim_num", "dist_search", "dx", "dy",
       "hori_acc")


def cfg_of(z, kw):
    # the _HzCfg that horizon_sweep_pallas builds (pallas_sweep.py:1219-1243)
    plan = ps.plan_sweep(z.shape, tile=kw["inner_shape"], allow_azim_pad=True,
                         **{k: kw[k] for k in GEO})
    tmap = ps.tile_schedule(plan["inner_shape"], plan["tile"])
    return ps._HzCfg(
        outer_shape=tuple(z.shape), azim_num=kw["azim_num"],
        azim_pad=plan["azim_pad"], ray_org_elev=0.01,
        elev_lims=(-15.0, 89.98), tile_map=tuple(map(tuple, tmap.tolist())),
        interpret=True,
        **{k: plan[k] for k in ("levels_meta", "phases_meta", "pads", "tile",
                                "a_chunk", "offset", "inner_shape", "dx",
                                "dy", "step", "dist", "near_ex", "n_safe",
                                "rel_err", "max_level")})


def sweep(zz, kw):
    return ps.horizon_sweep_pallas(zz, tile=kw["inner_shape"], interpret=True,
                                   **{k: kw[k] for k in GEO})


for i, call in enumerate(calls):
    kind, kw = call["kind"], dict(call["kw"])
    kw["offset"] = tuple(kw["offset"])
    kw["inner_shape"] = tuple(kw["inner_shape"])
    z = jnp.asarray(inputs[f"z{i}"])
    if kind == "grad":
        cfg = cfg_of(z, kw)
        h, res = ps._hz_fwd(cfg, z, None, None)
        raw, ids, aux = res[3:]
        g = jax.grad(lambda hh: jnp.mean(hh ** 2))(h)
        th = jnp.arctan(raw)
        inside = (th >= math.radians(-15.0)) & (th <= math.radians(89.98))
        graw = jnp.where(inside, jnp.moveaxis(g, -1, 0), 0.0) / (
            1.0 + raw * raw)
        dz_replay, _ = ps._hz_bwd_replay(cfg, z, None, raw, ids, aux, g)
        grad = jax.grad(lambda zz: jnp.mean(sweep(zz, kw) ** 2))(z)
        res = dict(raw=raw, ids=ids, aux=aux, graw=graw, dz_replay=dz_replay,
                   grad=grad)
        if call.get("only_id") is not None:
            # the replay of the winners with one id alone
            sel = jnp.moveaxis(ids[:kw["azim_num"]] == call["only_id"], 0, -1)
            res["dz_only_id"] = ps._hz_bwd_replay(
                cfg, z, None, raw, ids, aux, jnp.where(sel, g, 0.0))[0]
    elif kind == "svf":
        azim = jnp.asarray(azimuth_angles(kw["azim_num"]))
        vt = jnp.asarray(inputs[f"vt{i}"])
        res = dict(grad=jax.grad(lambda zz: jnp.mean(topo_param.svf_core_fn(
            azim, sweep(zz, kw), vt)))(z))
    else:
        # the Adam loop of examples/horizon/terrain_fit_gradient.py:89-117
        obs = sweep(jnp.asarray(inputs[f"zt{i}"]), kw)

        def loss_fn(zz):
            hori = sweep(zz, kw)
            data = jnp.mean((hori - obs) ** 2)
            lap = (zz[1:-1, 1:-1] * 4 - zz[:-2, 1:-1] - zz[2:, 1:-1]
                   - zz[1:-1, :-2] - zz[1:-1, 2:]) / kw["dx"]
            return data + call["smooth"] * jnp.mean(lap ** 2), data

        vg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
        m = jnp.zeros_like(z)
        v = jnp.zeros_like(z)
        b1, b2, eps = 0.9, 0.999, 1e-8
        losses, datas = [], []
        for it in range(call["steps"]):
            (loss, data), g = vg(z)
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            mh = m / (1 - b1 ** (it + 1))
            vh = v / (1 - b2 ** (it + 1))
            z = z - call["lr"] * mh / (jnp.sqrt(vh) + eps)
            losses.append(float(loss))
            datas.append(float(data))
        res = dict(losses=np.asarray(losses), datas=np.asarray(datas),
                   z=z)
    for key, val in res.items():
        out[f"{i}/{key}"] = np.asarray(val)
np.savez(sys.argv[3], **out)
"""


def run_oracle(calls, arrays, tmp_dir):
    """Evaluate ``calls`` (JSON-able dicts) in the as-written subprocess;
    ``arrays`` holds their input arrays.  Returns one dict per call."""
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
    env.pop("HZT_GRAD_RECOMPUTE", None)
    res = subprocess.run([sys.executable, "-c", _ORACLE, *paths], env=env,
                         capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    out = np.load(paths[2])
    results = [{} for _ in calls]
    for key in out.files:
        i, name = key.split("/")
        results[int(i)][name] = out[key]
    return results


def _spike():
    """tests/test_pallas.py:37-54's far field: a 500 m spike 5.8 km north
    of inner cell (136, 32); its gradient flows through mip winners."""
    halo, inner = int(6000.0 / 25) + 16, 64
    z = np.zeros((inner + 2 * halo,) * 2, dtype=np.float32)
    z[halo - 96, halo + 32] = 500.0
    return z, dict(dx=25.0, dy=-25.0, offset=(halo, halo),
                   inner_shape=(inner, inner), azim_num=4,
                   dist_search=6000.0, hori_acc=0.25)


def _case_list():
    b96 = dict(dx=25.0, dy=-25.0, offset=(32, 32), inner_shape=(32, 32),
               hori_acc=0.25)
    return {
        # tests/test_pallas.py:88-117: 96^2 grid, 32^2 inner, 900 m
        "bumps96_d900_a4": (gaussian_bumps_terrain(96, 96, seed=4,
                                                   amp=300.0),
                            dict(b96, azim_num=4, dist_search=900.0)),
        "spike_d6000_a4": _spike(),
        # 12-cell halo: masked d2 steps, masked d1 pairs and an odd masked
        # d1 tail, dx != dy, 5 azimuths
        "halo12_dxdy_d825_a5": (
            gaussian_bumps_terrain(56, 56, seed=5, amp=300.0),
            dict(dx=25.0, dy=-30.0, offset=(12, 12), inner_shape=(32, 32),
                 dist_search=825.0, hori_acc=0.25, azim_num=5)),
        # one masked trailing single after an even safe d1 run, which uses
        # the near-field h2 (ROADMAP Queue 3)
        "halo34_d825_a4": (
            gaussian_bumps_terrain(100, 100, seed=7, amp=300.0),
            dict(b96, offset=(34, 34), dist_search=825.0, azim_num=4)),
        # n_dense = nx + 1: the d1 range is one single step at m = nx, whose
        # parabola id 2nx+1 the reference backward's gate drops
        "halo20_d425_a4": (
            gaussian_bumps_terrain(72, 72, seed=8, amp=300.0),
            dict(b96, offset=(20, 20), dist_search=425.0, azim_num=4)),
    }


CASES = _case_list()
#: Cases whose central finite difference must agree (not halo34, whose
#: trailing single reuses the near-field h2 in the forward only).
FD_CASES = ["bumps96_d900_a4", "halo12_dxdy_d825_a5"]
QUIRK_CASE = "halo20_d425_a4"

FIT = dict(n=192, inner=64, dx=25.0, azim_num=16, dist_search=1500.0,
           lr=2.0, smooth=0.02, steps=3)


def _fit_kw():
    halo = (FIT["n"] - FIT["inner"]) // 2
    return dict(dx=FIT["dx"], dy=-FIT["dx"], offset=(halo, halo),
                inner_shape=(FIT["inner"],) * 2, azim_num=FIT["azim_num"],
                dist_search=FIT["dist_search"], hori_acc=0.25)


def _svf_case():
    z, kw = CASES["bumps96_d900_a4"]
    off, inner = kw["offset"][0], kw["inner_shape"][0]
    n = z.shape[0]
    x, y = np.meshgrid(np.arange(n, dtype=np.float32) * 25.0,
                       (n - 1 - np.arange(n, dtype=np.float32)) * 25.0)
    sl = slice(off - 1, off + inner + 1)
    vt = topo_param.slope_plane_meth(x[sl, sl], y[sl, sl], z[sl, sl])
    return z, kw, np.ascontiguousarray(vt.numpy()[1:-1, 1:-1])


def _plan_nx(name):
    z, kw = CASES[name]
    return fused_sweep.plan_sweep(z.shape, **{
        k: kw[k] for k in ("inner_shape", "offset", "dist_search", "dx",
                           "dy", "hori_acc")})["nx"]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    names = sorted(CASES)
    calls, arrays = [], {}
    for i, name in enumerate(names):
        z, kw = CASES[name]
        call = dict(kind="grad", kw=kw)
        if name == QUIRK_CASE:
            call["only_id"] = 2 * _plan_nx(name) + 1
        calls.append(call)
        arrays[f"z{i}"] = z
    z, kw, vt = _svf_case()
    arrays[f"z{len(calls)}"], arrays[f"vt{len(calls)}"] = z, vt
    calls.append(dict(kind="svf", kw=kw))
    z_true, z_init = terrain_fit.terrains(FIT["n"], FIT["dx"], seed=3)
    arrays[f"z{len(calls)}"], arrays[f"zt{len(calls)}"] = z_init, z_true
    calls.append(dict(kind="fit", kw=_fit_kw(), lr=FIT["lr"],
                      smooth=FIT["smooth"], steps=FIT["steps"]))
    out = run_oracle(calls, arrays, tmp_path_factory.mktemp("grad_oracle"))
    ref = dict(zip(names, out))
    ref["svf"], ref["fit"] = out[-2], out[-1]
    return ref


def _port_grad(z, kw, loss=lambda h: torch.mean(h ** 2)):
    zt = torch.from_numpy(z).requires_grad_(True)
    (g,) = torch.autograd.grad(loss(fused_sweep.horizon_sweep_fused(zt, **kw)),
                               zt)
    return g.numpy()


@pytest.mark.parametrize("name", sorted(CASES))
def test_argmax_forward_matches_interpret_pallas(reference, name):
    z, kw = CASES[name]
    ref = reference[name]
    a = kw["azim_num"]
    args = fused_sweep.sweep_args(torch.from_numpy(z), **kw)
    raw, ids, aux = fused_sweep._ratio_plain(*args, emit_argmax=True)
    # the raw ratio is K1's, bit for bit
    assert torch.equal(raw, fused_sweep._ratio_plain(*args))
    r_raw, r_ids, r_aux = (replay.replay_state_from_jax(
        ref["raw"], ref["ids"], ref["aux"], a, "cpu"))
    assert ids.dtype == torch.int32 and tuple(ids.shape) == tuple(r_ids.shape)
    assert np.abs(np.arctan(raw.numpy()) - np.arctan(r_raw.numpy())).max() \
        <= TOL
    differ = (ids != r_ids).numpy()
    if differ.any():
        # a different winner only where both sides' values tie to 1 ulp
        rv, pv = r_raw.numpy()[differ], raw.numpy()[differ]
        assert np.all(np.abs(rv - pv) <= np.spacing(np.abs(rv)))
    quad = (r_ids.numpy() % 2 == 1) & (r_ids.numpy() < replay.ID_NONE)
    assert (quad & ~differ).any()
    # D of parabola winners (a point winner carries the last parabola
    # winner's D, or 1: the backward reads it only for parabolas)
    np.testing.assert_allclose(aux.numpy()[~differ], r_aux.numpy()[~differ],
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_replay_backward_matches_reference(reference, name):
    """The plain backward on the reference's own forward record against
    ``backward_replay_fn`` (through ``_hz_bwd_replay``)."""
    z, kw = CASES[name]
    ref = reference[name]
    a = kw["azim_num"]
    _, ids, aux = replay.replay_state_from_jax(ref["raw"], ref["ids"],
                                               ref["aux"], a, "cpu")
    graw = torch.from_numpy(np.ascontiguousarray(ref["graw"][:a]))
    zt = torch.from_numpy(z)
    plan = fused_sweep.sweep_args(zt, **kw)[4]
    cots, zcot = replay.backward_replay_plain(
        z.shape, graw, ids, aux, plan,
        replay.horizon_shifts(fused_sweep.trig_table(a), plan))
    dz = replay.z_cotangent(zt, plan, cots, zcot).numpy()
    want = ref["dz_replay"]
    assert np.abs(want).max() > 0.0
    np.testing.assert_allclose(dz, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("name", sorted(CASES))
def test_grad_matches_jax(reference, name):
    z, kw = CASES[name]
    got = _port_grad(z, kw)
    want = reference[name]["grad"]
    assert np.isfinite(got).all() and np.abs(want).max() > 0.0
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("name", FD_CASES)
def test_grad_central_finite_difference(name):
    z, kw = CASES[name]
    g = _port_grad(z, kw)

    def loss(zz):
        h = fused_sweep.horizon_sweep_fused(torch.from_numpy(zz), **kw)
        return float(torch.mean(h.double() ** 2))

    v = np.random.default_rng(11).normal(size=z.shape).astype(np.float32)
    eps = 3e-2
    fd = (loss(z + eps * v) - loss(z - eps * v)) / (2 * eps)
    an = float(np.sum(g * v))
    assert abs(fd - an) < 3e-3 * max(1.0, abs(an)), (fd, an)


def smooth_direction(n):
    """A Gaussian bump over the inner block: along it the loss is smooth
    enough for central differences to converge (along white noise the
    parabola candidates' second differences make it rough)."""
    yy, xx = np.mgrid[0:n, 0:n]
    return np.exp(-((yy - 0.42 * n) ** 2 + (xx - 0.52 * n) ** 2)
                  / (2 * (0.16 * n) ** 2)).astype(np.float32)


@pytest.mark.parametrize("name", FD_CASES)
def test_grad_smooth_direction_finite_difference(name):
    """A relative check the white-noise one above cannot make: along a
    smooth direction the central difference (eps 0.1 m) agrees with the
    directional derivative within 2% (0.5% and 0.3% on these cases)."""
    z, kw = CASES[name]
    g = _port_grad(z, kw)
    v = smooth_direction(z.shape[0])

    def loss(zz):
        h = fused_sweep.horizon_sweep_fused(torch.from_numpy(zz), **kw)
        return float(torch.mean(h.double() ** 2))

    eps = 0.1
    fd = (loss(z + eps * v) - loss(z - eps * v)) / (2 * eps)
    an = float(np.sum(g * v))
    assert an != 0.0 and abs(fd - an) <= 2e-2 * abs(an), (fd, an)


def test_reference_drops_the_single_parabola_at_nx(reference):
    """Reference quirk, mirrored: with n_dense = nx + 1 the d1 range is one
    trailing single at m = nx, and its parabola (id 2nx+1) gets no
    gradient in the reference backward (the gate ``mm >= nx + 1``,
    ``pallas_sweep.py:1960``), though it is a real winner."""
    z, kw = CASES[QUIRK_CASE]
    ref = reference[QUIRK_CASE]
    nx = _plan_nx(QUIRK_CASE)
    plan = fused_sweep.sweep_args(torch.from_numpy(z), **kw)[4]
    assert plan["n_dense"] == nx + 1 == plan["ns1"]
    a = kw["azim_num"]
    _, ids, aux = replay.replay_state_from_jax(ref["raw"], ref["ids"],
                                               ref["aux"], a, "cpu")
    sel = ids == 2 * nx + 1
    assert int(sel.sum()) > 0
    assert not ref["dz_only_id"].any()
    graw = torch.where(sel, torch.from_numpy(ref["graw"][:a]), 0.0)
    cots, zcot = replay.backward_replay_plain(
        z.shape, graw, ids, aux, plan,
        replay.horizon_shifts(fused_sweep.trig_table(a), plan))
    assert not zcot.any() and not any(c.any() for c in cots)


def test_pyramid_vjp_bit_equal_with_ties():
    """Flat patches, a plateau at the max and odd shapes make exact ties in
    every 2x2 max; the port's VJP halves them as ``jnp.maximum``'s does."""
    rng = np.random.default_rng(2)
    z = np.round(rng.uniform(0.0, 3.0, (45, 38))).astype(np.float32)
    z[10:20, 5:15] = 7.0
    pads = (3, 2, 4, 1)
    cots = [rng.normal(size=(h + 2 * p, w + 2 * p)).astype(np.float32)
            for (h, w), p in zip(mip.level_shapes(z.shape, 4), pads)]
    _, vjp = jax.vjp(lambda zz: mip_ref.padded_pyramid(zz, 4, pads),
                     jnp.asarray(z))
    (want,) = vjp([jnp.asarray(c) for c in cots])
    got = mip.padded_levels_vjp(torch.from_numpy(z), pads,
                                [torch.from_numpy(c) for c in cots])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_svf_gradient_matches_jax(reference):
    z, kw, vt = _svf_case()
    azim = horizon_ref.azimuth_angles(kw["azim_num"])
    got = _port_grad(z, kw, lambda h: torch.mean(
        topo_param.sky_view_factor(azim, h, torch.from_numpy(vt))))
    want = reference["svf"]["grad"]
    assert np.abs(want).max() > 0.0
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_terrain_fit_matches_jax_loop(reference):
    z_true, z_init = terrain_fit.terrains(FIT["n"], FIT["dx"], seed=3)
    kw = _fit_kw()
    obs = fused_sweep.horizon_sweep_fused(torch.from_numpy(z_true), **kw)
    model = terrain_fit.TerrainFit(
        z_init, obs, dx=FIT["dx"], inner=FIT["inner"],
        azim_num=FIT["azim_num"], dist_search=FIT["dist_search"],
        smooth=FIT["smooth"])
    totals = []
    opt = torch.optim.Adam(model.parameters(), lr=FIT["lr"],
                           betas=(0.9, 0.999), eps=1e-8)
    datas = []
    for _ in range(FIT["steps"]):
        opt.zero_grad()
        loss, data = model()
        loss.backward()
        opt.step()
        totals.append(loss.item())
        datas.append(data.item())
    ref = reference["fit"]
    np.testing.assert_allclose(totals, ref["losses"], rtol=1e-4)
    np.testing.assert_allclose(datas, ref["datas"], rtol=1e-4)
    # fit() runs the same loop
    model2 = terrain_fit.TerrainFit(
        z_init, obs, dx=FIT["dx"], inner=FIT["inner"],
        azim_num=FIT["azim_num"], dist_search=FIT["dist_search"],
        smooth=FIT["smooth"])
    assert terrain_fit.fit(model2, 2, lr=FIT["lr"]) == datas[:2]


def test_gradient_path_arguments():
    z, kw = CASES["bumps96_d900_a4"]
    zt = torch.from_numpy(z).requires_grad_(True)
    # the tilt ramp is ported (tests/test_torch_curved.py); a zero ramp is
    # the untilted sweep, and its gradient reaches the ramp
    ra = torch.zeros(32, 32, requires_grad=True)
    h = fused_sweep.horizon_sweep_fused(zt, tilt_ramp=(ra, torch.zeros(
        32, 32)), **kw)
    assert torch.equal(h.detach(), fused_sweep.horizon_sweep_fused(
        z, **kw))
    (ga,) = torch.autograd.grad(h.sum(), (ra,))
    assert ga.abs().max().item() > 0.0
    plan = fused_sweep.plan_sweep(z.shape, **{
        k: kw[k] for k in ("inner_shape", "offset", "dist_search", "dx",
                           "dy")})
    levels = mip.padded_levels(torch.from_numpy(z), plan["pads"])
    # a prebuilt pyramid is an input of its own on the gradient path: the
    # same values, and z receives the ray origins' share alone
    # (tests/test_torch_multires.py holds the gradients)
    lv = [t.clone().requires_grad_(True) for t in levels]
    hp = fused_sweep.horizon_sweep_fused(zt, pyramid=lv, **kw)
    assert hp.requires_grad and torch.equal(hp.detach(), h.detach())
    gz, g0 = torch.autograd.grad(torch.mean(hp ** 2), (zt, lv[0]))
    # levels that do not require grad beside a z that does: the call warns
    # that z's gradient is that share alone, zero off the inner block
    with pytest.warns(UserWarning, match="ray origins' share"):
        hw = fused_sweep.horizon_sweep_fused(zt, pyramid=levels, **kw)
    assert torch.equal(hw.detach(), h.detach())
    (gw,) = torch.autograd.grad(torch.mean(hw ** 2), (zt,))
    assert torch.equal(gw, gz) and g0.abs().max().item() > 0.0
    (o0, o1), (i0, i1) = kw["offset"], kw["inner_shape"]
    inner = torch.zeros_like(gw, dtype=torch.bool)
    inner[o0:o0 + i0, o1:o1 + i1] = True
    assert gw[inner].abs().max().item() > 0.0
    assert gw[~inner].abs().max().item() == 0.0
    # no grad mode: the forward-only path, the same values
    with torch.no_grad():
        h0 = fused_sweep.horizon_sweep_fused(zt, **kw)
    h1 = fused_sweep.horizon_sweep_fused(zt, **kw)
    assert not h0.requires_grad and h1.requires_grad
    assert torch.equal(h0, h1.detach())


def test_replay_state_from_jax_crops_azimuth_padding():
    """The reference pads the azimuth rows of ids and aux to ``azim_pad``
    (``pallas_sweep.py:1668-1670``, ``plan_azim``); the port keeps the
    first ``azim_num`` rows, ids as int32."""
    rng = np.random.default_rng(0)
    raw = rng.normal(size=(8, 3, 4)).astype(np.float32)
    ids = rng.integers(0, 100, size=(8, 3, 4)).astype(np.int32)
    aux = rng.normal(size=(8, 3, 4)).astype(np.float32)
    got = replay.replay_state_from_jax(jnp.asarray(raw), jnp.asarray(ids),
                                       jnp.asarray(aux), 5, "cpu")
    for t, want, dt in zip(got, (raw, ids, aux),
                           (torch.float32, torch.int32, torch.float32)):
        assert t.dtype == dt and t.is_contiguous()
        np.testing.assert_array_equal(t.numpy(), want[:5])
    with pytest.raises(ValueError, match="azimuth rows"):
        replay.replay_state_from_jax(raw[:2], ids[:2], aux[:2], 3, "cpu")
