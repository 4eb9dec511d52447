"""The port's shadow gradient on the CPU against the JAX package.

* The plain argmax sweep (K2-argmax's plain version) against the record of
  interpret-mode ``_shadow_core(..., exact_metric=True, emit_argmax=True)``:
  the metric bit-equal (and bit-equal to the plain sweep without argmax),
  the winner ids equal, D within rtol 1e-6 wherever a parabola won.
* The plain shadow replay (K4's plain version) on the reference's own
  forward record (``replay.replay_state_from_jax``), and the port's
  end-to-end gradient (``shadow_metric_fused`` on tensors that require
  grad, i.e. ``_ShadowSweepFn``), against ``jax.grad`` through
  ``shadow_metric_pallas_diff(..., interpret=True)`` for ``z_outer`` and
  ``z_org_r``: within 1e-5 of max|.| of each (the two sum the same terms in
  another order: the reference overlap-adds per-tile windows).
* ``Terrain.sw_dir_cor_soft``: its gradient w.r.t. the outer heights
  against ``jax.grad`` through the reference's ``sw_dir_cor_soft(...,
  interpret=True)``, within 1e-5 of max|.|; the straight-through value
  bit-equal to the
  hard ``sw_dir_cor`` / ``sw_dir_cor_batch`` (``tests/test_grad.py:76-90,
  139-152``); the kink structure of the metric gradient, one-sided slopes
  bracketing it and central differences converging toward it
  (``tests/test_grad.py:155-210``); the sign structure of the API gradient
  (:212-223).

The reference runs in one subprocess under
``test_torch_fused_sweep.AS_WRITTEN_XLA_FLAGS``, on the cases of
``tests/test_torch_shadow.py`` with the inner block as the tile, so the
reference pads nothing.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from horayzon_tpu_torch import horizon, shadow
from horayzon_tpu_torch.models import PlanarPipeline
from horayzon_tpu_torch.ops import mip, replay
from horayzon_tpu_torch.ops import shadow_sweep as ss

from reference_impl import gaussian_bumps_terrain
from test_torch_fused_sweep import AS_WRITTEN_XLA_FLAGS, _REPO
from test_torch_shadow import (METRIC_CASES, TERRAIN_CASES, _planar_inputs,
                               _port_terrain)

#: Gradient tolerance, relative to max |.| of each reference gradient.
TOL = 1.0e-5
#: The cases of tests/test_torch_shadow.py held against jax.grad: a far
#: spike only the mip phases read, a sun below the horizon, masked d2 steps
#: (halo8), dx != dy and the near-vertical sun (clamped ray slope).
GRAD_CASES = sorted(METRIC_CASES)

_ORACLE = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from horayzon_tpu import shadow
from horayzon_tpu.ops import pallas_sweep as ps, sweep
inputs = np.load(sys.argv[1])
calls = json.load(open(sys.argv[2]))
out = {}
for name, c in calls.items():
    a = {k[len(name) + 1:]: inputs[k] for k in inputs.files
         if k.startswith(name + ":")}
    if c.get("kind") == "soft":
        t = shadow.Terrain()
        t.initialise(a["vert_grid"], c["dem_dim"][0], c["dem_dim"][1],
                     c["offset"][0], c["offset"][1], a["vec_tilt"],
                     a["vec_norm"], a["surf_enl_fac"], a["elevation"],
                     a["mask"], sw_dir_cor_fill=c["fill"],
                     refrac_cor=c["refrac_cor"], engine="pallas")
        keep = jnp.asarray(a["mask"] == 1)

        def soft_loss(zz):
            out = t.sw_dir_cor_soft(
                a["suns"], elevation=zz, soft_tau=c["soft_tau"],
                straight_through=c["straight_through"], interpret=True)
            return jnp.sum(jnp.where(keep, out, 0.0) * a["w"])

        out[name + ":dz"] = np.asarray(jax.grad(soft_loss)(
            jnp.asarray(a["z"])))
        continue
    z = jnp.asarray(a["z"])
    h, w = z.shape
    in0, in1 = c["inner_shape"]
    off0, off1 = c["offset"]
    sched = sweep.build_schedule(
        min(abs(c["dx"]), abs(c["dy"])),
        float(np.hypot(w * abs(c["dx"]), h * abs(c["dy"]))),
        sweep.default_rel_err(0.25))
    table = a["table"]
    # the _ShadCfg that shadow_metric_pallas_diff builds with the inner
    # block as the tile (pallas_sweep.py:2533-2566)
    t_chunk = min(table.shape[0], 8)
    t_pad = -(-table.shape[0] // t_chunk) * t_chunk
    table_pad = np.concatenate(
        [table, np.repeat(table[-1:], t_pad - table.shape[0], 0)], 0)
    lm, pm = ps._build_metas(sched, in0, in1, sched.step)
    cfg = ps._ShadCfg(
        levels_meta=tuple(lm), phases_meta=tuple(pm), pads=sched.pads,
        tile=(in0, in1), t_chunk=t_chunk, num_sun=table.shape[0],
        t_pad=t_pad, offset=(off0, off1), inner_shape=(in0, in1),
        dx=c["dx"], dy=c["dy"], step=float(sched.step),
        dist=float(sched.dist),
        near_ex=sched.phases[0].num if sched.phases[0].kind == "d2" else 0,
        n_safe=max(0, min(off0, off1, h - off0 - in0, w - off1 - in1) - 2),
        grid_origin=tuple(c["grid_origin"]),
        tile_map=tuple(map(tuple, ps.tile_schedule(
            (in0, in1), (in0, in1)).tolist())),
        interpret=True)
    z_org, z_in = jnp.asarray(a["z_org"]), jnp.asarray(a["z_inner"])
    met, ids, aux = ps._shadow_diff_fwd_value(
        cfg, z, z_org, z_in, jnp.asarray(table_pad), emit_argmax=True)
    wgt = jnp.asarray(a["w"])

    def loss(zz, zo):
        return jnp.sum(wgt * ps.shadow_metric_pallas_diff(
            zz, zo, z_in, table, schedule=sched, offset=(off0, off1),
            inner_shape=(in0, in1), dx=c["dx"], dy=c["dy"],
            grid_origin=tuple(c["grid_origin"]), tile=(in0, in1),
            interpret=True))

    dz, dzorg = jax.grad(loss, argnums=(0, 1))(z, z_org)
    for key, val in dict(met=met, ids=ids, aux=aux, dz=dz,
                         dzorg=dzorg).items():
        out[name + ":" + key] = np.asarray(val)
np.savez(sys.argv[3], **out)
"""


def _cotangent(name):
    """The metric cotangent of case ``name``: standard normal, seeded."""
    arr = METRIC_CASES[name][0]
    shape = (arr["table"].shape[0],) + arr["z_inner"].shape
    seed = sorted(METRIC_CASES).index(name)
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


#: ``sw_dir_cor_soft`` against ``jax.grad``: each of tests/test_torch_shadow's
#: terrains (refraction off and on), straight-through and fully soft.
SOFT_CASES = [(terrain, st) for terrain in sorted(TERRAIN_CASES)
              for st in (True, False)]
#: soft_tau [m] of those cases: wide enough that the sigmoid's slope is
#: not zero in float32 at the metres of clearance the terrain gives.
SOFT_TAU = 8.0


def _soft_inputs(terrain):
    """The port's Terrain of case ``terrain``, its outer heights and its
    suns with one more straight above the domain centre (near vertical: the
    metric is set to -1e30 there)."""
    inp, kw, suns = TERRAIN_CASES[terrain]
    t = _port_terrain(inp, **kw)
    cx, cy = t._center
    suns = np.concatenate([suns, np.float32([[cx, cy, 1.5e6]])])
    return inp, kw, t, suns


def _soft_weights(suns, inp, seed):
    """The seeded cotangent of the soft factor, zero on masked cells."""
    w = np.random.default_rng(seed).standard_normal(
        (suns.shape[0],) + inp["mask"].shape).astype(np.float32)
    return w * (inp["mask"] == 1)


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    """Every reference result of this file from one subprocess."""
    tmp = tmp_path_factory.mktemp("shadow_grad_oracle")
    arrays, calls = {}, {}
    for name in GRAD_CASES:
        arr, call, _ = METRIC_CASES[name]
        calls[name] = call
        arrays.update({f"{name}:{k}": v for k, v in arr.items()})
        arrays[f"{name}:w"] = _cotangent(name)
    for i, (terrain, st) in enumerate(SOFT_CASES):
        inp, kw, t, suns = _soft_inputs(terrain)
        name = f"soft:{terrain}:{st}"
        calls[name] = dict(kind="soft", dem_dim=list(inp["dem_dim"]),
                           offset=list(inp["offset"]),
                           fill=float(kw["sw_dir_cor_fill"]),
                           refrac_cor=kw["refrac_cor"], soft_tau=SOFT_TAU,
                           straight_through=st)
        arrays.update({f"{name}:{k}": inp[k] for k in (
            "vert_grid", "vec_tilt", "vec_norm", "surf_enl_fac",
            "elevation", "mask")})
        arrays[f"{name}:z"] = t._z_outer.numpy()
        arrays[f"{name}:suns"] = suns
        arrays[f"{name}:w"] = _soft_weights(suns, inp, i)
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


def _metric_kw(call):
    return dict(offset=tuple(call["offset"]),
                inner_shape=tuple(call["inner_shape"]), dx=call["dx"],
                dy=call["dy"], grid_origin=tuple(call["grid_origin"]))


def _args(name):
    """The inputs of ``ss._metric_plain`` for case ``name``."""
    arr, call, _ = METRIC_CASES[name]
    kw = _metric_kw(call)
    kw.pop("grid_origin")
    return ss.metric_args(torch.from_numpy(arr["z"]), arr["z_org"],
                          arr["z_inner"], arr["table"], **kw)


def _close(got, want):
    scale = np.abs(want).max()
    assert scale > 0.0
    err = np.abs(got - want).max()
    print(f"  max |got - want| {err:.3e} of max |want| {scale:.3e}")
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale)


@pytest.mark.parametrize("name", GRAD_CASES)
def test_argmax_forward_matches_interpret_pallas(oracle, name):
    call = METRIC_CASES[name][1]
    args = _args(name)
    origin = tuple(call["grid_origin"])
    met, ids, aux = ss._metric_plain(*args, grid_origin=origin,
                                     emit_argmax=True)
    # the running value is K2's, bit for bit
    assert torch.equal(met, ss._metric_plain(*args, grid_origin=origin))
    t = met.shape[0]
    r_met, r_ids, r_aux = replay.replay_state_from_jax(
        oracle[f"{name}:met"], oracle[f"{name}:ids"], oracle[f"{name}:aux"],
        t, "cpu")
    assert ids.dtype == torch.int32 and ids.shape == r_ids.shape
    assert torch.equal(met, r_met)
    print(f"{name}: {int((ids != r_ids).sum())} ids differ")
    assert torch.equal(ids, r_ids)
    r_ids, n2 = r_ids.numpy(), 2 * args[4]["n_dense"]
    quad = (r_ids % 2 == 1) & (r_ids < n2)
    mip_won = (r_ids >= n2) & (r_ids < replay.ID_NONE)
    print(f"{name}: {int(quad.sum())} parabola and {int(mip_won.sum())} mip "
          f"winners of {quad.size}")
    # D wherever a parabola won (on both sides: the ids are equal)
    np.testing.assert_allclose(aux.numpy()[quad], r_aux.numpy()[quad],
                               rtol=1e-6, atol=0)
    if name == "far_spike":
        assert mip_won.any()       # only the mip phases read the spike
    elif name not in ("near_vertical", "sun_below"):
        assert quad.any()          # D is exercised (no parabola wins there)


@pytest.mark.parametrize("name", GRAD_CASES)
def test_replay_backward_on_reference_record(oracle, name):
    """The plain shadow replay on the reference's own forward record."""
    arr, call, _ = METRIC_CASES[name]
    args = _args(name)
    z_org, plan, table = args[0], args[4], args[3]
    _, ids, aux = replay.replay_state_from_jax(
        oracle[f"{name}:met"], oracle[f"{name}:ids"], oracle[f"{name}:aux"],
        table.shape[0], "cpu")
    zt = torch.from_numpy(arr["z"])
    cots, dzorg = replay.backward_replay(
        tuple(zt.shape), torch.from_numpy(_cotangent(name)), ids, aux, plan,
        shadow=(table, z_org, tuple(call["grid_origin"])))
    dz = mip.padded_levels_vjp(zt, plan["pads"], cots)
    _close(dz.numpy(), oracle[f"{name}:dz"])
    _close(dzorg.numpy(), oracle[f"{name}:dzorg"])


@pytest.mark.parametrize("name", GRAD_CASES)
def test_grad_matches_jax(oracle, name):
    arr, call, _ = METRIC_CASES[name]
    z = torch.from_numpy(arr["z"]).requires_grad_(True)
    z_org = torch.from_numpy(arr["z_org"]).requires_grad_(True)
    z_inner = torch.from_numpy(arr["z_inner"]).requires_grad_(True)
    n0 = ss.ARGMAX_KERNEL_LAUNCHES, replay.SHADOW_KERNEL_LAUNCHES
    met = ss.shadow_metric_fused(z, z_org, z_inner, arr["table"],
                                 **_metric_kw(call))
    assert met.grad_fn is not None
    torch.sum(torch.from_numpy(_cotangent(name)) * met).backward()
    # the CPU ran the plain versions
    assert (ss.ARGMAX_KERNEL_LAUNCHES, replay.SHADOW_KERNEL_LAUNCHES) == n0
    assert z_inner.grad is None
    assert torch.isfinite(z.grad).all() and torch.isfinite(z_org.grad).all()
    _close(z.grad.numpy(), oracle[f"{name}:dz"])
    _close(z_org.grad.numpy(), oracle[f"{name}:dzorg"])


def test_gradient_path_arguments():
    arr, call, _ = METRIC_CASES["halo8"]
    kw = _metric_kw(call)
    z = torch.from_numpy(arr["z"]).requires_grad_(True)
    levels = _args("halo8")[2]
    with pytest.raises(NotImplementedError, match="pyramid"):
        ss.shadow_metric_fused(z, arr["z_org"], arr["z_inner"], arr["table"],
                               pyramid=levels, **kw)
    # only z_org requires grad: the prebuilt pyramid serves, and z gets none
    z_org = torch.from_numpy(arr["z_org"]).requires_grad_(True)
    zc = torch.from_numpy(arr["z"])
    met = ss.shadow_metric_fused(zc, z_org, arr["z_inner"], arr["table"],
                                 pyramid=levels, **kw)
    met.sum().backward()
    assert z_org.grad is not None and z_org.grad.abs().max() > 0.0
    # no grad mode: the forward-only path, the same values
    with torch.no_grad():
        m0 = ss.shadow_metric_fused(z, z_org, arr["z_inner"], arr["table"],
                                    **kw)
    assert not m0.requires_grad and torch.equal(m0, met.detach())


# ---------------------------------------------------------------------------
# Terrain.sw_dir_cor_soft (tests/test_grad.py:76-223 on the port)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(TERRAIN_CASES))
def test_soft_straight_through_matches_hard(name):
    """Straight-through soft occlusion keeps the hard values bit for bit,
    single and batch, with and without a gradient asked for."""
    inp, kw, suns = TERRAIN_CASES[name]
    t = _port_terrain(inp, **kw)
    hard = t.sw_dir_cor_batch(suns)
    soft = t.sw_dir_cor_soft(suns, soft_tau=2.0)
    assert torch.equal(soft, hard) or np.array_equal(
        soft.numpy(), hard.numpy(), equal_nan=True)
    z = t._z_outer.clone().requires_grad_(True)
    soft_g = t.sw_dir_cor_soft(suns, elevation=z, soft_tau=2.0)
    assert soft_g.grad_fn is not None
    np.testing.assert_array_equal(soft_g.detach().numpy(), hard.numpy())
    one = t.sw_dir_cor_soft(suns[1], soft_tau=2.0)
    np.testing.assert_array_equal(one.numpy(), t.sw_dir_cor(suns[1]).numpy())
    # the fully soft value differs only where the soft step is not 0 or 1
    full = t.sw_dir_cor_soft(suns, soft_tau=2.0, straight_through=False)
    assert tuple(full.shape) == tuple(hard.shape)
    mask = torch.from_numpy(inp["mask"] == 1)
    assert torch.isfinite(full[:, mask]).all()


def _kink_terrain():
    """tests/test_grad.py's terrain: 160^2 at 25 m, 24^2 inner at 12."""
    z = gaussian_bumps_terrain(160, 160, seed=5, amp=250.0)
    return z, _port_terrain(_planar_inputs(z, off=(12, 12), inner=(24, 24)))


def test_soft_metric_gradient_kink_structure():
    """The winner-replay gradient of the metric against finite differences
    (``tests/test_grad.py:155-210``): the metric is a running max whose
    races are decided at centimetre scale, so at the cells with the
    largest gradient the one-sided slopes bracket the analytic value
    (raising a winner keeps it winning, lowering it loses races) and the
    central difference converges toward it as eps shrinks."""
    z, t = _kink_terrain()
    sun = np.asarray([[3.0e5, -2.0e5, 1.5e4]], np.float32)
    table, _ = ss.shadow_sun_table(sun, t._center, t.grid.dx, t.grid.dy)
    (o0, o1), (c0, c1) = t.offset, t.comp_shape

    def loss(zz):
        z_inner = zz[o0:o0 + c0, o1:o1 + c1]
        met = ss.shadow_metric_fused(
            zz, z_inner + float(np.float32(0.05)), z_inner, table,
            offset=t.offset, inner_shape=t.comp_shape, dx=t.grid.dx,
            dy=t.grid.dy, grid_origin=t._grid_origin)
        return torch.sum(met[0].double())

    zg = torch.from_numpy(z).requires_grad_(True)
    loss(zg).backward()
    g = zg.grad.numpy()
    assert np.isfinite(g).all() and np.abs(g).max() > 0.0

    def value(zz):
        with torch.no_grad():
            return float(loss(torch.from_numpy(zz)))

    l0 = value(z)
    for idx in np.argsort(np.abs(g).ravel())[::-1][:4]:
        ci, cj = np.unravel_index(idx, g.shape)
        an = float(g[ci, cj])
        e = np.zeros_like(z)
        e[ci, cj] = np.sign(an) or 1.0
        eps = 0.25
        fwd = (value(z + eps * e) - l0) / eps
        bwd = (l0 - value(z - eps * e)) / eps
        an_s = an * np.sign(an)
        slack = 0.05 * (abs(fwd) + abs(bwd)) + 1e-6
        assert bwd - slack <= an_s <= fwd + slack, ((ci, cj), bwd, an_s, fwd)
        fds = [(value(z + h * e) - value(z - h * e)) / (2 * h)
               for h in (0.5, 0.05)]
        assert abs(fds[1] - an_s) < abs(fds[0] - an_s) + slack, (
            (ci, cj), fds, an_s)


@pytest.mark.parametrize("terrain, straight_through", SOFT_CASES)
def test_soft_api_gradient_matches_jax(oracle, terrain, straight_through):
    """The gradient of ``sw_dir_cor_soft`` w.r.t. the outer heights against
    ``jax.grad`` through the reference's ``sw_dir_cor_soft(...,
    interpret=True)``: the metric's replay, the ray origins rebuilt from
    the heights into the sun vectors (and the refraction), the
    Mueller-Scherer factor, the sigmoid, the straight-through detach and the
    near-vertical sun's -1e30."""
    inp, kw, t, suns = _soft_inputs(terrain)
    w = _soft_weights(suns, inp, SOFT_CASES.index((terrain,
                                                   straight_through)))
    z = t._z_outer.clone().requires_grad_(True)
    out = t.sw_dir_cor_soft(suns, elevation=z, soft_tau=SOFT_TAU,
                            straight_through=straight_through)
    keep = torch.from_numpy(inp["mask"] == 1)
    torch.sum(torch.where(keep, out, 0.0) * torch.from_numpy(w)).backward()
    got = z.grad.numpy()
    want = oracle[f"soft:{terrain}:{straight_through}:dz"]
    # The reference's gradient is NaN at the inner cells when refraction
    # bends the sun straight overhead (the near-vertical sun); the port's is
    # NaN at exactly those cells and finite everywhere else.
    bad = ~np.isfinite(want)
    np.testing.assert_array_equal(~np.isfinite(got), bad)
    assert bad.any() == kw["refrac_cor"]
    _close(np.where(bad, 0.0, got), np.where(bad, 0.0, want))


def test_soft_api_gradient_sign_structure():
    """``sw_dir_cor_soft`` end to end (``tests/test_grad.py:212-223``): the
    gradient of the mean fully soft factor is finite and nonzero, and
    sun-facing slopes gain from clearing terrain while terrain that casts
    the shadow loses."""
    _, t = _kink_terrain()
    sun = np.asarray([3.0e5, -2.0e5, 1.5e4], np.float32)
    z = t._z_outer.clone().requires_grad_(True)
    out = t.sw_dir_cor_soft(sun, elevation=z, soft_tau=8.0,
                            straight_through=False)
    assert tuple(out.shape) == t.comp_shape
    out.mean().backward()
    g = z.grad.numpy()
    assert np.isfinite(g).all() and np.abs(g).max() > 0.0
    assert g.min() < 0.0 < g.max()


def test_entry_points_default_to_the_card():
    """``horizon_gridded``, ``PlanarPipeline`` and ``Terrain.initialise``
    run on the card unless the caller asks for the CPU: without a card, a
    call that names no device raises torch's own error (no fallback)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    z = gaussian_bumps_terrain(40, 40, seed=2, amp=300.0)
    inp = _planar_inputs(z)
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        shadow.Terrain().initialise(
            inp["vert_grid"], 40, 40, 8, 8, inp["vec_tilt"], inp["vec_norm"],
            inp["surf_enl_fac"], inp["elevation"], inp["mask"])
    vec = np.zeros((24, 24, 3), np.float32)
    vec[..., 2] = 1.0
    north = np.zeros((24, 24, 3), np.float32)
    north[..., 1] = 1.0
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        horizon.horizon_gridded(inp["vert_grid"], 40, 40, vec, north, 8, 8,
                                dist_search=0.3, azim_num=4)
    x = np.arange(40, dtype=np.float32) * 25.0
    y = (39 - np.arange(40, dtype=np.float32)) * 25.0
    pipe = PlanarPipeline(x, y, z, {"x_min": x[8], "x_max": x[31],
                                    "y_min": y[31], "y_max": y[8]},
                          dist_search=0.3, azim_num=4)
    assert pipe.device.type == "cuda"
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        pipe.run()
