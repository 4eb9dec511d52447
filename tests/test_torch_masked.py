"""K1's mask variant (with and without the tilt ramp) and the masked planar
``horizon_gridded`` on the CPU (their plain torch versions) against the
JAX package: ``_hz_fwd`` (the argmax forward of ``horizon_sweep_pallas``)
and ``horizon_sweep_pallas(mask=..., interpret=True)``, ``jax.grad``
through the latter, and the reference's masked ``horizon_gridded``
(``engine="pallas"``, the Pallas call in interpret mode and its tile
chooser fed a toy cost table, as ``tests/test_curved.py:240-316`` does).

The reference runs in one subprocess evaluated as written
(``test_torch_fused_sweep.AS_WRITTEN_XLA_FLAGS``).

Tolerances:
* raw ratios on unmasked cells within 4 float32 ulp of the reference's
  (measured: equal); masked cells hold 3e38 (the reference's mask-aware
  init, which its tiles that run also hold); winner ids equal except where
  both sides' raw values tie within 1 ulp; D within rtol 1e-6 at parabola
  winners; the reference's angles within 1e-5 rad on unmasked cells;
* gradients w.r.t. ``z_outer`` and the ramp within 1e-5 of max|g| of
  ``jax.grad`` (a loss that reads unmasked cells only: the reference leaves
  the outputs of tiles it does not run unspecified);
* ``horizon_gridded``: unmasked cells within 1e-5 rad of the reference and
  bit-equal to the port's own dense run, masked cells equal to the fill.
"""

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from horayzon_tpu_torch import auxiliary, horizon
from horayzon_tpu_torch.ops import fused_sweep, replay

from reference_impl import gaussian_bumps_terrain
from test_torch_fused_sweep import AS_WRITTEN_XLA_FLAGS, _REPO

TOL = 1.0e-5
GRAD_RTOL = 1.0e-5

_ORACLE = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from horayzon_tpu import horizon as hz
from horayzon_tpu.ops import pallas_sweep as ps

inputs = np.load(sys.argv[1])
calls = json.load(open(sys.argv[2]))
GEO = ("inner_shape", "offset", "azim_num", "dist_search", "dx", "dy",
       "hori_acc")

# the reference's fused kernel in interpret mode, its masked-run tile
# chooser on a toy cost table (tests/test_curved.py:276-291)
orig, orig_bands = ps.horizon_sweep_pallas, ps.horizon_sweep_pallas_bands
ps.horizon_sweep_pallas = lambda *a, **k: orig(*a, **dict(k, interpret=True))
ps.horizon_sweep_pallas_bands = lambda *a, **k: orig_bands(
    *a, **dict(k, interpret=True))
hz._tile_cost_table = lambda: {(8, 32): 1.5, (16, 32): 1.2, (32, 32): 1.0,
                               (8, 64): 1.4, (16, 64): 1.1, (32, 64): 1.05}
hz._lane_tile_cost = lambda: {32: 1.0, 64: 0.95}


def small_pad(outer_shape, offset, inner_shape):
    up = lambda x, m: ((x + m - 1) // m) * m
    p0, p1 = up(inner_shape[0], 8), up(inner_shape[1], 32)
    if offset[0] + p0 > outer_shape[0] or offset[1] + p1 > outer_shape[1]:
        return None
    return (p0, p1), (8, 32)


hz._pallas_padded_shape = small_pad


def get(name, i):
    key = f"{name}{i}"
    return inputs[key] if key in inputs.files else None


out = {}
for i, call in enumerate(calls):
    kind, kw = call["kind"], dict(call.get("kw", {}))
    if "offset" in kw:
        kw["offset"] = tuple(kw["offset"])
        kw["inner_shape"] = tuple(kw["inner_shape"])
    z = jnp.asarray(inputs[f"z{i}"])
    mask, ra, rb = get("mask", i), get("ra", i), get("rb", i)
    tilt = None if ra is None else (jnp.asarray(ra), jnp.asarray(rb))
    res = {}
    if kind == "kernel":
        tile = tuple(call["tile"])
        res["hori"] = ps.horizon_sweep_pallas(
            z, tile=tile, tilt_ramp=tilt, mask=mask,
            **{k: kw[k] for k in GEO})
        plan = ps.plan_sweep(z.shape, tile=tile, allow_azim_pad=True,
                             **{k: kw[k] for k in GEO})
        tmap = ps.tile_schedule(plan["inner_shape"], plan["tile"], mask)
        if tmap.shape[0]:
            cfg = ps._HzCfg(
                outer_shape=tuple(z.shape), azim_num=kw["azim_num"],
                azim_pad=plan["azim_pad"], ray_org_elev=0.01,
                elev_lims=(-15.0, 89.98),
                tile_map=tuple(map(tuple, tmap.tolist())), interpret=True,
                **{k: plan[k] for k in (
                    "levels_meta", "phases_meta", "pads", "tile", "a_chunk",
                    "offset", "inner_shape", "dx", "dy", "step", "dist",
                    "near_ex", "n_safe", "rel_err", "max_level")})
            m_arr = None if mask is None else jnp.asarray(mask)
            _, r = ps._hz_fwd(cfg, z, tilt, m_arr)
            res.update(raw=r[3], ids=r[4], aux=r[5])
        if call.get("grad"):
            keep = True if mask is None else jnp.asarray(
                (mask != 0)[..., None])

            def loss(zz, a, b):
                h = ps.horizon_sweep_pallas(
                    zz, tile=tile, mask=mask,
                    tilt_ramp=None if tilt is None else (a, b),
                    **{k: kw[k] for k in GEO})
                return jnp.mean(jnp.where(keep, h, 0.0) ** 2)

            a0 = jnp.zeros(kw["inner_shape"]) if tilt is None else tilt[0]
            b0 = jnp.zeros(kw["inner_shape"]) if tilt is None else tilt[1]
            gz, ga, gb = jax.grad(loss, argnums=(0, 1, 2))(z, a0, b0)
            res.update(gz=gz, ga=ga, gb=gb)
    else:
        args = dict(call["args"])
        res["hori"], _ = hz.horizon_gridded(
            inputs[f"vg{i}"], z.shape[0], z.shape[1], inputs[f"vn{i}"],
            inputs[f"vno{i}"], args.pop("offset_0"), args.pop("offset_1"),
            mask=mask, engine="pallas", verbose=False, **args)
    for key, val in res.items():
        out[f"{i}/{key}"] = np.asarray(val)
np.savez(sys.argv[3], **out)
"""


def run_oracle(calls, arrays, tmp_dir, oracle=_ORACLE):
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
               [_REPO, os.path.join(_REPO, "tests"),
                os.environ.get("PYTHONPATH", "")])}
    env.pop("HZT_GRAD_RECOMPUTE", None)
    res = subprocess.run([sys.executable, "-c", oracle, *paths], env=env,
                         capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    out = np.load(paths[2])
    results = [{} for _ in calls]
    for key in out.files:
        i, name = key.split("/")
        results[int(i)][name] = out[key]
    return results


def ramps(shape, seed, scale=2e-3):
    """Tilt-ramp fields of a few milliradians, smooth plus noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    a = scale * (xx / shape[1] - 0.5) + 1e-4 * rng.standard_normal(shape)
    b = scale * (0.5 - yy / shape[0]) + 1e-4 * rng.standard_normal(shape)
    return a.astype(np.float32), b.astype(np.float32)


def _kernel_cases():
    """(z, kw, tile, mask, ramp, grad) of the kernel-level comparisons."""
    z96 = gaussian_bumps_terrain(96, 96, seed=3, amp=300.0)
    b96 = dict(dx=25.0, dy=-25.0, offset=(32, 32), inner_shape=(32, 32),
               hori_acc=0.25, azim_num=4)
    tiles = np.zeros((32, 32), np.uint8)
    tiles[:16, 16:] = 1                      # tests/test_pallas.py:66-67
    scattered = np.zeros((32, 32), np.uint8)
    scattered[::3, ::2] = 1                  # tests/test_pallas.py:76-77
    island = np.zeros((32, 32), np.uint8)
    yy, xx = np.mgrid[0:32, 0:32]
    island[((yy - 14) / 9.0) ** 2 + ((xx - 17) / 6.0) ** 2 <= 1.0] = 1
    z56 = gaussian_bumps_terrain(56, 56, seed=5, amp=300.0)
    return {
        # one of four 16 x 16 tiles runs (and 2 of 4 of the port's blocks)
        "mask_tiles_d900": (z96, dict(b96, dist_search=900.0), (16, 16),
                            tiles, None, False),
        # a cell of every tile: masked d1 steps past n_safe
        "mask_scattered_d2500": (z96, dict(b96, dist_search=2500.0),
                                 (16, 16), scattered, None, True),
        # 12-cell halo (masked d2 steps, an odd masked d1 tail), dx != dy,
        # 5 azimuths, the island mask and a tilt ramp
        "mask_tilt_halo12_d825": (
            z56, dict(dx=25.0, dy=-30.0, offset=(12, 12),
                      inner_shape=(32, 32), dist_search=825.0,
                      hori_acc=0.25, azim_num=5), (8, 32), island,
            ramps((32, 32), 1), True),
        # all masked: no launch, the lower limit everywhere
        "all_masked": (z96, dict(b96, dist_search=900.0), (16, 16),
                       np.zeros((32, 32), np.uint8), None, False),
    }


def _planar_inputs(n=88, halo=28, dx=25.0, dy=-30.0, seed=11):
    """tests/test_torch_pipeline.py's planar scene."""
    z = gaussian_bumps_terrain(n, n, seed=seed, amp=350.0)
    x1 = np.arange(n, dtype=np.float32) * dx
    y1 = (n - 1 - np.arange(n, dtype=np.float32)) * -dy
    x, y = np.meshgrid(x1, y1)
    inner = n - 2 * halo
    vec_norm = np.zeros((inner, inner, 3), dtype=np.float32)
    vec_norm[..., 2] = 1.0
    vec_north = np.zeros((inner, inner, 3), dtype=np.float32)
    vec_north[..., 1] = 1.0
    return dict(z=z, halo=halo, inner=inner, vec_norm=vec_norm,
                vec_north=vec_north,
                vert_grid=auxiliary.rearrange_pad_buffer(x, y, z))


def _gridded_masks(inner):
    """The bench's three mask geometries (bench.py:377-397) at this size:
    a disc of 20% considered, a compact island, scattered patches."""
    yy, xx = np.mgrid[0:inner, 0:inner]
    r_disc = np.sqrt(0.2 * inner * inner / np.pi)
    disc = ((yy - inner * 0.45) ** 2 + (xx - inner * 0.55) ** 2
            <= r_disc ** 2).astype(np.uint8)
    island = ((((yy - inner * 0.5) / (inner * 0.22)) ** 2
               + ((xx - inner * 0.5) / (inner * 0.11)) ** 2) <= 1.0
              ).astype(np.uint8)
    rng = np.random.default_rng(7)
    scattered = np.zeros((inner, inner), np.uint8)
    for _ in range(5):
        cy, cx = rng.uniform(0, inner), rng.uniform(0, inner)
        scattered |= ((yy - cy) ** 2 + (xx - cx) ** 2
                      <= rng.uniform(2.0, 4.0) ** 2).astype(np.uint8)
    return {"disc": disc, "island": island, "scattered": scattered}


GRIDDED_ARGS = dict(dist_search=1.1, azim_num=6, hori_acc=0.25,
                    hori_fill=-9.0)
KERNEL = _kernel_cases()
MASKS = _gridded_masks(32)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    calls, arrays = [], {}
    for name, (z, kw, tile, mask, ramp, grad) in KERNEL.items():
        i = len(calls)
        calls.append(dict(kind="kernel", kw=kw, tile=tile, grad=grad))
        arrays[f"z{i}"], arrays[f"mask{i}"] = z, mask
        if ramp is not None:
            arrays[f"ra{i}"], arrays[f"rb{i}"] = ramp
    p = _planar_inputs()
    for name, mask in MASKS.items():
        i = len(calls)
        calls.append(dict(kind="gridded", args=dict(
            GRIDDED_ARGS, offset_0=p["halo"], offset_1=p["halo"])))
        arrays.update({f"z{i}": p["z"], f"mask{i}": mask,
                       f"vg{i}": p["vert_grid"], f"vn{i}": p["vec_norm"],
                       f"vno{i}": p["vec_north"]})
    out = run_oracle(calls, arrays, tmp_path_factory.mktemp("mask_oracle"))
    return dict(zip(list(KERNEL) + [f"gridded_{m}" for m in MASKS], out))


def _sweep_args(name):
    z, kw, _, mask, ramp, _ = KERNEL[name]
    return fused_sweep.sweep_args(torch.from_numpy(z), tilt_ramp=ramp,
                                  mask=mask, **kw)


@pytest.mark.parametrize("name", [n for n in KERNEL if n != "all_masked"])
def test_masked_raw_matches_interpret_pallas(reference, name):
    """The plain masked sweep's raw ratios, ids and D against the
    reference's argmax forward; the plain variant's raw is the argmax
    variant's, bit for bit."""
    z, kw, _, mask, _, _ = KERNEL[name]
    ref = reference[name]
    a = kw["azim_num"]
    args = _sweep_args(name)
    raw, ids, aux = fused_sweep._ratio_plain(*args, emit_argmax=True)
    assert torch.equal(raw, fused_sweep._ratio_plain(*args))
    r_raw, r_ids, r_aux = replay.replay_state_from_jax(
        ref["raw"], ref["ids"], ref["aux"], a, "cpu")
    sel = torch.from_numpy(mask != 0).expand_as(raw)
    rv, pv = r_raw.numpy()[sel.numpy()], raw.numpy()[sel.numpy()]
    assert np.all(np.abs(rv - pv) <= 4 * np.spacing(np.abs(rv)))
    # masked cells: the mask-aware init, no winner, D = 1
    assert (raw[~sel] == 3.0e38).all()
    assert (ids[~sel] == replay.ID_NONE).all() and (aux[~sel] == 1.0).all()
    differ = ((ids != r_ids) & sel).numpy()
    if differ.any():
        rv, pv = r_raw.numpy()[differ], raw.numpy()[differ]
        assert np.all(np.abs(rv - pv) <= np.spacing(np.abs(rv)))
    quad = ((ids.numpy() % 2 == 1) & (ids.numpy() < 2 * args[4]["n_dense"])
            & ~differ & sel.numpy())
    np.testing.assert_allclose(aux.numpy()[quad], r_aux.numpy()[quad],
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("name", list(KERNEL))
def test_masked_angles_match_interpret_pallas(reference, name):
    z, kw, _, mask, ramp, _ = KERNEL[name]
    got = fused_sweep.horizon_sweep_fused(torch.from_numpy(z),
                                          tilt_ramp=ramp, mask=mask, **kw)
    ref = reference[name]["hori"]
    assert got.shape == ref.shape and got.dtype == torch.float32
    sel = mask != 0
    if not sel.any():
        # all masked (pallas_sweep.py:1228-1229)
        assert (got == np.float32(math.radians(-15.0))).all()
        np.testing.assert_array_equal(got.numpy(), ref)
        return
    assert np.abs(got.numpy()[sel] - ref[sel]).max() <= TOL
    up = np.float32(math.radians(89.98))
    assert (got.numpy()[~sel] == up).all()
    # unmasked cells bit-equal to the port's dense run
    dense = fused_sweep.horizon_sweep_fused(torch.from_numpy(z),
                                            tilt_ramp=ramp, **kw)
    assert torch.equal(got[torch.from_numpy(sel)],
                       dense[torch.from_numpy(sel)])


@pytest.mark.parametrize("name", [n for n, c in KERNEL.items() if c[5]])
def test_masked_gradient_matches_jax(reference, name):
    z, kw, tile, mask, ramp, _ = KERNEL[name]
    ref = reference[name]
    zt = torch.from_numpy(z).requires_grad_(True)
    inputs = [zt]
    tilt = None
    if ramp is not None:
        tilt = tuple(torch.from_numpy(r).requires_grad_(True) for r in ramp)
        inputs += list(tilt)
    keep = torch.from_numpy(mask != 0)[..., None]
    h = fused_sweep.horizon_sweep_fused(zt, tilt_ramp=tilt, mask=mask, **kw)
    grads = torch.autograd.grad(torch.mean(torch.where(keep, h, 0.0) ** 2),
                                inputs)
    # the cells of the reference's tiles that run (pallas_sweep.py:1130-1148)
    t0, t1 = tile
    live = (mask.reshape(mask.shape[0] // t0, t0, mask.shape[1] // t1, t1)
            != 0).any(axis=(1, 3))
    ran = np.repeat(np.repeat(live, t0, axis=0), t1, axis=1)
    for got, key in zip(grads, ("gz", "ga", "gb")):
        got, want = got.numpy(), ref[key]
        finite = np.isfinite(want)
        assert np.isfinite(got).all() and np.abs(want[finite]).max() > 0.0
        if key == "gz":
            assert finite.all()
        else:
            # reference quirk (ROADMAP Queue 3): the ramp's cotangent is NaN
            # on the tiles the mask drops, whose raw output is left
            # unwritten (NaN in interpret mode) and still enters the
            # cotangent (pallas_sweep.py:2662-2680); the port's is 0 there
            np.testing.assert_array_equal(finite, ran)
            assert (got[~ran] == 0.0).all()
        np.testing.assert_allclose(got[finite], want[finite], rtol=0,
                                   atol=GRAD_RTOL * np.abs(want[finite]).max())


def test_masked_gradient_central_difference():
    """The mask-and-ramp gradient against central differences along a
    smooth direction (z) and along the ramp."""
    z, kw, _, mask, ramp, _ = KERNEL["mask_tilt_halo12_d825"]
    keep = torch.from_numpy(mask != 0)[..., None]

    def loss(zz, ra, rb):
        h = fused_sweep.horizon_sweep_fused(zz, tilt_ramp=(ra, rb),
                                            mask=mask, **kw)
        return torch.mean(torch.where(keep, h, 0.0).double() ** 2)

    zt = torch.from_numpy(z).requires_grad_(True)
    ra, rb = (torch.from_numpy(r).requires_grad_(True) for r in ramp)
    gz, ga, gb = torch.autograd.grad(loss(zt, ra, rb), (zt, ra, rb))
    n = z.shape[0]
    yy, xx = np.mgrid[0:n, 0:n]
    v = torch.from_numpy(np.exp(-((yy - 0.42 * n) ** 2 + (xx - 0.52 * n) ** 2)
                                / (2 * (0.16 * n) ** 2)).astype(np.float32))
    z0, a0, b0 = (t.detach() for t in (zt, ra, rb))
    with torch.no_grad():
        fd = (loss(z0 + 0.1 * v, a0, b0)
              - loss(z0 - 0.1 * v, a0, b0)).item() / 0.2
    an = float((gz.double() * v.double()).sum())
    assert an != 0.0 and abs(fd - an) <= 2e-2 * abs(an), (fd, an)
    # the ratio is linear in the ramp: the central difference is exact to
    # the arctan's curvature
    w = torch.ones_like(a0) * 1e-4
    with torch.no_grad():
        fd = (loss(z0, a0 + w, b0 + w) - loss(z0, a0 - w, b0 - w)).item() / 2
    an = float(((ga + gb).double() * w.double()).sum())
    assert an != 0.0 and abs(fd - an) <= 1e-3 * abs(an), (fd, an)


@pytest.mark.parametrize("name", list(MASKS))
def test_masked_horizon_gridded_matches_reference(reference, name):
    p = _planar_inputs()
    mask = MASKS[name]
    n = p["z"].shape[0]
    args = dict(GRIDDED_ARGS, verbose=False, device="cpu")
    got, _ = horizon.horizon_gridded(
        p["vert_grid"], n, n, p["vec_norm"], p["vec_north"], p["halo"],
        p["halo"], mask=mask, **args)
    ref = reference[f"gridded_{name}"]["hori"]
    sel = mask == 1
    assert got.shape == ref.shape
    assert np.abs(got.numpy()[sel] - ref[sel]).max() <= TOL
    assert (got.numpy()[~sel] == -9.0).all() and (ref[~sel] == -9.0).all()
    dense, _ = horizon.horizon_gridded(
        p["vert_grid"], n, n, p["vec_norm"], p["vec_north"], p["halo"],
        p["halo"], **args)
    keep = torch.from_numpy(sel)
    assert torch.equal(got[keep], dense[keep])


def test_masked_horizon_gridded_prints_considered_fraction(capsys):
    p = _planar_inputs()
    n = p["z"].shape[0]
    mask = MASKS["island"]
    horizon.horizon_gridded(p["vert_grid"], n, n, p["vec_norm"],
                            p["vec_north"], p["halo"], p["halo"], mask=mask,
                            device="cpu", **GRIDDED_ARGS)
    want = (f"Number of grid cells for which horizon is computed: "
            f"{int(mask.sum())} ({100.0 * mask.mean():.2f} % of the domain)")
    assert want in capsys.readouterr().out
    # all masked: every cell gets the fill, no sweep
    got, _ = horizon.horizon_gridded(
        p["vert_grid"], n, n, p["vec_norm"], p["vec_north"], p["halo"],
        p["halo"], mask=np.zeros_like(mask), device="cpu", verbose=False,
        **GRIDDED_ARGS)
    assert (got == -9.0).all()


def test_live_blocks_and_mask_arguments():
    """The compacted block list at the kernel's 32 x 8 block, and the
    mask's and ramp's validation."""
    mask = torch.zeros((20, 70), dtype=torch.uint8)
    mask[0, 0] = 1
    mask[9, 69] = 2                   # any nonzero value is swept
    mask[19, 33] = 1
    got = fused_sweep.live_blocks(mask)
    assert got.dtype == torch.int32
    assert got.tolist() == [[0, 0], [1, 2], [2, 1]]
    assert fused_sweep.live_blocks(torch.zeros((5, 5), dtype=torch.bool)) \
        .shape == (0, 2)
    z, kw, _, _, _, _ = KERNEL["mask_tiles_d900"]
    zt = torch.from_numpy(z)
    with pytest.raises(TypeError, match="mask must be uint8 or bool"):
        fused_sweep.horizon_sweep_fused(
            zt, mask=np.ones((32, 32), np.float32), **kw)
    with pytest.raises(ValueError, match="mask has shape"):
        fused_sweep.horizon_sweep_fused(
            zt, mask=np.ones((31, 32), np.uint8), **kw)
    with pytest.raises(ValueError, match="tilt_ramp must be a pair"):
        fused_sweep.horizon_sweep_fused(
            zt, tilt_ramp=(np.zeros((32, 32), np.float32),), **kw)
    with pytest.raises(ValueError, match=r"tilt_ramp\[1\] has shape"):
        fused_sweep.horizon_sweep_fused(
            zt, tilt_ramp=(np.zeros((32, 32), np.float32),
                           np.zeros((32, 31), np.float32)), **kw)
    # a bool mask is the uint8 one; an all-ones mask is the unmasked run
    ones = np.ones((32, 32), bool)
    assert torch.equal(fused_sweep.horizon_sweep_fused(zt, mask=ones, **kw),
                       fused_sweep.horizon_sweep_fused(zt, **kw))
