"""The port's XLA shadow engines, ``Terrain(engine="sweep")`` (the marching
sweep, ``ops/sweep.shadow_metric_core``) and ``Terrain(engine="scan")``
(the log-doubling scan, ``ops/shadow_scan``), and ``sw_dir_cor_soft``'s
gradient on them, on the CPU against the JAX package's ``Terrain`` with the
same engines; and K2-mask's plain version against interpret-mode
``shadow_metric_pallas(mask=...)``.

The reference runs in one subprocess evaluated as written
(``test_torch_fused_sweep.AS_WRITTEN_XLA_FLAGS``).  Its per-sun metric is
taken from inside its own ``_sun_step`` (a ``jax.debug.callback`` wrapped
around ``_shadow_metric_core`` / ``_shadow_scan_core``).

Cases mirror ``tests/test_shadow.py:174-231`` (the sweep and scan engines
on bumps with an 8-cell halo), with a mask and fill, refraction, a sun
below the horizon and one straight above the lattice centre, and a curved
mesh on the sweep engine.

Tolerances:
* the metric within :data:`ULPS` float32 ulp (measured: bit-equal);
* codes equal, ``sw_dir_cor`` within 1e-5 plus 1e-6 relative (the
  refraction's arccos, power and tan may differ by an ulp on each side);
* the soft gradient within ``1e-5 * max|g|`` of ``jax.grad``, both
  sides with their samples padded to multiples of one (a compile a
  quarter as long; the forward cases run the default eight).  Ties:
  ``torch.maximum`` and ``jnp.maximum`` both send half the cotangent to
  each side of an exact tie (``torch.clamp_min`` would pass all of it,
  so the port's classification takes ``torch.maximum`` too); the
  gradient case cuts its bumps flat at 150 m, so plateaus tie in the
  reads, and ``tests/test_torch_sweep_engine.py`` holds the pyramid's
  gradient through tied max-pools against ``jax.vjp``;
* K2-mask's plain version: on unmasked cells within 2 ulp of
  interpret-mode Pallas with ``exact_metric=True``, the sign of its
  ``exact_metric=False`` result, bit-equal to the dense plain version on
  every cell of a live 32 x 8 block and ``-3e38`` elsewhere.

CPU cost: about 25 s of wall on one core and 50 s of CPU (pytest's count
and the shell's; XLA compiles the reference on several threads), most
of it the JAX side's compiles and import.
"""

import numpy as np
import pytest
import torch

from horayzon_tpu import topo_param as topo_ref
from horayzon_tpu_torch import auxiliary, shadow
from horayzon_tpu_torch.ops import fused_sweep, sweep
from horayzon_tpu_torch.ops import shadow_sweep as ss

from reference_impl import gaussian_bumps_terrain
from test_torch_sweep_engine import run_oracle, ulp_diff
from torch_scenes import bumps, curved_setup, curved_terrain_inputs

ULPS = 2
SW_TOL = 1.0e-5
SW_RTOL = 1.0e-6
GRAD_RTOL = 1.0e-5

_ORACLE = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from horayzon_tpu import shadow
from horayzon_tpu.ops import pallas_sweep, shadow_scan, sweep
inputs = np.load(sys.argv[1])
calls = json.load(open(sys.argv[2]))
out = {}
got = []


def _keep(fn):
    def wrapped(*a, **k):
        m = fn(*a, **k)
        jax.debug.callback(lambda v: got.append(np.asarray(v)), m,
                           ordered=True)
        return m
    return wrapped


sweep._shadow_metric_core = _keep(sweep._shadow_metric_core)
shadow_scan._shadow_scan_core = _keep(shadow_scan._shadow_scan_core)
for name, c in calls.items():
    a = {k[len(name) + 1:]: inputs[k] for k in inputs.files
         if k.startswith(name + ":")}
    if c["kind"] == "wrappers":
        # tests/test_shadow.py:174-204: the marching sweep and the scan
        # on one direction and slope
        z = jnp.asarray(a["z"])
        sched = sweep.build_schedule(25.0, c["diag"],
                                     sweep.default_rel_err(0.25))
        out[name + ":sweep"] = np.asarray(sweep.shadow_metric(
            z, jnp.asarray(a["z_org"]), jnp.asarray(a["z_in"]),
            jnp.asarray(a["m"]), a["u_cells"], sched, tuple(c["offset"]),
            tuple(c["inner_shape"])))
        out[name + ":scan"] = np.asarray(shadow_scan.shadow_scan_metric(
            z, jnp.asarray(a["z_org"]), jnp.float32(0.2), a["u_cells"],
            25.0, c["diag"], tuple(c["offset"]), tuple(c["inner_shape"])))
        continue
    if c["kind"] == "mask":
        z = a["z"]
        sched = sweep.build_schedule(25.0, float(np.hypot(*z.shape) * 25.0),
                                     sweep.default_rel_err(0.25))
        for exact in (True, False):
            out[name + ":metric_" + str(exact)] = np.asarray(
                pallas_sweep.shadow_metric_pallas(
                    z, a["z_org"], a["z_inner"], a["table"], schedule=sched,
                    offset=tuple(c["offset"]),
                    inner_shape=tuple(c["inner_shape"]), dx=25.0, dy=-25.0,
                    grid_origin=(0.0, 0.0), tile=(16, 32), mask=a["mask"],
                    interpret=True, exact_metric=exact))
        continue
    # the gradient case pads its samples to multiples of 1, not 8: no
    # repeated samples, and a compile a quarter as long
    sweep.UNROLL = 1 if c["kind"] == "grad" else 8
    t = shadow.Terrain()
    t.initialise(a["vert_grid"], c["dem_dim"][0], c["dem_dim"][1],
                 c["offset"][0], c["offset"][1], a["vec_tilt"], a["vec_norm"],
                 a["surf_enl_fac"], a["elevation"], a["mask"],
                 sw_dir_cor_fill=c["fill"], refrac_cor=c["refrac_cor"],
                 acc=c.get("acc", 0.25), engine=c["engine"])
    if c["kind"] == "grad":
        def loss(z):
            return jnp.nansum(t.sw_dir_cor_soft(
                a["suns"], elevation=z, soft_tau=c["soft_tau"],
                straight_through=c["straight_through"]))
        out[name + ":grad"] = np.asarray(jax.grad(loss)(t._z_outer))
        continue
    del got[:]
    out[name + ":shadow"] = np.asarray(t.shadow_batch(a["suns"]))
    out[name + ":metric"] = np.stack(got)
    out[name + ":sw_dir_cor"] = np.asarray(t.sw_dir_cor_batch(a["suns"]))
np.savez(sys.argv[3], **out)
"""


def _planar_inputs(z, dx=25.0, off=(8, 8), inner=None, mask=None):
    """Terrain.initialise inputs as tests/test_shadow.py builds them (north
    up, x = j*dx, y = -i*dx), from the JAX package's topo_param."""
    h, w = z.shape
    if inner is None:
        inner = (h - 2 * off[0], w - 2 * off[1])
    in0, in1 = inner
    xx, yy = np.meshgrid(np.arange(w, dtype=np.float32) * dx,
                         -np.arange(h, dtype=np.float32) * dx)
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
        mask=np.ones(inner, np.uint8) if mask is None else mask,
        dem_dim=(h, w), offset=off)


def _cases():
    z = gaussian_bumps_terrain(48, 64, seed=11, amp=600.0)
    mask = np.ones((32, 48), np.uint8)
    mask[:3, :5] = 0
    mask[25:, 40:] = 0
    planar = _planar_inputs(z, inner=(32, 48), mask=mask)
    # the lattice centre, from which the suns are placed
    cx, cy = 0.5 * 63 * 25.0, -0.5 * 47 * 25.0
    suns = np.array([[1.0e7, 0.0, 1.5e6], [-4.0e6, 8.0e6, 1.5e6],
                     [2.0e6, -1.0e7, 3.0e6], [0.0, 1.0e7, -1.0e6],
                     [cx, cy, 2.0e4]], dtype=np.float32)
    s = curved_setup(bumps(4), n=64, dlat=0.002)
    curved = curved_terrain_inputs(s, (16, 14), (28, 34))
    c_suns = np.array([[3.0e6, 1.0e6, 6.0e5], [-2.0e6, -3.0e6, 4.0e5],
                       [1.0e6, -4.0e6, 1.2e6]], dtype=np.float32)
    base = dict(refrac_cor=False, fill=float("nan"))
    return {
        "planar_sweep_refrac": (planar, dict(base, engine="sweep",
                                             refrac_cor=True, fill=-7.0),
                                suns),
        "planar_scan": (planar, dict(base, engine="scan"), suns),
        "curved_sweep": (curved, dict(base, engine="sweep"), c_suns),
    }


def _grad_cases():
    # a 28 x 36 grid at accuracy 2: its 1.1 km diagonal (29 dense steps,
    # then mip levels 1 and 2) keeps the reference's gradient compile
    # short; the straight-through gradient is the fully soft one's.  The
    # bumps are cut flat at 150 m: plateaus whose equal heights tie in the
    # reads
    z = np.minimum(gaussian_bumps_terrain(28, 36, seed=11, amp=400.0),
                   np.float32(150.0))
    inp = _planar_inputs(z, off=(4, 4))
    suns = np.array([-4.0e6, 8.0e6, 1.5e6], dtype=np.float32)
    return {"grad_sweep_st": (inp, dict(engine="sweep", refrac_cor=False,
                                        fill=float("nan"), soft_tau=0.3,
                                        straight_through=True, acc=2.0),
                              suns)}


def _mask_case():
    z = gaussian_bumps_terrain(128, 128, seed=5, amp=400.0)
    off, inner = (32, 32), (64, 64)
    z_inner = np.ascontiguousarray(z[32:96, 32:96])
    cx, cy = 0.5 * 127 * 25.0, -0.5 * 127 * 25.0
    rel = [(2.0e5, 1.0e5, 2.0e4), (-1.5e5, -0.5e5, 1.2e4)]
    suns = np.array([[cx + a, cy + b, c] for a, b, c in rel], np.float32)
    table, _ = ss.shadow_sun_table(suns, (cx, cy), 25.0, -25.0)
    mask = np.zeros(inner, np.uint8)
    mask[5:20, 3:30] = 1          # an island over 2 of the 4 x 2 tiles
    mask[50, 60] = 1              # and one cell of a third
    return dict(z=z, z_inner=z_inner, z_org=z_inner + np.float32(0.05),
                table=table, mask=mask), dict(kind="mask", offset=list(off),
                                              inner_shape=list(inner))


def _wrapper_case():
    """tests/test_shadow.py:174-204: 64^2 bumps, a 32^2 block, the sun
    east at a slope of 0.2 (per cell 0.2 plus seeded noise for the
    sweep)."""
    z = gaussian_bumps_terrain(64, 64, seed=17, amp=500.0)
    z_in = np.ascontiguousarray(z[16:48, 16:48])
    m = (0.2 + 0.02 * np.random.default_rng(0).standard_normal((32, 32))) \
        .astype(np.float32)
    return dict(z=z, z_in=z_in, z_org=z_in + np.float32(0.05), m=m,
                u_cells=np.array([0.0, 1.0 / 25.0], np.float32)), \
        dict(kind="wrappers", offset=[16, 16], inner_shape=[32, 32],
             diag=float(np.hypot(64 * 25.0, 64 * 25.0)))


CASES = _cases()
WRAP_ARRAYS, WRAP_CALL = _wrapper_case()
GRAD_CASES = _grad_cases()
MASK_ARRAYS, MASK_CALL = _mask_case()


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    arrays, calls = {}, {}
    for kind, cases in (("terrain", CASES), ("grad", GRAD_CASES)):
        for name, (inp, kw, suns) in cases.items():
            calls[name] = dict(kw, kind=kind, dem_dim=list(inp["dem_dim"]),
                               offset=list(inp["offset"]))
            arrays.update({f"{name}:{k}": inp[k] for k in (
                "vert_grid", "vec_tilt", "vec_norm", "surf_enl_fac",
                "elevation", "mask")})
            arrays[f"{name}:suns"] = suns
    calls["k2_mask"] = MASK_CALL
    calls["wrappers"] = WRAP_CALL
    arrays.update({f"wrappers:{k}": v for k, v in WRAP_ARRAYS.items()})
    arrays.update({f"k2_mask:{k}": v for k, v in MASK_ARRAYS.items()})
    return run_oracle(_ORACLE, arrays, calls,
                      tmp_path_factory.mktemp("shadow_engines_oracle"))


def _port_terrain(inp, **kw):
    t = shadow.Terrain()
    t.initialise(inp["vert_grid"], inp["dem_dim"][0], inp["dem_dim"][1],
                 inp["offset"][0], inp["offset"][1], inp["vec_tilt"],
                 inp["vec_norm"], inp["surf_enl_fac"], inp["elevation"],
                 inp["mask"], device="cpu", **kw)
    return t


@pytest.mark.parametrize("name", sorted(CASES))
def test_engines_match_jax_terrain(oracle, name):
    inp, kw, suns = CASES[name]
    t = _port_terrain(inp, engine=kw["engine"], refrac_cor=kw["refrac_cor"],
                      sw_dir_cor_fill=kw["fill"])
    assert t.engine == kw["engine"]
    f = t._fields
    metric, near_vert = t._xla_metric(suns, f["z_org_r"], f["z_inner_r"],
                                      t._levels,
                                      scan=kw["engine"] == "scan")
    ref = oracle[name + ":metric"]
    assert tuple(metric.shape) == ref.shape
    d = ulp_diff(metric.numpy(), ref)
    print(f"{name}: metric within {d} ulp")
    assert d <= ULPS
    assert near_vert.tolist() == [False] * (len(suns) - 1) + [
        name.startswith("planar")]
    codes = t.shadow_batch(suns)
    np.testing.assert_array_equal(codes.numpy(), oracle[name + ":shadow"])
    assert set(np.unique(codes.numpy())) <= {0, 1, 2, 3}
    assert (codes.numpy() == 2).any()
    sw = t.sw_dir_cor_batch(suns).numpy()
    ref_sw = oracle[name + ":sw_dir_cor"]
    np.testing.assert_array_equal(np.isnan(sw), np.isnan(ref_sw))
    ok = ~np.isnan(ref_sw)
    np.testing.assert_allclose(sw[ok], ref_sw[ok], rtol=SW_RTOL,
                               atol=SW_TOL)
    # a single sun gives the batch's row
    assert torch.equal(t.shadow(suns[1]), codes[1])


@pytest.mark.parametrize("name", sorted(GRAD_CASES))
def test_soft_gradient_matches_jax_grad(oracle, name):
    inp, kw, suns = GRAD_CASES[name]
    grads = []
    for engine in ("sweep", "scan"):
        # the scan engine's soft path is the marching sweep, as the
        # reference's _soft_sun_step is on both engines
        t = _port_terrain(inp, engine=engine, acc=kw["acc"])
        t._s_phases = sweep.shadow_s_phases(t.schedule, unroll=1)
        z = t._z_outer.clone().requires_grad_(True)
        out = t.sw_dir_cor_soft(suns, elevation=z, soft_tau=kw["soft_tau"],
                                straight_through=kw["straight_through"])
        torch.nansum(out).backward()
        grads.append(z.grad)
        # the forward value stays the hard one on the sweep engine
        if engine == "sweep":
            assert torch.equal(out.detach(), t.sw_dir_cor_batch(suns))
    assert torch.equal(grads[0], grads[1])
    g, ref = grads[0].numpy(), oracle[name + ":grad"]
    scale = np.abs(ref).max()
    print(f"{name}: max |g - ref| {np.abs(g - ref).max():.3e} of max|g| "
          f"{scale:.3e}")
    assert scale > 0.0 and np.isfinite(g).all()
    np.testing.assert_allclose(g, ref, rtol=0, atol=GRAD_RTOL * scale)


def test_metric_wrappers_match_jax(oracle):
    """``ops.sweep.shadow_metric`` and ``ops.shadow_scan.
    shadow_scan_metric`` (the engines' public entries) against the
    reference's on ``tests/test_shadow.py:174-204``'s scene, and the two
    engines' occlusion agreeing on 97% of the cells, as that test asks."""
    a, c = WRAP_ARRAYS, WRAP_CALL
    from horayzon_tpu_torch.ops import shadow_scan
    off, inner = tuple(c["offset"]), tuple(c["inner_shape"])
    sched = sweep.build_schedule(25.0, c["diag"], sweep.default_rel_err(0.25))
    t = {k: torch.from_numpy(a[k]) for k in ("z", "z_org", "z_in", "m")}
    m_sweep = sweep.shadow_metric(t["z"], t["z_org"], t["z_in"], t["m"],
                                  a["u_cells"], sched, off, inner).numpy()
    m_scan = shadow_scan.shadow_scan_metric(
        t["z"], t["z_org"], np.float32(0.2), a["u_cells"], 25.0, c["diag"],
        off, inner).numpy()
    assert ulp_diff(m_sweep, oracle["wrappers:sweep"]) <= ULPS
    assert ulp_diff(m_scan, oracle["wrappers:scan"]) <= ULPS
    assert ((m_sweep > 0) == (m_scan > 0)).mean() > 0.97
    assert (m_sweep > 0).any() and (m_sweep <= 0).any()


def test_k2_mask_plain_matches_interpret_pallas(oracle):
    a, c = MASK_ARRAYS, MASK_CALL
    kw = dict(offset=tuple(c["offset"]), inner_shape=tuple(c["inner_shape"]),
              dx=25.0, dy=-25.0, grid_origin=(0.0, 0.0))
    z = torch.from_numpy(a["z"])
    n0 = ss.MASK_KERNEL_LAUNCHES
    got = ss.shadow_metric_fused(z, a["z_org"], a["z_inner"], a["table"],
                                 mask=a["mask"], **kw)
    assert ss.MASK_KERNEL_LAUNCHES == n0          # CPU: the plain version
    dense = ss.shadow_metric_plain(z, a["z_org"], a["z_inner"], a["table"],
                                   **kw)
    keep = a["mask"] == 1
    live = ss.live_cells(torch.from_numpy(a["mask"])).numpy()
    assert live[keep].all()
    assert 0 < live.sum() < live.size
    np.testing.assert_array_equal(got.numpy()[:, live], dense.numpy()[:, live])
    assert (got.numpy()[:, ~live] == np.float32(-3.0e38)).all()
    exact = oracle["k2_mask:metric_True"]
    d = ulp_diff(got.numpy()[:, keep], exact[:, keep])
    print(f"k2_mask: within {d} ulp of interpret-mode Pallas on unmasked "
          f"cells")
    assert d <= ULPS
    signed = oracle["k2_mask:metric_False"]
    np.testing.assert_array_equal(got.numpy()[:, keep] > 0,
                                  signed[:, keep] > 0)
    assert (got.numpy()[:, keep] > 0).any() and \
        (got.numpy()[:, keep] <= 0).any()
    # the plain version's own entry and an all-masked mask
    plain = ss.shadow_metric_plain(z, a["z_org"], a["z_inner"], a["table"],
                                   mask=torch.from_numpy(a["mask"]).bool(),
                                   **kw)
    assert torch.equal(plain, got)
    none = ss.shadow_metric_fused(z, a["z_org"], a["z_inner"], a["table"],
                                  mask=np.zeros_like(a["mask"]), **kw)
    assert torch.all(none == np.float32(-3.0e38))
    with pytest.raises(TypeError, match="uint8 or bool"):
        ss.shadow_metric_fused(z, a["z_org"], a["z_inner"], a["table"],
                               mask=a["mask"].astype(np.float32), **kw)
    with pytest.raises(ValueError, match="gradient path takes no mask"):
        ss.shadow_metric_fused(z.clone().requires_grad_(True), a["z_org"],
                               a["z_inner"], a["table"], mask=a["mask"],
                               **kw)
    blocks = fused_sweep.live_blocks(torch.from_numpy(a["mask"]))
    assert blocks.shape[0] * 8 * 32 == int(live.sum())
