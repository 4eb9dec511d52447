"""The port's XLA sweep engine (``ops/sweep.py``: ``horizon_core``,
``horizon_sweep``) and ``horizon_gridded``'s XLA routes on the CPU against
the JAX package's ``ops/sweep.py`` and ``horizon_gridded``.

The XLA engine is not the fused kernel's oracle (d1 pairs against trailing
windows, ``tests/test_pallas.py:9-14``), so it is held against the JAX
package's own XLA engine, run in one subprocess evaluated as written
(``test_torch_fused_sweep.AS_WRITTEN_XLA_FLAGS``).

Cases mirror ``tests/test_horizon.py`` (the masked sweep with
``hori_fill``, non-default vectors), ``tests/test_pallas.py:208-252``
(tilted spherical-cap normals: the general basis, and the port's tilt
ramp against it) and ``tests/test_curved.py``'s curved
``engine="sweep"``.

Tolerances:
* raw ratios (``apply_arctan=False``) within :data:`ULPS` float32 ulp of
  the reference's (measured: bit-equal) and the winners' distances
  (``track_dist``) equal, both sides on shift tables of one sample per
  scan step (``unroll=1``: no repeated samples, a compile a quarter as
  long); the ``horizon_gridded`` cases run the default eight, repeats
  and all, end to end;
* angles of ``horizon_gridded`` within :data:`ANGLE_TOL` rad, two float32
  ulp at 1 rad: the two sides' float32 arctan may differ by an ulp;
* the port's tilt ramp against its general basis within 0.25 degree, the
  reference's own bound for its kernel against its XLA engine;
* azimuth chunks, the pyramid and the routes: bit-equal.

CPU cost: about 31 s of wall on one core and 50 s of CPU (pytest's count
and the shell's; XLA compiles the reference on several threads), most
of it the JAX side's compiles and import.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from horayzon_tpu.ops import mip as mip_ref
from horayzon_tpu_torch import auxiliary, horizon, terrain
from horayzon_tpu_torch.ops import fused_sweep, mip, sweep

from reference_impl import gaussian_bumps_terrain
from test_torch_fused_sweep import AS_WRITTEN_XLA_FLAGS, _REPO
from torch_scenes import bumps, curved_setup

ULPS = 2
ANGLE_TOL = 2.4e-7
GEOM_KEYS = ("ex", "ey", "ez", "nx2", "ny2", "nz2", "mx", "my", "mz")

_ORACLE = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from horayzon_tpu import horizon
from horayzon_tpu.ops import sweep
GEOM_KEYS = ("ex", "ey", "ez", "nx2", "ny2", "nz2", "mx", "my", "mz")
inputs = np.load(sys.argv[1])
calls = json.load(open(sys.argv[2]))
out = {}
for name, c in calls.items():
    a = {k[len(name) + 1:]: inputs[k] for k in inputs.files
         if k.startswith(name + ":")}
    if c["kind"] == "core":
        z = a["z"]
        off, inner = tuple(c["offset"]), tuple(c["inner_shape"])
        sched = sweep.build_schedule(min(abs(c["dx"]), abs(c["dy"])),
                                     c["dist"],
                                     sweep.default_rel_err(c["acc"]))
        h, w = z.shape
        sched = sweep.mark_safe_phases(sched, min(
            off[0], off[1], h - off[0] - inner[0], w - off[1] - inner[1]))
        azim = a["azim"].astype(np.float64)
        u_xy = a.get("u_xy")
        tables = jax.tree_util.tree_map(jnp.asarray, sweep.horizon_shift_tables(
            sched, azim, c["dx"], c["dy"], off, u_xy=u_xy, unroll=1))
        uu = np.stack([np.sin(azim), np.cos(azim)], -1) if u_xy is None \
            else u_xy
        trig = {"sin": jnp.asarray(np.sin(azim), jnp.float32),
                "cos": jnp.asarray(np.cos(azim), jnp.float32),
                "ux": jnp.asarray(uu[:, 0], jnp.float32),
                "uy": jnp.asarray(uu[:, 1], jnp.float32)}
        zj = jnp.asarray(z)
        z_in = zj[off[0]:off[0] + inner[0], off[1]:off[1] + inner[1]]
        geom = None
        z_org = z_in + jnp.float32(0.01)
        if "ex" in a:
            geom = {k: jnp.asarray(a[k]) for k in GEOM_KEYS}
            z_org = z_in + jnp.float32(0.01) * geom["mz"]
        raw, dist = sweep._horizon_core(
            zj, z_org, z_in, geom, tables, trig, sched_meta=sched.meta(),
            pads=sched.pads, inner_shape=inner, planar=geom is None,
            track_dist=True, apply_arctan=False)
        out[name + ":raw"] = np.asarray(raw)
        out[name + ":dist"] = np.asarray(dist)
    else:
        hori, _ = horizon.horizon_gridded(
            a["vert_grid"], c["dem"][0], c["dem"][1], a["vec_norm"],
            a["vec_north"], c["offset"][0], c["offset"][1],
            dist_search=c["dist_km"], azim_num=c["azim_num"],
            hori_acc=c["acc"], mask=a.get("mask"), hori_fill=c["fill"],
            engine=c["engine"], verbose=False)
        out[name + ":hori"] = np.asarray(hori)
np.savez(sys.argv[3], **out)
"""


def run_oracle(script, arrays, calls, tmp_dir):
    """Run ``script`` (argv: inputs .npz, calls .json, outputs .npz) with
    the JAX package on the CPU, evaluated as written; returns the outputs
    as a dict of arrays."""
    paths = [os.path.join(str(tmp_dir), n) for n in ("in.npz", "calls.json",
                                                     "out.npz")]
    np.savez(paths[0], **arrays)
    with open(paths[1], "w") as f:
        json.dump(calls, f)
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": AS_WRITTEN_XLA_FLAGS,
           "PYTHONPATH": os.pathsep.join(
               [_REPO, os.environ.get("PYTHONPATH", "")])}
    res = subprocess.run([sys.executable, "-c", script, *paths], env=env,
                         capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    out = np.load(paths[2])
    return {k: out[k] for k in out.files}


def ulp_diff(a, b):
    """Largest distance in float32 ulp between two float32 arrays."""
    def ordered(x):
        i = np.ascontiguousarray(x, dtype=np.float32).view(np.int32) \
            .astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int(np.abs(ordered(a) - ordered(b)).max())


def cap_normals(n, dx, dy, tilt=1.0):
    """tests/test_pallas.py:213-225's spherical-cap normals (tilt scaled by
    ``tilt``) and norths orthogonalised to them, (n, n, 3) float64."""
    r = 6.371e6 / tilt
    xs = (np.arange(n) - n / 2) * dx
    ys = (np.arange(n) - n / 2) * (-dy)
    xx, yy = np.meshgrid(xs, ys)
    norm = np.stack([-xx / r, -yy / r, np.ones_like(xx)], axis=-1)
    norm /= np.linalg.norm(norm, axis=-1, keepdims=True)
    north = np.stack([np.zeros_like(xx), np.ones_like(xx), yy / r], axis=-1)
    north -= np.sum(north * norm, axis=-1, keepdims=True) * norm
    north /= np.linalg.norm(north, axis=-1, keepdims=True)
    return norm, north


def _core_case(z, offset, inner, dist, azim_num, acc=0.25, dx=25.0,
               dy=-25.0, tilt=None):
    arrays = dict(z=z, azim=horizon.azimuth_angles(azim_num))
    if tilt is not None:
        norm, north = cap_normals(z.shape[0], dx, dy, tilt)
        sl = (slice(offset[0], offset[0] + inner[0]),
              slice(offset[1], offset[1] + inner[1]))
        n32, e32 = norm[sl].astype(np.float32), north[sl].astype(np.float32)
        arrays.update(terrain.basis_fields(n32, e32))
        arrays["u_xy"] = terrain.mean_marching_directions(arrays["azim"],
                                                          n32, e32)
    call = dict(kind="core", offset=list(offset), inner_shape=list(inner),
                dist=dist, acc=acc, dx=dx, dy=dy)
    return arrays, call


def _core_cases():
    z80 = gaussian_bumps_terrain(80, 80, seed=9, amp=600.0)
    z128 = gaussian_bumps_terrain(128, 128, seed=11, amp=400.0)
    return {
        # coarse accuracy: 16 safe d2 steps, 13 masked d1 steps (halo 24),
        # then mip levels 1-3 reading far past the grid's edge
        "bumps80_acc2_d3000_a4": _core_case(z80, (24, 24), (32, 32), 3000.0,
                                            4, acc=2.0),
        # the general basis on tests/test_pallas.py:208-252's tilted
        # normals: safe d2, safe and masked d1 (halo 32, 32 dense steps)
        "general_tilt_d800_a7": _core_case(z128, (32, 32), (64, 64), 800.0,
                                           7, tilt=30.0),
        # the general basis through mip levels 1-3
        "general_tilt_acc2_d3000_a5": _core_case(z80, (24, 24), (32, 32),
                                                 3000.0, 5, acc=2.0,
                                                 tilt=30.0),
    }


def _vert_grid(z, dx=25.0, dy=-25.0):
    h, w = z.shape
    x, y = np.meshgrid(np.arange(w, dtype=np.float32) * dx,
                       np.arange(h, dtype=np.float32) * dy)
    return auxiliary.rearrange_pad_buffer(x, y, z.astype(np.float32))


def _unit_vectors(inner):
    vec_norm = np.zeros(inner + (3,), np.float32)
    vec_norm[..., 2] = 1.0
    vec_north = np.zeros(inner + (3,), np.float32)
    vec_north[..., 1] = 1.0
    return vec_norm, vec_north


def _gridded_cases():
    cases = {}
    # tests/test_horizon.py's masked sweep (bbox crop + hori_fill) with
    # non-default vectors: the general basis, cropped to the box
    z128 = gaussian_bumps_terrain(128, 128, seed=11, amp=400.0)
    norm, north = cap_normals(128, 25.0, -25.0, tilt=30.0)
    sl = (slice(40, 88), slice(36, 84))
    mask = np.zeros((48, 48), np.uint8)
    mask[9:27, 15:42] = 1
    cases["masked_tilted_sweep"] = (
        dict(vert_grid=_vert_grid(z128),
             vec_norm=np.ascontiguousarray(norm[sl], np.float32),
             vec_north=np.ascontiguousarray(north[sl], np.float32),
             mask=mask),
        dict(kind="gridded", dem=[128, 128], offset=[40, 36], dist_km=0.9,
             azim_num=6, acc=0.25, fill=-9.0, engine="sweep"))
    # tests/test_curved.py's curved engine="sweep" (general basis on the
    # lattice box, read back at the cells)
    s = curved_setup(bumps(4), n=96, dlat=0.002)
    sl = (slice(33, 63), slice(30, 60))
    cases["curved_sweep"] = (
        dict(vert_grid=auxiliary.rearrange_pad_buffer(s["x"], s["y"],
                                                      s["z"]),
             vec_norm=np.ascontiguousarray(s["vec_norm"][sl], np.float32),
             vec_north=np.ascontiguousarray(s["vec_north"][sl], np.float32)),
        dict(kind="gridded", dem=[96, 96], offset=[33, 30], dist_km=2.0,
             azim_num=6, acc=0.25, fill=0.0, engine="sweep"))
    return cases


CORE_CASES = _core_cases()
GRIDDED_CASES = _gridded_cases()


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    arrays, calls = {}, {}
    for name, (arr, call) in {**CORE_CASES, **GRIDDED_CASES}.items():
        calls[name] = call
        arrays.update({f"{name}:{k}": v for k, v in arr.items()})
    return run_oracle(_ORACLE, arrays, calls,
                      tmp_path_factory.mktemp("sweep_engine_oracle"))


def port_core(arr, call, a_chunk=None):
    """The port's raw ratios and distances (A, in0, in1 -> in0, in1, A) on
    the case's inputs, built as the oracle builds the reference's."""
    z = torch.from_numpy(arr["z"])
    off, inner = tuple(call["offset"]), tuple(call["inner_shape"])
    sched = sweep.build_schedule(min(abs(call["dx"]), abs(call["dy"])),
                                 call["dist"],
                                 sweep.default_rel_err(call["acc"]))
    h, w = z.shape
    sched = sweep.mark_safe_phases(sched, min(
        off[0], off[1], h - off[0] - inner[0], w - off[1] - inner[1]))
    u_xy = arr.get("u_xy")
    tables = sweep.horizon_shift_tables(sched, arr["azim"], call["dx"],
                                        call["dy"], off, u_xy=u_xy, unroll=1)
    z_in = z[off[0]:off[0] + inner[0], off[1]:off[1] + inner[1]]
    geom = None
    z_org = z_in + float(np.float32(0.01))
    if "ex" in arr:
        geom = sweep.geom_fields({k: arr[k] for k in GEOM_KEYS}, "cpu")
        z_org = z_in + float(np.float32(0.01)) * geom["mz"]
    return sweep.horizon_core(
        z, z_org, z_in, geom, tables, sweep.sweep_trig(arr["azim"], u_xy),
        sched_meta=sched.meta(), pads=sched.pads, inner_shape=inner,
        planar=geom is None, track_dist=True, apply_arctan=False,
        a_chunk=a_chunk)


@pytest.mark.parametrize("name", sorted(CORE_CASES))
def test_raw_ratios_match_xla_engine(oracle, name):
    arr, call = CORE_CASES[name]
    raw, dist = port_core(arr, call)
    ref_raw, ref_dist = oracle[name + ":raw"], oracle[name + ":dist"]
    assert raw.dtype == torch.float32 and tuple(raw.shape) == ref_raw.shape
    assert np.isfinite(raw.numpy()).all()
    d = ulp_diff(raw.numpy(), ref_raw)
    print(f"{name}: raw ratios within {d} ulp, "
          f"{int((raw.numpy() != ref_raw).sum())} of {ref_raw.size} differ")
    assert d <= ULPS
    np.testing.assert_array_equal(dist.numpy(), ref_dist)
    assert (ref_dist > 0).all()


@pytest.mark.parametrize("name", sorted(GRIDDED_CASES))
def test_gridded_xla_routes_match_jax(oracle, name):
    arr, call = GRIDDED_CASES[name]
    hori, azim = horizon.horizon_gridded(
        arr["vert_grid"], call["dem"][0], call["dem"][1], arr["vec_norm"],
        arr["vec_north"], call["offset"][0], call["offset"][1],
        dist_search=call["dist_km"], azim_num=call["azim_num"],
        hori_acc=call["acc"], mask=arr.get("mask"), hori_fill=call["fill"],
        engine=call["engine"], verbose=False, device="cpu")
    ref = oracle[name + ":hori"]
    assert hori.device.type == "cpu" and tuple(hori.shape) == ref.shape
    err = np.abs(hori.numpy() - ref).max()
    print(f"{name}: max |hori - ref| {err:.3e} rad")
    assert err <= ANGLE_TOL
    if "mask" in arr:
        keep = arr["mask"] == 1
        assert (hori.numpy()[~keep] == -9.0).all()
        assert (hori.numpy()[keep] > -0.3).all()


def test_azimuth_chunks_do_not_change_values():
    arr, call = CORE_CASES["general_tilt_d800_a7"]
    full, dist = port_core(arr, call, a_chunk=7)
    for a_chunk in (1, 3):
        got, got_dist = port_core(arr, call, a_chunk=a_chunk)
        assert torch.equal(got, full) and torch.equal(got_dist, dist)
    # the chunk rule: the fewest chunks within the element budget, balanced
    per = sweep.MAX_CHUNK_ELEMS // (1025 * 1025)
    assert sweep.azimuth_chunk(32, (1024, 1024)) == 16 < per
    assert sweep.azimuth_chunk(7, (64, 64)) == 7
    assert sweep.azimuth_chunk(360, (2048, 2048)) == 7


def test_padded_levels_equal_padded_pyramid():
    """ops/mip.padded_levels is the reference's padded_pyramid for the
    engine's pads (max-pools and pads are exact)."""
    for name in sorted(CORE_CASES):
        arr, call = CORE_CASES[name]
        sched = sweep.build_schedule(25.0, call["dist"],
                                     sweep.default_rel_err(call["acc"]))
        got = mip.padded_levels(torch.from_numpy(arr["z"]), sched.pads)
        ref = mip_ref.padded_pyramid(arr["z"], len(sched.pads), sched.pads)
        assert len(got) == len(ref) == len(sched.pads)
        assert len(sched.pads) == (4 if "d3000" in name else 1)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_pyramid_gradient_splits_ties_as_jax():
    """Where heights tie (a plateau, the sentinel), the pyramid's max-pools
    send half the cotangent to each side of a tie, as ``jnp.maximum``'s
    VJP does (``torch.clamp_min`` would send all of it to one side): the
    gradient of the padded levels, through the XLA engines' autograd,
    equal to ``jax.vjp`` of the reference's ``padded_pyramid``."""
    import jax
    import jax.numpy as jnp
    z = np.minimum(gaussian_bumps_terrain(37, 45, seed=2, amp=400.0),
                   np.float32(150.0))
    pads = (3, 4, 2, 5)
    rng = np.random.default_rng(1)
    zz = torch.from_numpy(z).requires_grad_(True)
    levels = mip.padded_levels(zz, pads)
    cots = [rng.standard_normal(tuple(lv.shape)).astype(np.float32)
            for lv in levels]
    torch.autograd.backward(levels, [torch.from_numpy(c) for c in cots])
    _, vjp = jax.vjp(lambda a: mip_ref.padded_pyramid(a, len(pads), pads),
                     jnp.asarray(z))
    (ref,) = vjp([jnp.asarray(c) for c in cots])
    assert (z == 150.0).sum() > 100
    np.testing.assert_allclose(zz.grad.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)


def test_tilt_ramp_matches_general_basis():
    """tests/test_pallas.py:208-252 on the port: the fused sweep with the
    curved-Earth tilt ramp (plain version on the CPU) against the general
    per-cell basis of the XLA engine."""
    n, dx, dy = 128, 25.0, -25.0
    z = gaussian_bumps_terrain(n, n, seed=11, amp=400.0)
    norm, north = cap_normals(n, dx, dy)
    off, inner, azim_num = (32, 32), (64, 64), 8
    sl = (slice(32, 96), slice(32, 96))
    azim = horizon.azimuth_angles(azim_num)
    n32, e32 = norm[sl].astype(np.float32), north[sl].astype(np.float32)
    h_gen, _ = sweep.horizon_sweep(
        torch.from_numpy(z), dx=dx, dy=dy, offset=off, inner_shape=inner,
        azim=azim, dist_search=800.0, hori_acc=0.25,
        geom=terrain.basis_fields(n32, e32),
        u_xy=terrain.mean_marching_directions(azim, n32, e32))
    ramp = tuple(torch.from_numpy((norm[sl][..., k] / norm[sl][..., 2])
                                  .astype(np.float32)) for k in (0, 1))
    h_tilt = fused_sweep.horizon_sweep_fused(
        torch.from_numpy(z), dx=dx, dy=dy, offset=off, inner_shape=inner,
        azim_num=azim_num, dist_search=800.0, hori_acc=0.25,
        tilt_ramp=ramp)
    d = np.rad2deg(np.abs(h_tilt.numpy() - h_gen.numpy()))
    assert d.max() < 0.25, f"max diff {d.max():.4f} deg"


def test_engine_routing():
    """Default vectors: "auto" and "pallas" take the fused sweep, "sweep"
    the XLA engine; non-default vectors take the general basis under
    "auto" and "sweep" alike and "pallas" refuses them, as
    horayzon_tpu/horizon.py:448-484 routes them."""
    arr, call = GRIDDED_CASES["masked_tilted_sweep"]
    kw = dict(dist_search=0.9, azim_num=6, verbose=False, device="cpu")
    args = (arr["vert_grid"], 128, 128)
    vn, ve = _unit_vectors(arr["vec_norm"].shape[:2])
    z = torch.from_numpy(gaussian_bumps_terrain(128, 128, seed=11,
                                                amp=400.0))
    fused = fused_sweep.horizon_sweep_fused(
        z, dx=25.0, dy=-25.0, offset=(40, 36), inner_shape=(48, 48),
        azim_num=6, dist_search=900.0)
    xla, _ = sweep.horizon_sweep(
        z, dx=25.0, dy=-25.0, offset=(40, 36), inner_shape=(48, 48),
        azim=horizon.azimuth_angles(6), dist_search=900.0)
    for engine, want in (("auto", fused), ("pallas", fused),
                         ("sweep", xla)):
        got, _ = horizon.horizon_gridded(*args, vn, ve, 40, 36,
                                         engine=engine, **kw)
        assert torch.equal(got, want), engine
    assert not torch.equal(fused, xla)       # two different estimators
    auto, _ = horizon.horizon_gridded(*args, arr["vec_norm"],
                                      arr["vec_north"], 40, 36, **kw)
    swp, _ = horizon.horizon_gridded(*args, arr["vec_norm"],
                                     arr["vec_north"], 40, 36,
                                     engine="sweep", **kw)
    assert torch.equal(auto, swp)
    with pytest.raises(ValueError, match="engine='pallas'"):
        horizon.horizon_gridded(*args, arr["vec_norm"], arr["vec_north"],
                                40, 36, engine="pallas", **kw)
    # an all-masked sweep gives the fill everywhere (test_horizon.py)
    got, _ = horizon.horizon_gridded(
        *args, vn, ve, 40, 36, mask=np.zeros((48, 48), np.uint8),
        hori_fill=0.5, engine="sweep", **kw)
    assert torch.all(got == 0.5)
