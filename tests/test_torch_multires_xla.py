"""The port's XLA multires engine (``ops/multires.horizon_sweep_multires``:
``ops/sweep.horizon_core`` on the combined fine + coarse pyramid) and the
TIN route's ``engine="sweep"`` on the CPU against the JAX package; and the
TIN route's ratio on a scene where the reference's tile padding would
shrink the fine halo.

The reference runs in one subprocess evaluated as written
(``test_torch_fused_sweep.AS_WRITTEN_XLA_FLAGS``).

The TIN scene: a 200^2 fine grid at 25 m, a 16 x 32 inner block 50 cells
from the west edge, 3 km at accuracy 5 degree, and a TIN of a lattice every
12 cells (72 cells per triangle: a first ratio of 2^3).  Off a TPU the
reference checks the fine halo against the block as it is (50 cells: ratio
3 fits).  On a TPU its kernel route pads the block to 16 x 128
(``horizon.py:621-649``), which leaves 22 cells east of it, and ratio 3 and
2 no longer fit: its ratio is 1 there.  The port's ratio is the one off a
TPU.

Tolerances:
* raw ratios (``apply_arctan=False``) within 2 float32 ulp and the
  winners' distances (``track_dist``) equal, both sides on shift tables of
  one sample per scan step (as ``tests/test_torch_sweep_engine.py``);
* angles of ``horizon_gridded`` within 2.4e-7 rad (two float32 ulp at 1:
  the two sides' arctan);
* the port's fused TIN route within 1e-5 rad of interpret-mode
  ``horizon_sweep_multires_pallas`` at the port's ratio
  (``tests/test_torch_multires.py``'s tolerance);
* the multires sweep within ``2 * hori_acc`` of the full-resolution sweep
  (``tests/test_multires.py:15-49``).

CPU cost: about 28 s of wall on one core and 45 s of CPU (pytest's count
and the shell's; XLA compiles the reference on several threads), most
of it the JAX side's compiles and import.
"""

import numpy as np
import pytest
import torch

from horayzon_tpu_torch import auxiliary, horizon, terrain
from horayzon_tpu_torch.ops import multires, sweep

from reference_impl import gaussian_bumps_terrain
from test_torch_sweep_engine import (GEOM_KEYS, cap_normals, run_oracle,
                                     ulp_diff)

ULPS = 2
ANGLE_TOL = 2.4e-7
TOL = 1.0e-5

_ORACLE = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from horayzon_tpu import horizon
from horayzon_tpu.ops import multires, sweep
from horayzon_tpu.terrain import GridSpec
GEOM_KEYS = ("ex", "ey", "ez", "nx2", "ny2", "nz2", "mx", "my", "mz")
inputs = np.load(sys.argv[1])
calls = json.load(open(sys.argv[2]))
out = {}
for name, c in calls.items():
    a = {k[len(name) + 1:]: inputs[k] for k in inputs.files
         if k.startswith(name + ":")}
    if c["kind"] == "core":
        zf, zc = a["zf"], a["zc"]
        off, inner = tuple(c["offset"]), tuple(c["inner_shape"])
        sched = sweep.build_schedule(25.0, c["dist"],
                                     sweep.default_rel_err(c["acc"]))
        pyr = multires.combined_pyramid(jnp.asarray(zf), jnp.asarray(zc),
                                        c["ratio_log2"],
                                        tuple(c["coarse_offset"]), sched)
        azim = a["azim"].astype(np.float64)
        u_xy = a.get("u_xy")
        tables = jax.tree_util.tree_map(jnp.asarray, sweep.horizon_shift_tables(
            sched, azim, 25.0, -25.0, off, u_xy=u_xy, unroll=1))
        uu = np.stack([np.sin(azim), np.cos(azim)], -1) if u_xy is None \
            else u_xy
        trig = {"sin": jnp.asarray(np.sin(azim), jnp.float32),
                "cos": jnp.asarray(np.cos(azim), jnp.float32),
                "ux": jnp.asarray(uu[:, 0], jnp.float32),
                "uy": jnp.asarray(uu[:, 1], jnp.float32)}
        z_in = jnp.asarray(zf)[off[0]:off[0] + inner[0],
                               off[1]:off[1] + inner[1]]
        geom = None
        z_org = z_in + jnp.float32(0.01)
        if "ex" in a:
            geom = {k: jnp.asarray(a[k]) for k in GEOM_KEYS}
            z_org = z_in + jnp.float32(0.01) * geom["mz"]
        raw, dist = sweep._horizon_core(
            tuple(pyr), z_org, z_in, geom, tables, trig,
            sched_meta=sched.meta(), pads=sched.pads, inner_shape=inner,
            planar=geom is None, track_dist=True, outer_shape=zf.shape,
            apply_arctan=False)
        out[name + ":raw"] = np.asarray(raw)
        out[name + ":dist"] = np.asarray(dist)
        continue
    # the TIN route: the ratio each engine picks, the XLA route's result,
    # and interpret-mode Pallas at the ratio given
    ratios = {}
    orig_xla = multires.horizon_sweep_multires

    def xla(*args, **kw):
        ratios["sweep"] = kw["ratio_log2"]
        return orig_xla(*args, **kw)

    def pallas(z, zc, **kw):
        ratios["tpu"] = kw["ratio_log2"]
        return jnp.zeros(tuple(kw["inner_shape"]) + (kw["azim_num"],))

    multires.horizon_sweep_multires = xla
    orig_pallas = multires.horizon_sweep_multires_pallas
    multires.horizon_sweep_multires_pallas = pallas
    args = (a["vert_grid"], c["dem"][0], c["dem"][1], a["vec_norm"],
            a["vec_north"], c["offset"][0], c["offset"][1], c["dist_km"])
    kw = dict(azim_num=c["azim_num"], hori_acc=c["acc"], verbose=False,
              vert_simp=a["verts"], num_vert_simp=len(a["verts"]) // 3,
              tri_ind_simp=a["tris"], num_tri_simp=len(a["tris"]) // 3)
    hori, _ = horizon.horizon_gridded(*args, engine="sweep", **kw)
    out[name + ":hori_sweep"] = np.asarray(hori)
    horizon._on_tpu = lambda: True
    horizon.horizon_gridded(*args, engine="auto", **kw)
    multires.horizon_sweep_multires_pallas = orig_pallas
    out[name + ":ratio_sweep"] = np.asarray(ratios["sweep"])
    out[name + ":ratio_tpu"] = np.asarray(ratios["tpu"])
    z = a["z"]
    grid = GridSpec(x0=0.0, y0=0.0, dx=25.0, dy=-25.0, shape=z.shape)
    zc, coff = multires.coarse_grid_from_tin(
        a["verts"], a["tris"], grid=grid, fine_shape=z.shape, z_fine=z,
        ratio_log2=c["ratio_log2"], dist_search=c["dist_km"] * 1000.0)
    out[name + ":hori_pallas"] = np.asarray(
        multires.horizon_sweep_multires_pallas(
            z, zc, ratio_log2=c["ratio_log2"], coarse_offset=coff, dx=25.0,
            dy=-25.0, offset=tuple(c["offset"]),
            inner_shape=tuple(c["inner_shape"]), azim_num=c["azim_num"],
            dist_search=c["dist_km"] * 1000.0, hori_acc=c["acc"],
            tile=tuple(c["inner_shape"]), a_chunk=4, interpret=True))
np.savez(sys.argv[3], **out)
"""


def _downsample_max(z, r):
    h, w = z.shape
    return z[:h - h % r, :w - w % r].reshape(h // r, r, w // r, r) \
        .max(axis=(1, 3))


def _scene_r2():
    """tests/test_multires.py:51-84: ratio_log2 2, a 96-cell fine halo,
    4 km, accuracy 2, a 32^2 inner block."""
    dist, inner, halo_fine = 4000.0, 32, 96
    halo_full = int(dist / 25.0) + 16
    n_full = inner + 2 * halo_full
    full = gaussian_bumps_terrain(n_full, n_full, seed=9, amp=500.0)
    i0 = halo_full - halo_fine
    z_fine = np.ascontiguousarray(full[i0:i0 + inner + 2 * halo_fine,
                                       i0:i0 + inner + 2 * halo_fine])
    kw = dict(ratio_log2=2, coarse_offset=[i0, i0],
              offset=[halo_fine, halo_fine], inner_shape=[inner, inner],
              dist=dist, acc=2.0)
    return full, z_fine, _downsample_max(full, 4), kw, halo_full


def _core_cases():
    full, zf, zc, kw, _ = _scene_r2()
    azim = horizon.azimuth_angles(8)
    general = dict(zf=zf, zc=zc, azim=horizon.azimuth_angles(5))
    norm, north = cap_normals(zf.shape[0], 25.0, -25.0, tilt=30.0)
    sl = (slice(96, 128), slice(96, 128))
    n32, e32 = norm[sl].astype(np.float32), north[sl].astype(np.float32)
    general.update(terrain.basis_fields(n32, e32))
    general["u_xy"] = terrain.mean_marching_directions(general["azim"], n32,
                                                       e32)
    return {"r2_planar_a8": (dict(zf=zf, zc=zc, azim=azim),
                             dict(kw, kind="core")),
            "r2_general_a5": (general, dict(kw, kind="core"))}


def _tin_scene():
    """See the module docstring: (arrays, call) of the TIN case."""
    n, dx, step = 200, 25.0, 12
    reach = 120                               # 3 km in cells
    lat = np.arange(-reach, n + reach + 1, step)

    def height(i, j):
        h = np.zeros(np.broadcast(i, j).shape)
        for ci, cj, amp, sig in ((40.0, 150.0, 500.0, 30.0),
                                 (160.0, 30.0, 400.0, 25.0),
                                 (-60.0, 90.0, 700.0, 40.0),
                                 (250.0, 260.0, 600.0, 35.0),
                                 (100.0, 100.0, 150.0, 12.0)):
            h += amp * np.exp(-((i - ci) ** 2 + (j - cj) ** 2)
                              / (2.0 * sig ** 2))
        return h

    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    z = height(ii, jj).astype(np.float32)
    vi, vj = np.meshgrid(lat, lat, indexing="ij")
    verts = np.stack([vj * dx, -vi * dx, height(vi, vj)], axis=-1) \
        .reshape(-1, 3).astype(np.float32)
    m = len(lat)
    q = np.arange(m - 1)
    qi, qj = np.meshgrid(q, q, indexing="ij")
    a = (qi * m + qj).ravel()
    tris = np.concatenate([np.stack([a, a + 1, a + m], -1),
                           np.stack([a + 1, a + m + 1, a + m], -1)]) \
        .astype(np.int32).ravel()
    x, y = np.meshgrid(np.arange(n, dtype=np.float32) * dx,
                       -np.arange(n, dtype=np.float32) * dx)
    inner = (16, 32)
    vec_norm = np.zeros(inner + (3,), np.float32)
    vec_norm[..., 2] = 1.0
    vec_north = np.zeros(inner + (3,), np.float32)
    vec_north[..., 1] = 1.0
    arrays = dict(z=z, verts=verts.ravel(), tris=tris, vec_norm=vec_norm,
                  vec_north=vec_north,
                  vert_grid=auxiliary.rearrange_pad_buffer(x, y, z))
    call = dict(kind="tin", dem=[n, n], offset=[90, 50],
                inner_shape=list(inner), dist_km=3.0, acc=5.0, azim_num=4)
    return arrays, call


CORE_CASES = _core_cases()
TIN_ARRAYS, TIN_CALL = _tin_scene()


def _port_ratio():
    a, c = TIN_ARRAYS, TIN_CALL
    grid = terrain.GridSpec(x0=0.0, y0=0.0, dx=25.0, dy=-25.0,
                            shape=a["z"].shape)
    return horizon.tin_ratio_log2(
        grid, a["z"].shape, a["verts"], len(a["verts"]) // 3, a["tris"],
        len(a["tris"]) // 3, offset=tuple(c["offset"]),
        inner_shape=tuple(c["inner_shape"]), dist_search=c["dist_km"] * 1e3,
        hori_acc=c["acc"])


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    arrays, calls = {}, {}
    for name, (arr, call) in CORE_CASES.items():
        calls[name] = call
        arrays.update({f"{name}:{k}": v for k, v in arr.items()})
    calls["tin"] = dict(TIN_CALL, ratio_log2=_port_ratio())
    arrays.update({f"tin:{k}": v for k, v in TIN_ARRAYS.items()})
    return run_oracle(_ORACLE, arrays, calls,
                      tmp_path_factory.mktemp("multires_xla_oracle"))


def port_core(arr, call):
    """The port's raw ratios and distances on the combined pyramid, built
    as the oracle builds the reference's."""
    zf, zc = torch.from_numpy(arr["zf"]), torch.from_numpy(arr["zc"])
    off, inner = tuple(call["offset"]), tuple(call["inner_shape"])
    sched = sweep.build_schedule(25.0, call["dist"],
                                 sweep.default_rel_err(call["acc"]))
    pyr = multires.combined_pyramid(zf, zc, call["ratio_log2"],
                                    tuple(call["coarse_offset"]), sched)
    u_xy = arr.get("u_xy")
    tables = sweep.horizon_shift_tables(sched, arr["azim"], 25.0, -25.0, off,
                                        u_xy=u_xy, unroll=1)
    z_in = zf[off[0]:off[0] + inner[0], off[1]:off[1] + inner[1]]
    geom = None
    z_org = z_in + float(np.float32(0.01))
    if "ex" in arr:
        geom = sweep.geom_fields({k: arr[k] for k in GEOM_KEYS}, "cpu")
        z_org = z_in + float(np.float32(0.01)) * geom["mz"]
    return sweep.horizon_core(
        tuple(pyr), z_org, z_in, geom, tables,
        sweep.sweep_trig(arr["azim"], u_xy), sched_meta=sched.meta(),
        pads=sched.pads, inner_shape=inner, planar=geom is None,
        track_dist=True, outer_shape=tuple(zf.shape), apply_arctan=False)


@pytest.mark.parametrize("name", sorted(CORE_CASES))
def test_multires_raw_ratios_match_xla_engine(oracle, name):
    arr, call = CORE_CASES[name]
    raw, dist = port_core(arr, call)
    ref_raw = oracle[name + ":raw"]
    assert tuple(raw.shape) == ref_raw.shape
    d = ulp_diff(raw.numpy(), ref_raw)
    print(f"{name}: raw ratios within {d} ulp")
    assert d <= ULPS
    np.testing.assert_array_equal(dist.numpy(), oracle[name + ":dist"])


def test_multires_matches_full_resolution():
    """tests/test_multires.py:15-49 on the port: the fine + coarse sweep
    against the full-resolution sweep, within the far-field budget (the
    coarse far field is a conservative max-pool); and the public entry
    against the core it wraps."""
    full, zf, zc, kw, halo_full = _scene_r2()
    azim = horizon.azimuth_angles(8)
    geo = dict(dx=25.0, dy=-25.0, inner_shape=tuple(kw["inner_shape"]),
               azim=azim, dist_search=kw["dist"], hori_acc=kw["acc"])
    h_full, _ = sweep.horizon_sweep(torch.from_numpy(full),
                                    offset=(halo_full, halo_full), **geo)
    h_mr = multires.horizon_sweep_multires(
        torch.from_numpy(zf), torch.from_numpy(zc), ratio_log2=2,
        coarse_offset=tuple(kw["coarse_offset"]),
        offset=tuple(kw["offset"]), **geo)
    d = np.rad2deg(np.abs(h_mr.numpy() - h_full.numpy()))
    assert d.max() < 2 * kw["acc"], f"multires max diff {d.max():.3f} deg"
    with pytest.raises(ValueError, match="fine-grid halo"):
        multires.horizon_sweep_multires(
            torch.from_numpy(zf[60:-60, 60:-60]), torch.from_numpy(zc),
            ratio_log2=2, coarse_offset=tuple(v + 60 for v in
                                              kw["coarse_offset"]),
            offset=(36, 36), **geo)


def test_tin_ratio_is_the_reference_off_a_tpu(oracle):
    """The reference's ratio depends on the device: ratio 3 off a TPU
    (the block as it is), 1 on a TPU (the block padded to tile
    multiples).  The port's is the one off a TPU."""
    got = _port_ratio()
    assert got == int(oracle["tin:ratio_sweep"]) == 3
    assert int(oracle["tin:ratio_tpu"]) == 1


def test_tin_routes_match_reference(oracle):
    a, c = TIN_ARRAYS, TIN_CALL
    args = (a["vert_grid"], c["dem"][0], c["dem"][1], a["vec_norm"],
            a["vec_north"], c["offset"][0], c["offset"][1], c["dist_km"])
    kw = dict(azim_num=c["azim_num"], hori_acc=c["acc"], verbose=False,
              device="cpu", vert_simp=a["verts"],
              num_vert_simp=len(a["verts"]) // 3, tri_ind_simp=a["tris"],
              num_tri_simp=len(a["tris"]) // 3)
    h_sweep, _ = horizon.horizon_gridded(*args, engine="sweep", **kw)
    ref = oracle["tin:hori_sweep"]
    err = np.abs(h_sweep.numpy() - ref).max()
    print(f"TIN sweep route: max |hori - ref| {err:.3e} rad")
    assert err <= ANGLE_TOL
    h_fused, _ = horizon.horizon_gridded(*args, **kw)
    err = np.abs(h_fused.numpy() - oracle["tin:hori_pallas"]).max()
    print(f"TIN fused route: max |hori - interpret Pallas| {err:.3e} rad")
    assert err <= TOL
    # two estimators of one horizon: within the accuracy knob
    d = np.rad2deg(np.abs(h_fused.numpy() - h_sweep.numpy()))
    assert d.max() < c["acc"]
