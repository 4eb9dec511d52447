"""The port's planar slice end to end against the JAX package:
``horizon_gridded``, ``topo_param`` and ``PlanarPipeline`` on the CPU.

Tolerances:
* horizon and derived parameters against the same reference functions on
  identical inputs: 1e-5 (radian, or unitless for SVF and normals): float32
  rounding of the same formulas;
* ``PlanarPipeline`` against the JAX ``PlanarPipeline``: on the CPU the
  JAX pipeline takes its XLA sweep, not the kernel, and the two engines
  differ by design (d1 pairs against trailing windows), so they are held
  to the accuracy contract: hori within 0.5 degree, svf within 1e-2.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from horayzon_tpu import horizon as horizon_ref
from horayzon_tpu import topo_param as topo_ref
from horayzon_tpu.models import PlanarPipeline as PlanarPipelineRef
from horayzon_tpu_torch import auxiliary, horizon, topo_param
from horayzon_tpu_torch.models import PlanarPipeline
from horayzon_tpu_torch.utils import profiling

from reference_impl import gaussian_bumps_terrain
from test_torch_fused_sweep import interpret_reference
from torch_scenes import (PIPELINE_MASKS, curved_buffer_route,
                          curved_pipeline_scene, planar_buffer_route,
                          planar_pipeline_scene)

TOL = 1.0e-5


def _planar_inputs(n=88, halo=28, dx=25.0, dy=-30.0, seed=11):
    z = gaussian_bumps_terrain(n, n, seed=seed, amp=350.0)
    x1 = np.arange(n, dtype=np.float32) * dx
    y1 = (n - 1 - np.arange(n, dtype=np.float32)) * -dy
    x, y = np.meshgrid(x1, y1)
    inner = n - 2 * halo
    vec_norm = np.zeros((inner, inner, 3), dtype=np.float32)
    vec_norm[..., 2] = 1.0
    vec_north = np.zeros((inner, inner, 3), dtype=np.float32)
    vec_north[..., 1] = 1.0
    return dict(z=z, x=x, y=y, halo=halo, inner=inner, vec_norm=vec_norm,
                vec_north=vec_north, dx=dx, dy=dy,
                vert_grid=auxiliary.rearrange_pad_buffer(x, y, z))


def _gridded(p, **kw):
    args = dict(dist_search=1.1, azim_num=6, hori_acc=0.25, verbose=False)
    args.update(kw)
    n = p["z"].shape[0]
    return horizon.horizon_gridded(
        p["vert_grid"], n, n, p["vec_norm"], p["vec_north"], p["halo"],
        p["halo"], device="cpu", **args)


def _gridded_ref(p, **kw):
    """The JAX package's ``horizon_gridded`` on :func:`_gridded`'s
    arguments."""
    args = dict(dist_search=1.1, azim_num=6, hori_acc=0.25, verbose=False)
    args.update(kw)
    n = p["z"].shape[0]
    return horizon_ref.horizon_gridded(
        p["vert_grid"], n, n, p["vec_norm"], p["vec_north"], p["halo"],
        p["halo"], **args)


def test_horizon_gridded_matches_interpret_pallas(tmp_path):
    p = _planar_inputs()
    hori, azim = _gridded(p)
    assert hori.dtype == torch.float32 and hori.device.type == "cpu"
    np.testing.assert_array_equal(azim.numpy(),
                                  horizon_ref.azimuth_angles(6))
    (ref,) = interpret_reference([(p["z"], dict(
        dx=p["dx"], dy=p["dy"], offset=(p["halo"], p["halo"]),
        inner_shape=(p["inner"], p["inner"]), azim_num=6,
        dist_search=1100.0, hori_acc=0.25))], tmp_path)
    assert hori.shape == ref.shape
    assert np.abs(hori.numpy() - ref).max() <= TOL
    # an all-ones mask is the unmasked run
    ones = np.ones((p["inner"],) * 2, dtype=np.uint8)
    assert torch.equal(_gridded(p, mask=ones)[0], hori)


def test_horizon_gridded_validation_matches_reference():
    p = _planar_inputs()
    n = p["z"].shape[0]
    for kw, exc in [(dict(hori_acc=11.0), ValueError),
                    (dict(ray_algorithm="nope"), ValueError),
                    (dict(geom_type="nope"), ValueError),
                    (dict(engine="nope"), ValueError),
                    (dict(ray_org_elev=0.001), TypeError),
                    (dict(mask=np.ones((3, 3), np.uint8)), ValueError),
                    (dict(mask=np.ones((p["inner"],) * 2, np.float32)),
                     TypeError),
                    (dict(vert_simp=np.zeros(3, np.float32)), ValueError)]:
        with pytest.raises(exc):
            _gridded(p, **kw)
        with pytest.raises(exc):
            horizon_ref.horizon_gridded(
                p["vert_grid"], n, n, p["vec_norm"], p["vec_north"],
                p["halo"], p["halo"], dist_search=1.1, azim_num=6,
                verbose=False, **kw)


def test_unported_branches_raise():
    """Every branch is ported now: masks with zeros, curved grids, the
    simplified outer TIN (tests/test_torch_masked.py,
    tests/test_torch_curved.py, tests/test_torch_multires.py) and the XLA
    engine's routes (tests/test_torch_sweep_engine.py).  What still
    raises is what the reference refuses: the XLA multires engine on a
    fine halo too small for even ratio 1, and ``engine="pallas"`` with
    non-default vectors."""
    p = _planar_inputs()
    for fn in (_gridded, _gridded_ref):
        with pytest.raises(ValueError, match="fine-grid halo"):
            fn(p, engine="sweep", vert_simp=np.zeros(9, np.float32),
               tri_ind_simp=np.zeros(3, np.int32))
    hori, _ = _gridded(p, engine="sweep")
    assert hori.shape == (p["inner"], p["inner"], 6)
    tilted = p["vec_norm"].copy()
    tilted[..., 0] = 0.1
    tilted /= np.linalg.norm(tilted, axis=-1, keepdims=True)
    hori, _ = _gridded(dict(p, vec_norm=tilted))
    assert torch.isfinite(hori).all()
    for fn in (_gridded, _gridded_ref):
        with pytest.raises(ValueError, match="engine='pallas'"):
            fn(dict(p, vec_norm=tilted), engine="pallas")
    mask = np.ones((p["inner"],) * 2, dtype=np.uint8)
    mask[:4] = 0
    hori, _ = _gridded(p, mask=mask, hori_fill=-2.0)
    assert (hori[:4] == -2.0).all() and (hori[4:] > -0.3).all()


def test_topo_param_matches_reference():
    p = _planar_inputs()
    rng = np.random.default_rng(3)
    hori = rng.uniform(-0.2, 0.6, (20, 24, 16)).astype(np.float32)
    x, y, z = (a[:22, :26] for a in (p["x"], p["y"], p["z"]))
    got = topo_param.slope_plane_meth(x, y, z)
    ref = topo_ref.slope_plane_meth(x, y, z)
    assert got.shape == ref.shape == (22, 26, 3)
    assert np.isnan(got.numpy()[0]).all() and np.isnan(ref[0]).all()
    np.testing.assert_allclose(got.numpy()[1:-1, 1:-1], ref[1:-1, 1:-1],
                               rtol=0, atol=TOL)
    # with per-cell rotations, in the rotated and the original frame
    ang = rng.uniform(-0.3, 0.3, (22, 26))
    rot = np.zeros((22, 26, 3, 3), np.float32)
    rot[..., 0, 0] = np.cos(ang)
    rot[..., 0, 2] = -np.sin(ang)
    rot[..., 1, 1] = 1.0
    rot[..., 2, 0] = np.sin(ang)
    rot[..., 2, 2] = np.cos(ang)
    for output_rot in (False, True):
        g = topo_param.slope_plane_meth(x, y, z, rot_mat=rot,
                                        output_rot=output_rot)
        r = topo_ref.slope_plane_meth(x, y, z, rot_mat=rot,
                                      output_rot=output_rot)
        np.testing.assert_allclose(g.numpy()[1:-1, 1:-1], r[1:-1, 1:-1],
                                   rtol=0, atol=TOL)
    vt = ref[1:-1, 1:-1]
    azim = horizon_ref.azimuth_angles(16)
    np.testing.assert_allclose(
        topo_param.sky_view_factor(azim, hori, vt).numpy(),
        topo_ref.sky_view_factor(azim, hori, vt), rtol=0, atol=TOL)
    for g, r in zip(topo_param.slope_angle_aspect(vt),
                    topo_ref.slope_angle_aspect(vt)):
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=TOL)
    for fn in (topo_param.slope_plane_meth, topo_ref.slope_plane_meth):
        with pytest.raises(ValueError, match="Inconsistent"):
            fn(x, y, z[:-1])
        with pytest.raises(ValueError, match="incorrect data type"):
            fn(x.astype(np.int32), y, z)
    for fn in (topo_param.sky_view_factor, topo_ref.sky_view_factor):
        with pytest.raises(ValueError, match="Inconsistent"):
            fn(azim[:-1], hori, vt)


def test_planar_pipeline_matches_reference():
    """tests/test_models.py's end-to-end case through both pipelines."""
    n, dx = 120, 25.0
    z = gaussian_bumps_terrain(n, n, seed=4, amp=400.0)
    x = np.arange(n, dtype=np.float32) * dx
    y = (n - 1 - np.arange(n, dtype=np.float32)) * dx
    pad = 500.0
    domain = {"x_min": float(x.min()) + pad, "x_max": float(x.max()) - pad,
              "y_min": float(y.min()) + pad, "y_max": float(y.max()) - pad}
    got = PlanarPipeline(x, y, z, domain, dist_search=0.4, azim_num=12,
                         device="cpu").run()
    ref = PlanarPipelineRef(x, y, z, domain, dist_search=0.4,
                            azim_num=12).run()
    assert set(got) == set(ref)
    for key in ("azim", "elevation", "x", "y"):
        np.testing.assert_array_equal(got[key].numpy(), ref[key])
    d = np.rad2deg(np.abs(got["hori"].numpy() - ref["hori"]))
    assert d.max() < 0.5, f"hori max diff {d.max():.3f} deg"
    assert np.abs(got["svf"].numpy() - ref["svf"]).max() < 1e-2
    for key in ("vec_tilt", "slope", "aspect"):
        np.testing.assert_allclose(got[key].numpy(), ref[key], rtol=0,
                                   atol=TOL)
    svf = got["svf"]
    assert torch.isfinite(svf).all() and (svf > 0.3).all() \
        and (svf <= 1.001).all()


def test_planar_pipeline_mask_with_zeros_not_ported():
    """A mask with zeros, once not ported, now runs the mask variant:
    masked cells get the fill (0), the others the unmasked run's values."""
    n, dx = 80, 25.0
    z = np.zeros((n, n), dtype=np.float32)
    x = np.arange(n, dtype=np.float32) * dx
    y = (n - 1 - np.arange(n, dtype=np.float32)) * dx
    pad = 400.0
    domain = {"x_min": float(x.min()) + pad, "x_max": float(x.max()) - pad,
              "y_min": float(y.min()) + pad, "y_max": float(y.max()) - pad}
    pipe = PlanarPipeline(x, y, z, domain, dist_search=0.3, azim_num=8,
                          device="cpu")
    in0 = pipe.slice_in[0].stop - pipe.slice_in[0].start
    in1 = pipe.slice_in[1].stop - pipe.slice_in[1].start
    mask = np.ones((in0, in1), dtype=np.uint8)
    mask[:5] = 0
    masked = pipe.run(mask=mask)
    out = pipe.run(mask=np.ones((in0, in1), dtype=np.uint8))
    # flat plane: the horizon is the ray-origin offset seen from afar
    assert out["hori"].abs().max().item() < 1e-3
    assert (masked["hori"][:5] == 0.0).all()
    assert torch.equal(masked["hori"][5:], out["hori"][5:])


def _traced_routes(call):
    """``call()``'s result under the profiler, and the routes
    ``horizon.gridded_planes`` counted in it."""
    profiling.reset_counters()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            out = call()
        return out, profiling.routes()
    finally:
        profiling.reset_counters()


@pytest.mark.parametrize("mask", PIPELINE_MASKS)
def test_axes_route_bit_equal_to_buffer_route(mask, monkeypatch, capsys):
    """Uniform 1-D axes take the fused sweep straight from the axes and
    the heights, with no full-array grid test: every output
    ``torch.equal`` to the vertex-buffer route through
    ``horizon_gridded`` (unmasked, glacier-style patches, every cell
    masked)."""
    pipe, m = planar_pipeline_scene(mask=mask)

    def refuse(*args, **kwargs):
        raise AssertionError("a full-array grid test on uniform axes")

    with monkeypatch.context() as patch:
        patch.setattr(horizon._terrain, "detect_regular_grid", refuse)
        got, routes = _traced_routes(lambda: pipe.run(mask=m))
    assert routes == {r: int(r == "planar") for r in profiling.ROUTES}
    want = planar_buffer_route(pipe, m)
    assert set(got) == set(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    assert got["elevation"].is_contiguous()


@pytest.mark.parametrize("jitter", ["x", "y"])
def test_uneven_axes_take_the_curved_route(jitter, capsys):
    """One spacing of an axis off by a tenth of a step: ``run`` hands the
    meshgrid's planes to the entry, whose grid test sends them down the
    curved route, with the same outputs as the vertex-buffer route."""
    pipe, m = planar_pipeline_scene(jitter=jitter, mask="patches")
    got, routes = _traced_routes(lambda: pipe.run(mask=m))
    assert routes == {r: int(r == "curved_tilt") for r in profiling.ROUTES}
    want = planar_buffer_route(pipe, m)
    for key in want:
        assert torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("mask", ["none", "patches"])
def test_curved_pipeline_bit_equal_to_buffer_route(mask, capsys):
    """``CurvedPipeline.run`` hands its ENU mesh to the entry as it is:
    every output ``torch.equal`` to the route that packs it into a vertex
    buffer for ``horizon_gridded`` (unmasked, patches)."""
    pipe, m = curved_pipeline_scene(mask=mask)
    got, routes = _traced_routes(lambda: pipe.run(mask=m))
    assert routes == {r: int(r == "curved_tilt") for r in profiling.ROUTES}
    want = curved_buffer_route(pipe, m)
    assert set(got) == set(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key


def _bad_mask_shape():
    pipe, m = planar_pipeline_scene(mask="patches")
    return pipe, m[:-1]


def _bad_mask_dtype():
    pipe, m = planar_pipeline_scene(mask="patches")
    return pipe, m.astype(np.float32)


def _bad_hori_acc():
    return planar_pipeline_scene(hori_acc=11.0)


def _empty_domain():
    """y_min above y_max by one step: an inner block of no rows."""
    pipe, _ = planar_pipeline_scene()
    x, y = pipe.x, pipe.y
    pipe = PlanarPipeline(x, y, pipe.elevation,
                          {"x_min": float(x[20]), "x_max": float(x[60]),
                           "y_min": float(y[39]), "y_max": float(y[40])},
                          dist_search=0.3, azim_num=8, device="cpu")
    assert pipe.slice_in[0] == slice(40, 40)
    return pipe, None


BAD_INPUTS = {"mask_shape": _bad_mask_shape, "mask_dtype": _bad_mask_dtype,
              "hori_acc": _bad_hori_acc, "empty_domain": _empty_domain}


def _refused_as_buffer_route(pipe, m):
    """``pipe.run(mask=m)`` raises what the vertex-buffer route raises on
    the same input, the exception's type and message, before the entry
    takes a route."""
    profiling.reset_counters()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            with pytest.raises(Exception) as got:
                pipe.run(mask=m)
        assert profiling.routes() == dict.fromkeys(profiling.ROUTES, 0)
    finally:
        profiling.reset_counters()
    with pytest.raises(Exception) as want:
        planar_buffer_route(pipe, m)
    assert type(got.value) is type(want.value)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("bad", sorted(BAD_INPUTS))
def test_axes_route_refuses_as_horizon_gridded(bad, capsys):
    """``run`` on uniform axes raises what ``horizon_gridded`` raises on
    the same input: the exception's type and message."""
    _refused_as_buffer_route(*BAD_INPUTS[bad]())


def test_uneven_axes_refuse_a_wrong_elevation_shape(capsys):
    """Uneven axes with heights of another shape than their meshgrid's:
    ``run`` raises the vertex buffer's ``ValueError``, as the reference's
    pipeline does."""
    pipe, _ = planar_pipeline_scene(jitter="x")
    pipe.elevation = pipe.elevation[:-3, :-2]
    _refused_as_buffer_route(pipe, None)


def test_import_loads_no_jax():
    code = ("import sys, horayzon_tpu_torch, horayzon_tpu_torch.ops.fused_sweep, "
            "horayzon_tpu_torch.ops.replay, horayzon_tpu_torch.models.terrain_fit,"
            " horayzon_tpu_torch.regrid, horayzon_tpu_torch.direction, "
            "horayzon_tpu_torch.utils.streaming, "
            "horayzon_tpu_torch.utils.profiling, "
            "horayzon_tpu_torch.utils.output, horayzon_tpu_torch.domain, "
            "horayzon_tpu_torch.load_dem, horayzon_tpu_torch.geoid, "
            "horayzon_tpu_torch.ocean_masking, horayzon_tpu_torch.download, "
            "horayzon_tpu_torch.native.fastdem, "
            "horayzon_tpu_torch.native.bvhbase;"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m.startswith('horayzon_tpu.') or "
            "m == 'horayzon_tpu');"
            "print(bad); sys.exit(1 if bad else 0)")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
