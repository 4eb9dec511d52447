"""``PlanarPipeline`` with a simplified outer TIN as the far field (the
upstream 2 m example's far field), on the CPU where the plain sweep stands
in for K1, on small scenes of the benchmark's 2 m multires generator
(``hzbench/scene/swissalti_2m_like.py``: 64^2 inner cells at 2 m, a
256-cell fine halo, a 2 km search at ``hori_acc`` 1 degree, 8 azimuths,
a TIN of 392 triangles at 384 m):

* the pipeline with the TIN equals ``horizon_gridded`` on the fine grid's
  vertex buffer with the same TIN plus the topographic parameters, bit for
  bit, and counts the route ``tin`` once;
* without a TIN its outputs and route are those of the entry on the grid
  alone (``planar``); a TIN on uneven axes is refused;
* against the benchmark's plain multires reference
  (``hzbench/multires_reference.py``) at seeded cells on three seeds:
  the same values, and the reference's coarse far field equal to
  ``multires.coarse_grid_from_tin``'s bit for bit;
* a traced run records ``hzt.tin.raster``, ``.upload`` and ``.pyramid``
  under ``hzt.pipeline.run`` and counts the TIN's triangles
  (``profiling.tin()``).

On the card (``-m cuda``): K1 on the pipeline's TIN route against the
plain sweep over the same pyramid on the card, bit for bit."""

import math
import os
import sys

import numpy as np
import pytest
import torch

from horayzon_tpu_torch import auxiliary, horizon, models, terrain, topo_param
from horayzon_tpu_torch.ops import fused_sweep, multires
from horayzon_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from hzbench import drivers, harness  # noqa: E402
from hzbench import multires_reference as mref  # noqa: E402

CELL = "swissalti_2m_hz"
SMALL = {"inner_cells": 64, "halo_cells": 256, "dist_search_km": 2.0,
         "azim_num": 8, "hori_acc": 1.0,
         "tin": {"spacing_m": 384.0, "margin_km": 2.0},
         "bumps": {"count": 4, "coarse_ratio": 16, "sigma_min_cells": 10.0,
                   "sigma_max_divisor": 6.0, "amp_m": [200.0, 2000.0],
                   "noise_m": 3.0}}
OUTPUTS = ("hori", "azim", "svf", "slope", "aspect", "vec_tilt",
           "elevation", "x", "y")


def small_scene(seed=11, dem=1, **more):
    man = harness.Manifest()
    cfg = dict(man.config(man.cell(CELL)), **SMALL, **more)
    return man.scene(cfg["scene"])(cfg, seed, torch.device("cpu"), dem=dem)


def _tin(scene):
    return dict(vert_simp=scene["vert_simp"].numpy(),
                tri_ind_simp=scene["tri_ind_simp"].numpy())


def _pipe(scene, tin=True, x=None):
    return models.PlanarPipeline(
        scene["x"] if x is None else x, scene["y"], scene["z"].numpy(),
        scene["domain"], scene["dist_search_km"],
        azim_num=scene["azim_num"], hori_acc=scene["hori_acc"],
        device="cpu", **(_tin(scene) if tin else {}))


def _traced(fn):
    """(fn's value, its hzt.* spans in start order, routes, tin counts)."""
    profiling.reset_counters()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            out = fn()
        routes, tin = profiling.routes(), profiling.tin()
    finally:
        profiling.reset_counters()
    spans = sorted(((e.name, e.time_range.start, e.time_range.end)
                    for e in prof.events() if e.name.startswith("hzt.")),
                   key=lambda s: (s[1], -s[2]))
    return out, spans, routes, tin


def test_scene_is_the_configurations():
    sc = small_scene()
    n = 64 + 2 * 256
    assert tuple(sc["z"].shape) == (n, n) and sc["z"].dtype == torch.float32
    assert sc["offset"] == (256, 256) and sc["inner_shape"] == (64, 64)
    assert len(sc["tri_ind_simp"]) // 3 == 2 * 14 ** 2
    assert sc["vert_simp"].dtype == torch.float32
    pipe = _pipe(sc)
    assert (pipe.offset_0, pipe.offset_1) == (256, 256)
    assert [s.stop - s.start for s in pipe.slice_in] == [64, 64]
    # the configuration: 5120^2 fine cells, 198^2 vertices, 77,618
    # triangles
    man = harness.Manifest()
    cfg = man.config(man.cell(CELL))
    n_fine = cfg["inner_cells"] + 2 * cfg["halo_cells"]
    assert [n_fine] * 2 == cfg["outer_shape"]
    nv = math.ceil((n_fine * cfg["dx"] + 2e3 * cfg["tin"]["margin_km"])
                   / cfg["tin"]["spacing_m"]) + 1
    assert (nv, 2 * (nv - 1) ** 2) == (198, 77618)


def test_pipeline_tin_equals_vertex_buffer_route():
    sc = small_scene()
    got, spans, routes, _ = _traced(lambda: _pipe(sc).run())
    assert routes == {r: int(r == "tin") for r in profiling.ROUTES}
    z = sc["z"].numpy()
    xx, yy = np.meshgrid(sc["x"], sc["y"])
    vert = auxiliary.rearrange_pad_buffer(xx, yy, z)
    (o0, o1), (in0, in1) = sc["offset"], sc["inner_shape"]
    vec_norm = np.zeros((in0, in1, 3), np.float32)
    vec_norm[..., 2] = 1.0
    vec_north = np.zeros((in0, in1, 3), np.float32)
    vec_north[..., 1] = 1.0
    tin = _tin(sc)
    hori, azim = horizon.horizon_gridded(
        vert, z.shape[0], z.shape[1], vec_norm, vec_north, o0, o1,
        sc["dist_search_km"], azim_num=sc["azim_num"],
        hori_acc=sc["hori_acc"], vert_simp=tin["vert_simp"],
        num_vert_simp=len(tin["vert_simp"]) // 3,
        tri_ind_simp=tin["tri_ind_simp"],
        num_tri_simp=len(tin["tri_ind_simp"]) // 3, verbose=False,
        device="cpu")
    sl = (slice(o0 - 1, o0 + in0 + 1), slice(o1 - 1, o1 + in1 + 1))
    vec_tilt = topo_param.slope_plane_meth(
        *(torch.from_numpy(np.ascontiguousarray(a[sl]))
          for a in (xx, yy, z)))[1:-1, 1:-1]
    svf = topo_param.sky_view_factor(azim, hori, vec_tilt)
    slope, aspect = topo_param.slope_angle_aspect(vec_tilt)
    want = {"hori": hori, "azim": azim, "svf": svf, "slope": slope,
            "aspect": aspect, "vec_tilt": vec_tilt}
    for name, v in want.items():
        assert torch.equal(got[name], v), name
    assert set(got) == set(OUTPUTS)


def test_pipeline_without_tin_is_the_grid_route():
    sc = small_scene()
    pipe = _pipe(sc, tin=False)
    assert pipe.vert_simp is None and pipe.tri_ind_simp is None
    got, _, routes, tin = _traced(pipe.run)
    assert routes == {r: int(r == "planar") for r in profiling.ROUTES}
    assert tin == {"triangles": 0}
    (o0, o1), (in0, in1) = sc["offset"], sc["inner_shape"]
    hori, azim = horizon.gridded_planes(
        None, None, sc["z"].numpy(), None, None, (o0, o1), (in0, in1),
        sc["dist_search_km"], azim_num=sc["azim_num"],
        hori_acc=sc["hori_acc"], elev_ang_low_lim=-15.0, verbose=False,
        grid=terrain.axes_grid(sc["x"], sc["y"]), device="cpu")
    assert torch.equal(got["hori"], hori) and torch.equal(got["azim"], azim)
    # the far field moves the horizon: the TIN run differs
    assert not torch.equal(_pipe(sc).run()["hori"], hori)


def test_pipeline_refuses_a_tin_on_uneven_axes():
    sc = small_scene()
    x = sc["x"].astype(np.float64)
    x[300:] += 1.0
    with pytest.raises(ValueError, match="planar regular grids"):
        _pipe(sc, x=x.astype(np.float32)).run()


@pytest.mark.parametrize("seed", [7, 2 ** 31 + 5, 4200000017])
def test_program_matches_the_multires_reference(seed):
    sc = small_scene(seed=seed)
    man = harness.Manifest()
    limits = man.config(man.cell(CELL))["limits"]
    out = _pipe(sc).run()
    cells = drivers._check_cells(sc, 6, seed, "cpu", None, 1)
    r = mref.horizon_reference(sc, cells)
    ii, jj = cells.ii, cells.jj
    w = cells.weight > 0
    gaps = {
        "hori_gap_deg": (out["hori"][ii, jj] - r["hori"]).abs().amax(1),
        "svf_gap": (out["svf"][ii, jj] - r["svf"]).abs(),
        "slope_gap_deg": (out["slope"][ii, jj] - r["slope"]).abs(),
        "aspect_gap_deg": (out["aspect"][ii, jj] - r["aspect"]).abs()}
    for name, g in gaps.items():
        v = float(g[w].max())
        v = math.degrees(v) if name.endswith("_deg") else v
        assert v <= limits[name] and v == 0.0, (name, v)
    # the reference's far field is the program's, bit for bit
    far = mref.far_field(sc)
    grid = terrain.axes_grid(sc["x"], sc["y"])
    tin = _tin(sc)
    ratio = horizon.tin_ratio_log2(
        grid, sc["z"].shape, tin["vert_simp"], len(tin["vert_simp"]) // 3,
        tin["tri_ind_simp"], len(tin["tri_ind_simp"]) // 3,
        offset=sc["offset"], inner_shape=sc["inner_shape"],
        dist_search=sc["dist_search_m"], hori_acc=sc["hori_acc"])
    z_coarse, offset = multires.coarse_grid_from_tin(
        tin["vert_simp"], tin["tri_ind_simp"], grid=grid,
        fine_shape=sc["z"].shape, z_fine=sc["z"].numpy(), ratio_log2=ratio,
        dist_search=sc["dist_search_m"])
    assert (far["ratio_log2"], far["coarse_offset"]) == (ratio, offset)
    assert ratio == 3
    assert np.array_equal(far["z_coarse"].numpy(), z_coarse)


def test_traced_run_records_the_tin_spans_and_counts():
    sc = small_scene()
    plain = _pipe(sc).run()
    got, spans, routes, tin = _traced(lambda: _pipe(sc).run())
    for key in plain:
        assert torch.equal(plain[key], got[key]), key
    names = [s[0] for s in spans]
    tin_spans = ["hzt.tin.raster", "hzt.tin.upload", "hzt.tin.pyramid"]
    assert [n for n in names if n.startswith("hzt.tin.")] == tin_spans
    run = next(s for s in spans if s[0] == "hzt.pipeline.run")
    sweep = next(s for s in spans if s[0] == "hzt.sweep.k1")
    mine = [next(s for s in spans if s[0] == n) for n in tin_spans]
    assert all(run[1] <= s[1] and s[2] <= run[2] for s in mine)
    assert all(a[2] <= b[1] for a, b in zip(mine, mine[1:] + [sweep]))
    assert tin == {"triangles": 392}
    assert routes["tin"] == 1
    profiling.reset_counters()
    assert profiling.tin() == {"triangles": 0}


def test_untraced_tin_run_counts_nothing():
    profiling.reset_counters()
    _pipe(small_scene()).run()
    assert profiling.tin() == {"triangles": 0}
    assert profiling.routes() == dict.fromkeys(profiling.ROUTES, 0)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run -m cuda on a machine with "
                    "the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_k1_on_the_tin_route_matches_the_plain_sweep(cuda):
    sc = small_scene(seed=2 ** 31 + 9)
    pipe = models.PlanarPipeline(
        sc["x"], sc["y"], sc["z"].numpy(), sc["domain"],
        sc["dist_search_km"], azim_num=sc["azim_num"],
        hori_acc=sc["hori_acc"], device=cuda, **_tin(sc))
    n0 = fused_sweep.KERNEL_LAUNCHES
    got = pipe.run()["hori"]
    assert fused_sweep.KERNEL_LAUNCHES == n0 + 1
    far = mref.far_field(sc)
    grid = terrain.axes_grid(sc["x"], sc["y"])
    z_c, c_off = multires.coarse_grid_from_tin(
        sc["vert_simp"].numpy(), sc["tri_ind_simp"].numpy(), grid=grid,
        fine_shape=sc["z"].shape, z_fine=sc["z"].numpy(),
        ratio_log2=far["ratio_log2"], dist_search=sc["dist_search_m"])
    geo = dict(dx=grid.dx, dy=grid.dy, offset=sc["offset"],
               inner_shape=sc["inner_shape"],
               dist_search=sc["dist_search_m"], hori_acc=sc["hori_acc"])
    zf = sc["z"].to(cuda)
    levels = multires.multires_levels(
        zf, torch.from_numpy(z_c).to(cuda), ratio_log2=far["ratio_log2"],
        coarse_offset=c_off, **geo)
    want = fused_sweep.horizon_sweep_plain(zf, azim_num=sc["azim_num"],
                                           pyramid=levels, **geo)
    torch.cuda.synchronize()
    assert got.is_cuda and torch.equal(got, want)
