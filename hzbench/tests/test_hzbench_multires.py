"""The 2 m multires cell ``swissalti_2m_hz`` at a small size on the CPU: the
program passes, the control (the multires reference in bfloat16 in the
program's place) fails every limit, and a run whose timed path is broken
underneath is not correct, the far field left out among them; each call
builds its pipeline on a terrain and a TIN of its own; the new readers give
nothing on a trace without their spans or kernel; the multires reference
keeps to a dense march over the fine grid's bilinear heights and the TIN's
barycentric surface beyond the fine grid on smooth terrain, and on the
cell's own terrain parts from it near the cell by what the sweep's
samples miss, a few metres of height.  On the card (``-m cuda``) the cell
runs at its full size through the command."""

import itertools
import json
import math
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

from conftest import ROOT
from hzbench import control, drivers, harness
from hzbench import multires_reference as mref
from hzbench import reference as ref

CELL = "swissalti_2m_hz"
#: The configuration's 2 m grid and terrain model at a small size: 64^2
#: inner cells in a 256-cell fine halo, a 2 km search at hori_acc 1
#: degree (so the ratio rule picks 8 and four of the seven levels come
#: from the far field), 8 azimuths, a TIN at 384 m, every block checked.
SMALL = {"inner_cells": 64, "halo_cells": 256, "dist_search_km": 2.0,
         "hori_acc": 1.0, "azim_num": 8, "check_blocks": 10 ** 6,
         "count_blocks": 16, "tin": {"spacing_m": 384.0, "margin_km": 2.0},
         "bumps": {"count": 4, "coarse_ratio": 16, "sigma_min_cells": 10.0,
                   "sigma_max_divisor": 6.0, "amp_m": [200.0, 2000.0],
                   "noise_m": 3.0}}


def run_small(seed=20261018, trace_on=False):
    return harness.run_cell(CELL, seed, 0.5, trace_on,
                            t_start=time.perf_counter(), device="cpu",
                            config_overrides=SMALL)


def _make(over=SMALL):
    man = harness.Manifest()
    cfg = dict(man.config(man.cell(CELL)), **over)
    return cfg, man.scene(cfg["scene"])


def test_scene_is_made_from_the_seed_and_the_dem():
    cfg, make = _make()
    a = make(cfg, 5, torch.device("cpu"), dem=2)
    b = make(cfg, 5, torch.device("cpu"), dem=2)
    c = make(cfg, 5, torch.device("cpu"), dem=3)
    for key in ("z", "vert_simp", "tri_ind_simp"):
        assert torch.equal(a[key], b[key]), key
    assert not torch.equal(a["z"], c["z"])
    assert not torch.equal(a["vert_simp"], c["vert_simp"])
    # the TIN reaches the search distance beyond the fine grid
    v = a["vert_simp"].view(-1, 3).double()
    assert float(v[:, 0].min()) <= float(a["x"][0]) - 2000.0
    assert float(v[:, 0].max()) >= float(a["x"][-1]) + 2000.0


@pytest.mark.parametrize("trace_on", [False, True])
def test_program_passes(trace_on):
    res = run_small(trace_on=trace_on)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert all(res["checks"][n]["value"] == 0.0
               for n in ("hori_gap_deg", "svf_gap", "slope_gap_deg",
                         "aspect_gap_deg"))
    if trace_on:
        for name in ("tin_ms.mr", "pyramid_ms.mr", "grid_ms.hz",
                     "check_ms.hz"):
            assert res["metrics"][name]["value"] > 0.0, name
        assert "device_idle_pct.hz" in res["metrics"]
        # the CPU runs no kernel and counts none of its samples
        for name in ("k1_multires_roofline", "k1_ms", "k1_taken_pct"):
            assert name not in res["metrics"], name
    else:
        assert set(res["metrics"]) == {"horizon_rate", "setup_s"}


def test_each_call_builds_a_pipeline_with_a_tin_of_its_own(monkeypatch):
    from horayzon_tpu_torch import models
    built = []
    init = models.PlanarPipeline.__init__

    def counting_init(self, x, y, elevation, *args, **kwargs):
        built.append((np.array(elevation), np.array(kwargs["vert_simp"])))
        init(self, x, y, elevation, *args, **kwargs)

    monkeypatch.setattr(models.PlanarPipeline, "__init__", counting_init)
    *_, drv = harness.set_up(CELL, 20261018, device="cpu",
                             config_overrides=SMALL)
    drv.warm()
    for k in range(2):
        drv.call(k, drv.prepare(k))
    assert len(built) == 3 and [d for d, _ in drv.samples] == [1, 2]
    for (za, va), (zb, vb) in itertools.combinations(built, 2):
        assert not np.array_equal(za, zb) and not np.array_equal(va, vb)
    assert drv.check()["hori_gap_deg"] == 0.0


def test_control_fails_every_limit():
    prog, ctrl = control.readings(CELL, 20261018, device="cpu",
                                  config_overrides=SMALL)
    man = harness.Manifest()
    limits = man.config(man.cell(CELL))["limits"]
    assert set(ctrl) | {"bad_values"} == set(prog) == set(limits)
    assert all(v <= limits[n] for n, v in prog.items()), prog
    assert all(v > limits[n] for n, v in ctrl.items()), ctrl


def _tin_dropped(monkeypatch):
    """The far field left out: the pipeline built without its TIN."""
    from horayzon_tpu_torch import models
    init = models.PlanarPipeline.__init__

    def dropped(self, *args, **kwargs):
        kwargs.update(vert_simp=None, tri_ind_simp=None)
        init(self, *args, **kwargs)

    monkeypatch.setattr(models.PlanarPipeline, "__init__", dropped)


def _far_field_shifted(monkeypatch):
    """The coarse far field moved by one coarse cell."""
    from horayzon_tpu_torch.ops import multires
    orig = multires.coarse_grid_from_tin

    def shifted(*args, **kwargs):
        z_coarse, offset = orig(*args, **kwargs)
        return np.roll(z_coarse, 1, axis=1), offset

    monkeypatch.setattr(multires, "coarse_grid_from_tin", shifted)


def _altered_ratio(monkeypatch):
    """K1's plain version with one azimuth's answers altered."""
    from horayzon_tpu_torch.ops import fused_sweep
    orig = fused_sweep._ratio_plain

    def altered(*args, **kwargs):
        raw = orig(*args, **kwargs)
        raw[1] += 0.05
        return raw

    monkeypatch.setattr(fused_sweep, "_ratio_plain", altered)


@pytest.mark.parametrize("fault", [_tin_dropped, _far_field_shifted,
                                   _altered_ratio])
def test_broken_timed_path_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    res = run_small()
    assert not res["correct"], res["checks"]
    assert res["checks"]["hori_gap_deg"]["value"] > 0.05
    assert all(np.isfinite(c["value"]) for c in res["checks"].values())


def test_readers_give_nothing_without_their_spans_or_kernel():
    man = harness.Manifest()
    ann = [("hzb.call", 0.0, 100.0), ("hzt.pipeline.run", 1.0, 90.0)]
    dev = [("other_kernel", "kernel", 5.0, 25.0)]
    for trace in (None, {"window": (0.0, 1000.0), "dev": dev, "ann": ann,
                         "calls": 1}):
        ctx = types.SimpleNamespace(trace=trace, driver=None, config={},
                                    seed=1)
        for name in ("tin_ms.mr", "pyramid_ms.mr", "k1_multires_roofline"):
            assert man.reader(name)(ctx) is None, name


def test_span_readers_sum_their_spans_per_call():
    man = harness.Manifest()
    ann = [("hzb.call", 0.0, 100.0), ("hzb.call", 200.0, 300.0),
           ("hzt.tin.raster", 1.0, 41.0), ("hzt.tin.raster", 201.0, 261.0),
           ("hzt.tin.upload", 42.0, 44.0), ("hzt.tin.pyramid", 44.0, 50.0),
           ("hzt.tin.upload", 262.0, 266.0),
           ("hzt.tin.pyramid", 266.0, 270.0)]
    ctx = types.SimpleNamespace(trace={"window": (0.0, 300.0), "dev": [],
                                       "ann": ann, "calls": 2})
    assert man.reader("tin_ms.mr")(ctx) == pytest.approx(0.05)
    assert man.reader("pyramid_ms.mr")(ctx) == pytest.approx(0.008)


def test_roofline_reads_the_first_k1_launch():
    """On a trace with K1's kernel, ``k1_multires_roofline`` is the frozen
    bound on the first call's combined pyramid over the first launch's
    time."""
    from hzbench import trace
    *_, drv = harness.set_up(CELL, 7, device="cpu", config_overrides=SMALL)
    dev = [(trace.K1, "kernel", 0.0, 1000.0),
           (trace.K1, "kernel", 2000.0, 2500.0)]
    ctx = types.SimpleNamespace(
        trace={"window": (0.0, 3000.0), "dev": dev, "ann": [], "calls": 2},
        driver=drv, config=drv.cfg, seed=7)
    got = harness.Manifest().reader("k1_multires_roofline")(ctx)
    bound = mref.k1_bound(drv.dem(1)[0], SMALL["count_blocks"], 7)[0]
    assert got == pytest.approx(100.0 * bound / 1e-3) and got > 0.0


# ---------------------------------------------------------------------------
# A witness of the multires reference
# ---------------------------------------------------------------------------

#: The witness's smooth scene: the configuration's shapes at a small size
#: and hori_acc 0.25 (the ratio rule picks 4, ratio_log2 2: levels 2 and 3
#: from the far field), its bumps (sigma from 320 m) evaluated on every
#: 2 m cell with no noise and amplitudes 200-1000 m, a TIN at 128 m.
WITNESS = dict(SMALL, halo_cells=512, hori_acc=0.25,
               tin={"spacing_m": 128.0, "margin_km": 2.0},
               bumps={"count": 4, "coarse_ratio": 1, "sigma_min_cells": 160.0,
                      "sigma_max_divisor": 6.0, "amp_m": [200.0, 1000.0],
                      "noise_m": 0.0})
#: The same scene on the cell's own terrain model (``SMALL``'s bumps: 32 m
#: plateaus, amplitudes to 2000 m, 3 m of noise on every 2 m cell).
WITNESS_OWN = dict(WITNESS, bumps=SMALL["bumps"])


def dense_march(scene, cells, s=None):
    """At ``cells`` in float64: the (N, A) horizon [radian] and the
    distance [m] of its steepest point.  From each cell at the distances
    ``s`` (default: every quarter of a cell) out to the search distance,
    the fine grid's bilinear height where the fine grid holds the point,
    else the TIN's (the barycentric interpolation in its triangle of the
    regular TIN), and the largest elevation angle of those terrain
    points."""
    z = scene["z"].double()
    h, w = z.shape
    x = torch.as_tensor(scene["x"], dtype=torch.float64)
    y = torch.as_tensor(scene["y"], dtype=torch.float64)
    dx, ady = float(x[1] - x[0]), float(y[0] - y[1])
    v = scene["vert_simp"].double().view(-1, 3)
    nv = int(round(math.sqrt(v.shape[0])))
    vx0, vy0 = float(v[0, 0]), float(v[0, 1])
    spacing = float(v[1, 0] - v[0, 0])
    vz = v[:, 2].view(nv, nv)
    xc, yc = x[cells.cols], y[cells.rows]
    z_org = z[cells.rows, cells.cols] + ref.HORIZON_RAY_LIFT
    if s is None:
        s = torch.arange(dx / 4, scene["dist_search_m"] + dx / 8, dx / 4,
                         dtype=torch.float64)
    a_num = scene["azim_num"]
    out = torch.empty((cells.n, a_num), dtype=torch.float64)
    at = torch.empty_like(out)
    for k in range(a_num):
        az = 2.0 * math.pi / a_num * k
        px = xc[:, None] + s[None, :] * math.sin(az)
        py = yc[:, None] + s[None, :] * math.cos(az)
        fj = (px - float(x[0])) / dx
        fi = (float(y[0]) - py) / ady
        fine = (fi >= 0) & (fi <= h - 1) & (fj >= 0) & (fj <= w - 1)
        i0 = fi.floor().clamp(0, h - 2).long()
        j0 = fj.floor().clamp(0, w - 2).long()
        wi, wj = (fi - i0).clamp(0, 1), (fj - j0).clamp(0, 1)
        hb = ((1 - wi) * (1 - wj) * z[i0, j0] + (1 - wi) * wj * z[i0, j0 + 1]
              + wi * (1 - wj) * z[i0 + 1, j0] + wi * wj * z[i0 + 1, j0 + 1])
        u, t = (px - vx0) / spacing, (vy0 - py) / spacing
        qj = u.floor().clamp(0, nv - 2).long()
        qi = t.floor().clamp(0, nv - 2).long()
        u, t = u - qj, t - qi
        z00, z01 = vz[qi, qj], vz[qi, qj + 1]
        z10, z11 = vz[qi + 1, qj], vz[qi + 1, qj + 1]
        # triangles (a, a + 1, a + nv) and (a + 1, a + nv + 1, a + nv)
        ht = torch.where(u + t <= 1.0, z00 * (1 - u - t) + z01 * u + z10 * t,
                         z11 * (u + t - 1) + z01 * (1 - t) + z10 * (1 - u))
        hh = torch.where(fine, hb, ht)
        angle, k_max = torch.atan2(hh - z_org[:, None], s[None, :]).max(1)
        out[:, k], at[:, k] = angle, s[k_max]
    lo = math.radians(scene["elev_ang_low_lim"])
    hi = math.radians(ref.ELEV_ANG_UP_LIM)
    return out.clamp(lo, hi), at


def witness(over, s_fn=None, dems=(0, 1, 2), seed=11, n_blocks=6):
    """Per DEM of the scene ``over``: the far field's ratio, the reference's
    horizon, the bfloat16 control's, the dense march's (at the distances
    ``s_fn(scene)``) and the distance of the march's steepest point, at
    ``n_blocks`` sampled blocks; and the scene."""
    cfg, make = _make(over)
    for dem in dems:
        scene = make(cfg, seed, torch.device("cpu"), dem=dem)
        cells = drivers._check_cells(scene, n_blocks, seed, "cpu", None,
                                     dem)
        march, at = dense_march(scene, cells,
                                None if s_fn is None else s_fn(scene))
        far = mref.far_field(scene)
        got, ctrl = (mref.horizon_reference(scene, cells, dtype,
                                            far=far)["hori"].double()
                     for dtype in (torch.float32, torch.bfloat16))
        yield far["ratio_log2"], got, ctrl, march, at, scene


def test_reference_keeps_to_a_dense_march():
    gaps = [(rl, math.degrees(float((got - march).abs().max())),
             math.degrees(float((ctrl - march).abs().max())))
            for rl, got, ctrl, march, _, _ in witness(WITNESS)]
    assert all(g[0] == 2 for g in gaps), gaps
    widest = max(g[1] for g in gaps)
    assert widest < 2.0 * WITNESS["hori_acc"], gaps
    # the reference is not the march: it takes its own samples
    assert widest > 0.0
    # the control does not keep to it
    assert min(g[2] for g in gaps) > 2.0 * WITNESS["hori_acc"], gaps


def _own_distances(scene):
    """Every 1/32 of a cell out to 32 cells, then every quarter cell: fine
    enough near the cell to find the bilinear surface's peaks at the
    grid's nodes and edges."""
    d = abs(scene["dx"])
    return torch.cat([
        torch.arange(d / 32, 32 * d, d / 32, dtype=torch.float64),
        torch.arange(32 * d, scene["dist_search_m"] + d / 8, d / 4,
                     dtype=torch.float64)])


def test_reference_on_the_cells_own_terrain():
    """On the cell's own terrain the reference (and so the program, which
    reads 0.0 against it) parts from the march near the cell, by 15.5,
    26.5 and 22.2 degree on DEMs 0-2: the sweep samples a ray once a cell
    length and fits a parabola through three samples, and misses the
    bilinear surface's peaks at the nodes and edges that the ray crosses
    between them, which the 3 m noise and the plateaus' steps make
    steep.  What it misses is a height at most a few metres (4.31, 6.17,
    4.98 m): held under three times the noise.  Beyond the dense samples
    (the max-mip levels and the far field) the reference reads above the
    march by up to 0.76, 2.52 and 0.51 degree (the max-mip's conservative
    bias over the noise and the steps) and never more than twice
    ``hori_acc`` below it (0.073, 0.115, 0.001)."""
    for _, got, _, march, at, scene in witness(WITNESS_OWN, _own_distances):
        plan = ref.horizon_plan(scene)
        dense_m = plan["n_dense"] * plan["step"]
        missed = float(((march.tan() - got.tan()) * at).max())
        assert missed < 3.0 * WITNESS_OWN["bumps"]["noise_m"], missed
        below = math.degrees(float((march - got)[at > dense_m].max()))
        assert below < 2.0 * WITNESS_OWN["hori_acc"], below


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("trace_on", [0, 1])
def test_multires_cell_runs_correct_on_the_card(card, trace_on):
    out = subprocess.run([sys.executable, "hzbench/run.py", "--workload",
                          CELL, "--seed", str(2 ** 31 + 7), "--seconds", "2",
                          "--trace", str(trace_on)], cwd=ROOT, text=True,
                         capture_output=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu", res
    if trace_on:
        got = res["metrics"]
        for name in ("tin_ms.mr", "pyramid_ms.mr", "device_idle_pct.hz",
                     "k1_ms", "k1_taken_pct", "grid_ms.hz", "check_ms.hz"):
            assert got[name]["value"] > 0.0, name
        assert 0.0 < got["k1_multires_roofline"]["value"] <= 105.0


@pytest.mark.cuda
def test_multires_control_fails_on_the_card(card):
    prog, ctrl = control.readings(CELL, 99)
    man = harness.Manifest()
    limits = man.config(man.cell(CELL))["limits"]
    assert all(v <= limits[n] for n, v in prog.items()), prog
    assert any(v > limits[n] for n, v in ctrl.items()), ctrl
