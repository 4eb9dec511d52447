"""The curved cell ``srtm_alps_hz`` at a small size on the CPU: the
program passes, the control (the curved reference in bfloat16 in the
program's place) fails, and so does a run whose timed path is broken
underneath; the new readers give nothing on a trace without their spans
or kernel; the curved reference keeps to a dense march over the lon/lat
DEM that does not planarise.  On the card (``-m cuda``) the cell runs at
its full size through the command."""

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
from hzbench import control, curved_reference, drivers, harness

CELL = "srtm_alps_hz"
#: A small lon/lat domain of the configuration's grid: 240 x 168 inner
#: cells (about 15 km a side, so the ramp of its corners passes the
#: horizon limit), a 1.5 km search, 8 azimuths, every block checked.
DOMAIN = {"lon_min": 7.90, "lon_max": 8.10, "lat_min": 46.43,
          "lat_max": 46.57}
SMALL = {"domain": DOMAIN, "dist_search_km": 1.5, "azim_num": 8,
         "check_blocks": 10 ** 6, "count_blocks": 64,
         "bumps": {"count": 4, "sigma_deg": [0.01, 0.08],
                   "amp_m": [300.0, 2500.0]},
         # domain.curved_grid(DOMAIN, 1.5, "WGS84")
         "outer": {"lon_min": 7.880434107978131,
                   "lon_max": 8.11956589202187,
                   "lat_min": 46.41650588704055,
                   "lat_max": 46.583493749174266}}


def run_small(seed=20261018, trace_on=False):
    return harness.run_cell(CELL, seed, 0.5, trace_on,
                            t_start=time.perf_counter(), device="cpu",
                            config_overrides=SMALL)


def test_outer_domain_is_curved_grids():
    from horayzon_tpu_torch import domain
    got = domain.curved_grid(DOMAIN, SMALL["dist_search_km"], "WGS84")
    assert {k: float(v) for k, v in got.items()} == SMALL["outer"]
    man = harness.Manifest()
    cfg = man.config(man.cell(CELL))
    got = domain.curved_grid(cfg["domain"], cfg["dist_search_km"],
                             cfg["ellps"])
    assert {k: float(v) for k, v in got.items()} == cfg["outer"]


def test_scene_has_the_configurations_shapes():
    man = harness.Manifest()
    cfg = man.config(man.cell(CELL))
    scene = man.scene(cfg["scene"])(cfg, 3, torch.device("cpu"))
    assert tuple(scene["z"].shape) == tuple(cfg["outer_shape"])
    assert tuple(scene["inner_shape"]) == tuple(cfg["inner_shape"])
    assert scene["z"].dtype == torch.float32
    assert float(scene["z"].min()) >= 0.0


@pytest.mark.parametrize("trace_on", [False, True])
def test_program_passes(trace_on):
    res = run_small(trace_on=trace_on)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert res["checks"]["hori_gap_deg"]["value"] == 0.0
    if trace_on:
        for name in ("geometry_ms.curved", "planarize_ms.curved",
                     "lattice_ms.curved"):
            assert res["metrics"][name]["value"] > 0.0, name
        # the CPU runs no kernel: no roofline
        assert "k1_tilt_roofline" not in res["metrics"]
    else:
        assert set(res["metrics"]) == {"horizon_rate", "setup_s"}


def test_control_fails_a_limit():
    prog, ctrl = control.readings(CELL, 20261018, device="cpu",
                                  config_overrides=SMALL)
    man = harness.Manifest()
    limits = man.config(man.cell(CELL))["limits"]
    assert set(ctrl) | {"bad_values"} == set(prog) == set(limits)
    assert all(v <= limits[n] for n, v in prog.items()), prog
    assert any(v > limits[n] for n, v in ctrl.items()), ctrl


def _ramp_zeroed(monkeypatch):
    """The tilt ramps of the lattice box zeroed."""
    from horayzon_tpu_torch import horizon
    orig = horizon.curved_lattice

    def zeroed(*args, **kwargs):
        lat = orig(*args, **kwargs)
        lat["ramp"] = tuple(np.zeros_like(r) for r in lat["ramp"])
        return lat

    monkeypatch.setattr(horizon, "curved_lattice", zeroed)


def _readback_shifted(monkeypatch):
    """The read-back's positions shifted by half a lattice cell."""
    from horayzon_tpu_torch import horizon
    orig = horizon.read_back

    def shifted(hori_r, fi, fj):
        return orig(hori_r, fi + 0.5, fj)

    monkeypatch.setattr(horizon, "read_back", shifted)


def _altered_ratio(monkeypatch):
    """K1's plain version with one azimuth's answers altered."""
    from horayzon_tpu_torch.ops import fused_sweep
    orig = fused_sweep._ratio_plain

    def altered(*args, **kwargs):
        raw = orig(*args, **kwargs)
        raw[1] += 0.05
        return raw

    monkeypatch.setattr(fused_sweep, "_ratio_plain", altered)


@pytest.mark.parametrize("fault", [_ramp_zeroed, _readback_shifted,
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
        for name in ("geometry_ms.curved", "planarize_ms.curved",
                     "lattice_ms.curved", "k1_tilt_roofline"):
            assert man.reader(name)(ctx) is None, name


def test_roofline_reads_the_first_k1_launch():
    """On a trace with K1's kernel, ``k1_tilt_roofline`` is the frozen
    bound on the first call's lattice box over the first launch's time."""
    from hzbench import roofline, trace
    *_, drv = harness.set_up(CELL, 7, device="cpu", config_overrides=SMALL)
    dev = [(trace.K1, "kernel", 0.0, 1000.0),
           (trace.K1, "kernel", 2000.0, 2500.0)]
    ctx = types.SimpleNamespace(
        trace={"window": (0.0, 3000.0), "dev": dev, "ann": [], "calls": 2},
        driver=drv, config=drv.cfg, seed=7)
    got = harness.Manifest().reader("k1_tilt_roofline")(ctx)
    lat = curved_reference.lattice_scene(drv.dem(1)[0])
    bound = roofline.k1_bound(lat, SMALL["count_blocks"], 7)[0]
    assert got == pytest.approx(100.0 * bound / 1e-3) and got > 0.0


# ---------------------------------------------------------------------------
# A witness of the curved reference that does not planarise
# ---------------------------------------------------------------------------

def _geodetic(p, ellps):
    """ECEF points (..., 3) to geodetic lon, lat [degree] (Bowring's
    iteration)."""
    a, _, e_2 = curved_reference.ellipsoid(ellps)
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    lon = torch.atan2(y, x)
    r = torch.hypot(x, y)
    lat = torch.atan2(z, r * (1.0 - e_2))
    for _ in range(6):
        n = a / torch.sqrt(1.0 - e_2 * torch.sin(lat) ** 2)
        h = r / torch.cos(lat) - n
        lat = torch.atan2(z, r * (1.0 - e_2 * n / (n + h)))
    return torch.rad2deg(lon), torch.rad2deg(lat)


def _ecef(lon, lat, h, ellps):
    a, b, e_2 = curved_reference.ellipsoid(ellps)
    lon_r, lat_r = torch.deg2rad(lon), torch.deg2rad(lat)
    n = a / torch.sqrt(1.0 - e_2 * torch.sin(lat_r) ** 2)
    return torch.stack([(n + h) * torch.cos(lat_r) * torch.cos(lon_r),
                        (n + h) * torch.cos(lat_r) * torch.sin(lon_r),
                        (b ** 2 / a ** 2 * n + h) * torch.sin(lat_r)], -1)


def dense_march(scene, cells, step_frac=0.25):
    """(N, A) horizon [radian] at ``cells`` in float64: from each cell,
    along the horizontal direction of its local frame (normal, north) in
    ECEF every ``step_frac`` of a cell out to the search distance, the
    terrain under each point (its geodetic lon/lat, the DEM bilinear on
    its own lon/lat grid) and the largest elevation angle of those
    terrain points in that frame."""
    ellps = scene["ellps"]
    lon = torch.as_tensor(scene["lon"], dtype=torch.float64)
    lat = torch.as_tensor(scene["lat"], dtype=torch.float64)
    z = scene["z"].double()
    d_lon, d_lat = float(lon[1] - lon[0]), float(lat[0] - lat[1])
    lon0, lat0 = lon[cells.cols], lat[cells.rows]
    p0 = _ecef(lon0, lat0, z[cells.rows, cells.cols]
               + curved_reference.ref.HORIZON_RAY_LIFT, ellps)
    up = torch.stack([torch.cos(torch.deg2rad(lat0))
                      * torch.cos(torch.deg2rad(lon0)),
                      torch.cos(torch.deg2rad(lat0))
                      * torch.sin(torch.deg2rad(lon0)),
                      torch.sin(torch.deg2rad(lat0))], -1)
    _, b, _ = curved_reference.ellipsoid(ellps)
    pole = torch.tensor([0.0, 0.0, b], dtype=torch.float64) - p0
    north = pole - (pole * up).sum(-1, keepdim=True) * up
    north = north / torch.linalg.vector_norm(north, dim=-1, keepdim=True)
    east = torch.linalg.cross(north, up)
    cell_m = math.radians(d_lon) * 6371000.0 * math.cos(
        math.radians(float(lat0.mean())))
    step = cell_m * step_frac
    s = torch.arange(step, scene["dist_search_m"] + step / 2, step,
                     dtype=torch.float64)
    a_num = scene["azim_num"]
    out = torch.empty((cells.n, a_num), dtype=torch.float64)
    for k in range(a_num):
        az = 2.0 * math.pi / a_num * k
        d = math.sin(az) * east + math.cos(az) * north
        pts = p0[:, None, :] + s[None, :, None] * d[:, None, :]
        lon_p, lat_p = _geodetic(pts, ellps)
        fj = (lon_p - float(lon[0])) / d_lon
        fi = (float(lat[0]) - lat_p) / d_lat
        ground = _ecef(lon_p, lat_p, curved_reference.bilinear(z, fi, fj),
                       ellps)
        v = ground - p0[:, None, :]
        rise = (v * up[:, None, :]).sum(-1)
        run = torch.linalg.vector_norm(v - rise[..., None]
                                       * up[:, None, :], dim=-1)
        out[:, k] = torch.atan2(rise, run).amax(1)
    lo = math.radians(scene["elev_ang_low_lim"])
    hi = math.radians(curved_reference.ref.ELEV_ANG_UP_LIM)
    return out.clamp(lo, hi)


def witness_gaps(dems=(0, 1, 2), seed=11, n_blocks=6):
    """Per DEM the widest gap [degree] of the reference's horizon and of
    the bfloat16 control's to the dense march, at ``n_blocks`` sampled
    blocks."""
    man = harness.Manifest()
    cfg = dict(man.config(man.cell(CELL)), **SMALL)
    make = man.scene(cfg["scene"])
    out = []
    for dem in dems:
        scene = make(cfg, seed, torch.device("cpu"), dem=dem)
        cells = drivers._check_cells(scene, n_blocks, seed, "cpu", None,
                                     dem)
        march = dense_march(scene, cells)
        lat = curved_reference.lattice(scene)
        row = []
        for dtype in (torch.float32, torch.bfloat16):
            got = curved_reference.horizon_reference(
                scene, cells, dtype, lat=lat)["hori"].double()
            row.append(math.degrees(float((got - march).abs().max())))
        out.append(row)
    return out


def test_reference_keeps_to_a_dense_march():
    gaps = witness_gaps()
    widest = max(g[0] for g in gaps)
    assert widest < 2.0 * 0.25, gaps
    # the reference is not the march: it takes its own samples
    assert widest > 0.0
    # the control does not keep to it
    assert min(g[1] for g in gaps) > 2.0 * 0.25, gaps


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("trace_on", [0, 1])
def test_curved_cell_runs_correct_on_the_card(card, trace_on):
    out = subprocess.run([sys.executable, "hzbench/run.py", "--workload",
                          CELL, "--seed", str(2 ** 31 + 7), "--seconds", "2",
                          "--trace", str(trace_on)], cwd=ROOT, text=True,
                         capture_output=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu", res
    if trace_on:
        got = res["metrics"]
        for name in ("geometry_ms.curved", "planarize_ms.curved",
                     "lattice_ms.curved"):
            assert got[name]["value"] > 0.0, name
        assert 0.0 < got["k1_tilt_roofline"]["value"] <= 105.0


@pytest.mark.cuda
def test_curved_control_fails_on_the_card(card):
    prog, ctrl = control.readings(CELL, 99)
    man = harness.Manifest()
    limits = man.config(man.cell(CELL))["limits"]
    assert all(v <= limits[n] for n, v in prog.items()), prog
    assert any(v > limits[n] for n, v in ctrl.items()), ctrl
