"""The port's streaming runners, profiling and output
(``horayzon_tpu_torch.utils``) on the CPU against the JAX package's
``horayzon_tpu.utils`` and the kernels' oracles.

* ``TiledHorizonRunner``, XLA route (azimuths that are not the fused
  route's ``2*pi*k/A``): the JAX runner on ``tests/test_utils.py``'s scene
  is the oracle.  Each tile's raw ratios (``horizon_core`` with
  ``apply_arctan=False`` at the tile's offset, the runner's tile being
  their clipped arctan bit for bit) are held at :data:`ULPS` float32 ulp
  (measured: 0), the assembled angles within :data:`ANGLE_TOL` rad (the
  two sides' float32 arctan may differ by an ulp).
* ``TiledHorizonRunner``, fused route: each tile within :data:`TOL` rad of
  interpret-mode ``horizon_sweep_pallas`` on that tile, evaluated as
  written (``test_torch_fused_sweep.AS_WRITTEN_XLA_FLAGS``).  The XLA
  engine is not the fused route's oracle (d1 pairs against trailing
  windows, ``tests/test_pallas.py:9-14``).  A tile whose plan has the
  whole run's ``n_safe`` is bit-equal to the whole run's cells.  On the
  near-field tiling a tile's own halo gives ``n_safe = n_dense - 1``,
  where the reference's trailing d1 single reuses the near-field ``h2``
  (``pallas_sweep.py:754-757``): there the tile is held to the oracle on
  the same tile, and its measured difference from the whole run is
  printed (0.0168 rad on this scene).
* The shared pyramid: every tile bit-equal to a tile that builds its own.
* Resume after a kill, for both runners; ``SunTrackRunner`` bit-equal to
  one ``sw_dir_cor_batch`` (``shadow_batch``) call of the port's
  ``Terrain`` (``tests/test_torch_shadow.py`` holds ``Terrain`` against
  the JAX package).
* ``SweepStats`` JSON equal to the reference's; ``time_sweep``, ``sync``
  and ``profiler_trace`` on the CPU; ``write_horizon`` files equal array
  for array to the reference's.

CPU cost: about 35 s of wall on one core, most of it the JAX oracle's
import and compiles in one subprocess.
"""

import json
import os

import numpy as np
import pytest
import torch

from horayzon_tpu.utils import output as output_ref
from horayzon_tpu.utils import profiling as profiling_ref
from horayzon_tpu_torch import shadow
from horayzon_tpu_torch.ops import fused_sweep, sweep
from horayzon_tpu_torch.utils import output, profiling, streaming

from test_torch_fused_sweep import TOL
from test_torch_sweep_engine import ANGLE_TOL, ULPS, run_oracle, ulp_diff
from torch_scenes import RUNNER_SCENES, sun_track_terrain_inputs

#: Azimuths off the fused route's grid (the XLA route).
XLA_AZIM = np.array([0.1, 1.3, 2.0, 4.4])
SWEEP_KW = dict(dx=25.0, dy=-25.0)
AZIM_NUM = 4

_ORACLE = r"""
import json, sys, tempfile
import numpy as np
import jax, jax.numpy as jnp
from horayzon_tpu.ops import pallas_sweep, sweep
from horayzon_tpu.utils import streaming
inputs = np.load(sys.argv[1])
calls = json.load(open(sys.argv[2]))
out = {}
for name, c in calls.items():
    z = inputs[name + ":z"]
    tiles = [tuple(t) for t in c["tiles"]]
    off = tuple(c["offset"])
    if c["kind"] == "xla":
        azim = inputs[name + ":azim"]
        with tempfile.TemporaryDirectory() as td:
            r = streaming.TiledHorizonRunner(
                z, dx=c["dx"], dy=c["dy"], offset=off,
                inner_shape=tuple(c["inner_shape"]), azim=azim,
                dist_search=c["dist"], out_dir=td, tile=tuple(c["tile"]))
            r.run(verbose=False)
            out[name + ":hori"] = r.assemble()
        zj = jnp.asarray(z)
        step = min(abs(c["dx"]), abs(c["dy"]))
        for i0, j0, n0, n1 in tiles:
            t_off = (off[0] + i0, off[1] + j0)
            sched = sweep.build_schedule(step, c["dist"],
                                         sweep.default_rel_err(0.25))
            h, w = z.shape
            sched = sweep.mark_safe_phases(sched, min(
                t_off[0], t_off[1], h - t_off[0] - n0, w - t_off[1] - n1))
            a64 = azim.astype(np.float64)
            tables = jax.tree_util.tree_map(jnp.asarray,
                sweep.horizon_shift_tables(sched, a64, c["dx"], c["dy"],
                                           t_off))
            trig = {"sin": jnp.asarray(np.sin(a64), jnp.float32),
                    "cos": jnp.asarray(np.cos(a64), jnp.float32),
                    "ux": jnp.asarray(np.sin(a64), jnp.float32),
                    "uy": jnp.asarray(np.cos(a64), jnp.float32)}
            z_in = zj[t_off[0]:t_off[0] + n0, t_off[1]:t_off[1] + n1]
            raw, _ = sweep._horizon_core(
                zj, z_in + jnp.float32(0.01), z_in, None, tables, trig,
                sched_meta=sched.meta(), pads=sched.pads,
                inner_shape=(n0, n1), planar=True, track_dist=False,
                apply_arctan=False)
            out[f"{name}:raw:{i0}:{j0}"] = np.asarray(raw)
    else:
        for i0, j0, n0, n1 in tiles:
            out[f"{name}:tile:{i0}:{j0}"] = np.asarray(
                pallas_sweep.horizon_sweep_pallas(
                    z, dx=c["dx"], dy=c["dy"],
                    offset=(off[0] + i0, off[1] + j0), inner_shape=(n0, n1),
                    azim_num=c["azim_num"], dist_search=c["dist"],
                    hori_acc=0.25, tile=(n0, n1), interpret=True))
np.savez(sys.argv[3], **out)
"""


def _runner(name, out_dir, azim=None, **kw):
    z, scene, tile = RUNNER_SCENES[name]
    if azim is None:
        azim = (2 * np.pi / AZIM_NUM) * np.arange(AZIM_NUM)
    return streaming.TiledHorizonRunner(z, azim=azim, out_dir=str(out_dir),
                                        tile=tile, device="cpu",
                                        **SWEEP_KW, **scene, **kw)


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    arrays, calls = {}, {}
    tmp = tmp_path_factory.mktemp("runners")
    for name, (z, scene, tile) in RUNNER_SCENES.items():
        tiles = [list(t) for t in _runner(name, tmp / name).tiles()]
        base = dict(SWEEP_KW, offset=list(scene["offset"]),
                    inner_shape=list(scene["inner_shape"]),
                    dist=scene["dist_search"], tile=list(tile), tiles=tiles)
        arrays[name + ":z"] = z
        calls[name] = dict(base, kind="pallas", azim_num=AZIM_NUM)
    arrays["xla:z"] = RUNNER_SCENES["bumps96"][0]
    arrays["xla:azim"] = XLA_AZIM
    calls["xla"] = dict(calls["bumps96"], kind="xla")
    return run_oracle(_ORACLE, arrays, calls, tmp_path_factory.mktemp("o"))


def _port_raw(z, offset, inner_shape, azim, dist, dx=25.0, dy=-25.0):
    """Raw ratios of the port's XLA engine at one tile, set up as
    ``sweep.horizon_sweep`` sets it up."""
    zt = torch.from_numpy(z)
    sched = sweep.mark_safe_phases(
        sweep.build_schedule(min(abs(dx), abs(dy)), dist,
                             sweep.default_rel_err(0.25)),
        min(offset[0], offset[1], z.shape[0] - offset[0] - inner_shape[0],
            z.shape[1] - offset[1] - inner_shape[1]))
    a64 = np.asarray(azim, dtype=np.float64)
    (o0, o1), (n0, n1) = offset, inner_shape
    z_in = zt[o0:o0 + n0, o1:o1 + n1]
    raw, _ = sweep.horizon_core(
        zt, z_in + float(np.float32(0.01)), z_in, None,
        sweep.horizon_shift_tables(sched, a64, dx, dy, offset),
        sweep.sweep_trig(a64), sched_meta=sched.meta(), pads=sched.pads,
        inner_shape=(n0, n1), planar=True, track_dist=False,
        apply_arctan=False)
    return raw


def test_xla_route_matches_jax_runner(oracle, tmp_path):
    r = _runner("bumps96", tmp_path, azim=XLA_AZIM)
    assert not r.fused
    r.run(verbose=False)
    got = r.assemble()
    np.testing.assert_allclose(got, oracle["xla:hori"], rtol=0,
                               atol=ANGLE_TOL)
    z, scene, _ = RUNNER_SCENES["bumps96"]
    off = scene["offset"]
    for i0, j0, n0, n1 in r.tiles():
        t_off = (off[0] + i0, off[1] + j0)
        raw = _port_raw(z, t_off, (n0, n1), XLA_AZIM, scene["dist_search"])
        assert ulp_diff(raw.numpy(),
                        oracle[f"xla:raw:{i0}:{j0}"]) <= ULPS, (i0, j0)
        angles = torch.clamp(torch.atan(raw), np.radians(-15.0),
                             np.radians(89.98))
        np.testing.assert_array_equal(got[i0:i0 + n0, j0:j0 + n1],
                                      angles.numpy())


@pytest.mark.parametrize("name", sorted(RUNNER_SCENES))
def test_fused_route_matches_interpret_pallas(oracle, tmp_path, name):
    r = _runner(name, tmp_path)
    assert r.fused
    n0_launches = fused_sweep.KERNEL_LAUNCHES
    r.run(verbose=False)
    assert fused_sweep.KERNEL_LAUNCHES == n0_launches  # CPU: plain version
    got = r.assemble()
    z, scene, _ = RUNNER_SCENES[name]
    whole = fused_sweep.horizon_sweep_fused(
        torch.from_numpy(z), azim_num=AZIM_NUM, **SWEEP_KW, **scene).numpy()
    whole_plan = fused_sweep.plan_sweep(
        z.shape, dx=25.0, dy=-25.0, **scene)
    off = scene["offset"]
    quirk_tiles = 0
    for i0, j0, n0, n1 in r.tiles():
        tile = got[i0:i0 + n0, j0:j0 + n1]
        ref = oracle[f"{name}:tile:{i0}:{j0}"]
        err = float(np.abs(tile - ref).max())
        assert err <= TOL, (name, i0, j0, err)
        plan = fused_sweep.plan_sweep(
            z.shape, offset=(off[0] + i0, off[1] + j0), inner_shape=(n0, n1),
            dist_search=scene["dist_search"], dx=25.0, dy=-25.0)
        diff = float(np.abs(tile - whole[i0:i0 + n0, j0:j0 + n1]).max())
        if plan["n_safe"] == whole_plan["n_safe"]:
            assert diff == 0.0, (name, i0, j0, diff)
        else:
            assert plan["n_safe"] == plan["n_dense"] - 1
            quirk_tiles += 1
            print(f"{name} tile ({i0}, {j0}): n_safe {plan['n_safe']} (run "
                  f"{whole_plan['n_safe']}), n_dense {plan['n_dense']}: "
                  f"{diff:.4e} rad from the whole run, {err:.2e} from the "
                  f"oracle on the tile")
            assert diff > 0.0   # the scene exercises the near-field h2
    assert quirk_tiles == (1 if name == "nearfield84" else 0)


@pytest.mark.parametrize("name", sorted(RUNNER_SCENES))
def test_shared_pyramid_bit_equal_to_per_tile_build(tmp_path, name):
    r = _runner(name, tmp_path)
    z, scene, _ = RUNNER_SCENES[name]
    zt = torch.from_numpy(z)
    off = scene["offset"]
    for i0, j0, n0, n1 in r.tiles():
        own = fused_sweep.horizon_sweep_fused(
            zt, offset=(off[0] + i0, off[1] + j0), inner_shape=(n0, n1),
            azim_num=AZIM_NUM, dist_search=scene["dist_search"], **SWEEP_KW)
        assert torch.equal(r.sweep_tile(i0, j0, n0, n1), own), (i0, j0)


def _kill_on_call(obj, attr, n_kill):
    """Patch ``obj.attr`` to raise KeyboardInterrupt from its
    ``n_kill``-th call on; returns the original."""
    orig = getattr(obj, attr)
    calls = {"n": 0}

    def dying(*a, **kw):
        calls["n"] += 1
        if calls["n"] >= n_kill:
            raise KeyboardInterrupt
        return orig(*a, **kw)

    setattr(obj, attr, dying)
    return orig


def test_tiled_runner_resumes_after_kill(tmp_path):
    ref = _runner("bumps96", tmp_path / "ref")
    ref.run(verbose=False)
    want = ref.assemble()
    r = _runner("bumps96", tmp_path / "run")
    _kill_on_call(r, "sweep_tile", 2)
    with pytest.raises(KeyboardInterrupt):
        r.run(verbose=False)
    del r.sweep_tile                     # the class's method again
    paths = [r._tile_path(i0, j0) for i0, j0, _, _ in r.tiles()]
    assert [os.path.exists(p) for p in paths] == [True, False, False, False]
    assert not [f for f in os.listdir(r.out_dir) if "tmp" in f]
    mtime0 = os.path.getmtime(paths[0])
    assert r.run(verbose=False) == paths
    assert os.path.getmtime(paths[0]) == mtime0
    np.testing.assert_array_equal(r.assemble(), want)
    # the reference's resume: one tile deleted, only it recomputed
    os.unlink(paths[1])
    mtimes = {p: os.path.getmtime(p) for p in paths if os.path.exists(p)}
    r.run(verbose=False)
    for p, m in mtimes.items():
        assert os.path.getmtime(p) == m
    np.testing.assert_array_equal(r.assemble(), want)


def _sun_track_terrain():
    """tests/test_utils.py's sun-track scene on the port's Terrain."""
    args, suns = sun_track_terrain_inputs()
    t = shadow.Terrain()
    t.initialise(*args, device="cpu")
    return t, suns


@pytest.mark.parametrize("mode", ["sw_dir_cor", "shadow"])
def test_sun_track_runner_matches_batch_and_resumes(tmp_path, mode):
    t, suns = _sun_track_terrain()
    batch = t.sw_dir_cor_batch if mode == "sw_dir_cor" else t.shadow_batch
    want = batch(suns).numpy()
    runner = streaming.SunTrackRunner(t, suns, out_dir=str(tmp_path),
                                      mode=mode, chunk=3)
    attr = f"{mode}_batch"
    orig = _kill_on_call(t, attr, 2)
    with pytest.raises(KeyboardInterrupt):
        runner.run(verbose=False)
    setattr(t, attr, orig)
    done = [p for t0, _ in runner.chunks()
            if os.path.exists(p := runner._chunk_path(t0))]
    assert len(done) == 1               # first chunk survived the kill
    mtime0 = os.path.getmtime(done[0])
    paths = runner.run(verbose=False)
    assert os.path.getmtime(done[0]) == mtime0
    assert all(os.path.exists(p) for p in paths)
    got = runner.assemble()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_sweep_stats_json_matches_reference():
    kw = dict(wall_time_s=2.0, cells=1000, azim_num=10,
              samples_per_cell_azim=100)
    got, ref = profiling.SweepStats(**kw), profiling_ref.SweepStats(**kw)
    assert got.samples_per_s == ref.samples_per_s == 1000 * 10 * 100 / 2.0
    assert got.rays_per_s_equivalent == ref.rays_per_s_equivalent
    assert got.to_json() == ref.to_json()
    assert json.loads(got.to_json())["rays_per_s_equivalent"] == 10000.0


def test_time_sweep_sync_and_profiler_trace_on_cpu(tmp_path):
    x = {"a": torch.ones(8, 8), "b": [torch.zeros(2), 3]}
    assert profiling.sync(x) is x
    stats = profiling.time_sweep(lambda: torch.ones((8, 8)) * 2, cells=64,
                                 azim_num=1, samples_per_cell_azim=1,
                                 iters=2)
    assert stats.wall_time_s > 0
    held = []
    with profiling.timed(result_holder=held):
        torch.ones(4).sum()
    assert len(held) == 1 and held[0] > 0
    log_dir = tmp_path / "trace"
    with profiling.profiler_trace(str(log_dir)):
        torch.mm(torch.ones(32, 32), torch.ones(32, 32))
    files = os.listdir(log_dir)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(log_dir / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


@pytest.mark.parametrize("ext", [".npz", ".nc"])
def test_write_horizon_matches_reference(tmp_path, capsys, ext):
    hori = np.random.default_rng(0).random((4, 5, 3)).astype(np.float32)
    azim = np.linspace(0, 2 * np.pi, 3, endpoint=False).astype(np.float32)
    grids = [dict(x=np.arange(5.0), y=np.arange(4.0)[::-1]),
             dict(lon=np.linspace(7.0, 8.0, 5), lat=np.linspace(47, 46, 4))]
    for n, coords in enumerate(grids):
        os.makedirs(tmp_path / f"p{n}")
        os.makedirs(tmp_path / f"r{n}")
        got = output.write_horizon(str(tmp_path / f"p{n}" / f"h{ext}"),
                                   hori, azim, **coords)
        ref = output_ref.write_horizon(str(tmp_path / f"r{n}" / f"h{ext}"),
                                       hori, azim, **coords)
        assert os.path.basename(got) == os.path.basename(ref)
        if got.endswith(".npz"):
            a, b = np.load(got), np.load(ref)
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
            assert a["horizon"].shape == (3, 4, 5)
    if ext == ".nc":
        assert "writing" in capsys.readouterr().out or got.endswith(".nc")
