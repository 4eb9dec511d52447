"""Kernels K1 (csrc/horizon_sweep.cu, with its argmax, mask and tilt-ramp
variants), K2 (the shadow mode of the same source, with its argmax
variant), K3 and K4 (csrc/horizon_replay_bwd.cu, horizon and shadow
modes) and K5 (csrc/read_floor.cu) on the card, against their plain torch
versions on the same card, and the gradient paths, the masked and curved
``horizon_gridded``, the ``CurvedPipeline``, the shadow ``Terrain`` and
the multires sweep they make.

Marked ``cuda`` and skipped without a CUDA device.  This file imports no
JAX, so on a machine with the card it runs without the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: 1e-5 rad on the horizon angle.  Kernel and plain version do
the same float32 operations in the same order (no FMA contraction,
correctly rounded sqrt and divide), so they agree to a few ulp of the
arctan; the argmax variant's raw ratios, ids and D are equal.  K3 against
the plain backward: bit-equal (the same float32 terms, accumulated exactly
in fixed point on the same grid), and two K3 runs bit-equal, also on a
contention scene whose winners crowd onto a few targets.  K2 against its plain
version: bit-equal (the same float32 operations in the same order, and
value-exact skips); K2-argmax's metric, ids and D equal; on the shadow
skip scenes K2 and K2-argmax bit-equal and their skip counters equal to the
plain model's, and K2's sign-exact arm bit-equal to the plain sweep that
skips where the model does, with the exact metric's sign; K4 against the
plain shadow replay as K3 against its plain version.  K1's mask and
tilt-ramp variants: raw ratios, ids and D bit-equal to the plain versions';
masked cells and blocks that are not launched hold 3e38, ID_NONE and 1;
unmasked cells bit-equal to the dense run.  A CUDA ``Terrain`` (K2
sign-exact) against a CPU one (the exact plain metric): codes equal and
``sw_dir_cor`` within 1e-5 plus 1e-6 relative on every cell but those whose
sun dot products lie within 1e-6 of a threshold (the card's arccos, tan and
power may differ from the CPU's by an ulp).
A curved ``Terrain`` on the card against the same on the CPU: codes equal
outside the sun-dot thresholds, ``sw_dir_cor`` as above; its soft gradient
bit-equal across two runs (the read-back's backward sums in a fixed order)
and within 1e-5 of max|g| of the CPU's.  ``horizon_locations`` on the card
against the CPU path: ``hori`` within 1e-6 rad, ``hori_dist`` within 1e-6
relative (the same float32 operations; arctan and cos rounded from
float64 on each device).
K5: every mode and source bit-equal to its plain version.  Multires: the
card's angles within 1e-5 rad of the CPU path's (the raw ratios are
bit-equal, the arctan may differ by an ulp), masked cells aside bit-equal
to the dense run on the card, both gradients within rtol 1e-5 of the CPU
path.  The streaming runners: the tiled runner's tiles (K1, one launch a
tile) bit-equal to ``horizon_sweep_fused`` on each tile, each tile's raw
ratios bit-equal to K1's plain version on the CPU and its angles within
1e-5 rad of the CPU runner's; the sun-track runner (K2, one launch a
chunk) bit-equal to one ``sw_dir_cor_batch`` call; ``profiling.sync``
returns only after the work queued before it has run.
"""

import os
import time

import numpy as np
import pytest
import torch

from horayzon_tpu_torch import (auxiliary, horizon, parallel, shadow,
                                terrain, topo_param)
from horayzon_tpu_torch.models import CurvedPipeline
from horayzon_tpu_torch.ops import _build, fused_sweep, multires, replay
from horayzon_tpu_torch.ops import read_floor, refraction, sweep
from horayzon_tpu_torch.ops import shadow_sweep as ss
from horayzon_tpu_torch.parallel import shard
from horayzon_tpu_torch.utils import profiling, streaming

from reference_impl import gaussian_bumps_terrain
from torch_scenes import (RUNNER_SCENES, SHADOW_SKIP_SCENES, SHARD_MESHES,
                          SKIP_SCENES, bumps, refraction_numpy,
                          curved_setup, curved_terrain_inputs,
                          shadow_skip_scene, sharded_scenes, skip_scene,
                          sun_track_terrain_inputs)

pytestmark = pytest.mark.cuda

TOL = 1.0e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run -m cuda on a machine with "
                    "the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _spike():
    halo, inner = 256, 64
    z = np.zeros((inner + 2 * halo,) * 2, dtype=np.float32)
    z[halo - 96, halo + 32] = 500.0
    return z, halo, inner


def _case(name):
    """(z, kwargs) of a kernel-vs-plain case, built when a test runs."""
    if name == "bumps96_d2500":
        return (gaussian_bumps_terrain(96, 96, seed=3, amp=300.0),
                dict(offset=(32, 32), inner_shape=(32, 32), azim_num=4,
                     dist_search=2500.0, dx=25.0, dy=-25.0))
    if name == "halo12_dxdy":
        return (gaussian_bumps_terrain(56, 56, seed=5, amp=300.0),
                dict(offset=(12, 12), inner_shape=(32, 32), azim_num=5,
                     dist_search=825.0, dx=25.0, dy=-30.0))
    if name == "spike_d6000":
        z, halo, inner = _spike()
        return (z, dict(offset=(halo, halo), inner_shape=(inner, inner),
                        azim_num=7, dist_search=6000.0, dx=25.0, dy=-25.0))
    if name == "inner512_d20000":
        # tests/test_tpu.py:45-63 scale: 20 km search over a 512^2 block
        halo = 800
        return (gaussian_bumps_terrain(512 + 2 * halo, 512 + 2 * halo,
                                       seed=3, amp=800.0),
                dict(offset=(halo, halo), inner_shape=(512, 512),
                     azim_num=16, dist_search=20000.0, dx=25.0, dy=-25.0))
    if name == "deep_dx2_d3000":
        # tests/test_tpu.py:66-95: 2 m grid, five pyramid levels
        halo, inner = int(3000.0 / 2.0) + 32, 64
        z = gaussian_bumps_terrain(inner + 2 * halo, inner + 2 * halo,
                                   seed=7, amp=1200.0, dx=2.0)
        z += np.random.default_rng(5).standard_normal(z.shape).astype(
            np.float32)
        return (z, dict(offset=(halo, halo), inner_shape=(inner, inner),
                        azim_num=8, dist_search=3000.0, dx=2.0, dy=-2.0))
    raise KeyError(name)


CASES = ["bumps96_d2500", "halo12_dxdy", "spike_d6000", "inner512_d20000",
         "deep_dx2_d3000"]


@pytest.mark.parametrize("name", CASES)
def test_kernel_matches_plain(cuda, name):
    z, kw = _case(name)
    zt = torch.from_numpy(z).to(cuda)
    n0 = fused_sweep.KERNEL_LAUNCHES
    got = fused_sweep.horizon_sweep_fused(zt, **kw)
    assert fused_sweep.KERNEL_LAUNCHES == n0 + 1
    ref = fused_sweep.horizon_sweep_plain(zt, **kw)
    assert fused_sweep.KERNEL_LAUNCHES == n0 + 1
    torch.cuda.synchronize()
    assert got.is_cuda and got.shape == kw["inner_shape"] + (kw["azim_num"],)
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max().item() <= TOL


def test_kernel_with_prebuilt_pyramid(cuda):
    from horayzon_tpu_torch.ops import mip

    z, kw = _case("spike_d6000")
    zt = torch.from_numpy(z).to(cuda)
    plan = fused_sweep.plan_sweep(tuple(z.shape), **{
        k: kw[k] for k in ("offset", "inner_shape", "dist_search", "dx",
                           "dy")})
    levels = mip.padded_levels(zt, plan["pads"])
    a = fused_sweep.horizon_sweep_fused(zt, pyramid=levels, **kw)
    b = fused_sweep.horizon_sweep_fused(zt, **kw)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_missing_kernel_source_raises(cuda, tmp_path, monkeypatch):
    """No fallback: a CUDA call whose kernel cannot be built raises."""
    z, kw = _case("bumps96_d2500")
    zt = torch.from_numpy(z).to(cuda)
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path / "csrc")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LOADED", {})
    n0 = fused_sweep.KERNEL_LAUNCHES
    with pytest.raises(FileNotFoundError, match="horizon_sweep.cu"):
        fused_sweep.horizon_sweep_fused(zt, **kw)
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "horizon_sweep.cu").write_text("not C++\n")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        fused_sweep.horizon_sweep_fused(zt, **kw)
    assert fused_sweep.KERNEL_LAUNCHES == n0


@pytest.mark.parametrize("name", CASES)
def test_argmax_kernel_matches_plain(cuda, name):
    z, kw = _case(name)
    args = fused_sweep.sweep_args(torch.from_numpy(z).to(cuda), **kw)
    n0 = fused_sweep.ARGMAX_KERNEL_LAUNCHES
    raw, ids, aux = fused_sweep._ratio_cuda(*args, emit_argmax=True)
    assert fused_sweep.ARGMAX_KERNEL_LAUNCHES == n0 + 1
    p_raw, p_ids, p_aux = fused_sweep._ratio_plain(*args, emit_argmax=True)
    raw_k1 = fused_sweep._ratio_cuda(*args)
    torch.cuda.synchronize()
    assert ids.dtype == torch.int32 and ids.shape == raw.shape
    assert torch.equal(raw, raw_k1) and torch.equal(raw, p_raw)
    assert torch.equal(ids, p_ids) and torch.equal(aux, p_aux)


@pytest.mark.parametrize("name", CASES)
def test_replay_kernel_matches_plain_and_repeats(cuda, name):
    z, kw = _case(name)
    zt = torch.from_numpy(z).to(cuda)
    args = fused_sweep.sweep_args(zt, **kw)
    raw, ids, aux = fused_sweep._ratio_cuda(*args, emit_argmax=True)
    g = torch.from_numpy(np.random.default_rng(7).normal(
        size=tuple(raw.shape)).astype(np.float32)).to(cuda)
    bargs = (tuple(zt.shape), g, ids, aux, args[4],
             replay.horizon_shifts(args[3], args[4]))
    n0 = replay.KERNEL_LAUNCHES
    cots, zcot = replay._bwd_cuda(*bargs)
    assert replay.KERNEL_LAUNCHES == n0 + 1
    cots2, zcot2 = replay._bwd_cuda(*bargs)
    p_cots, p_zcot = replay.backward_replay_plain(*bargs)
    torch.cuda.synchronize()
    for got, again, want in zip(cots + [zcot], cots2 + [zcot2],
                                p_cots + [p_zcot]):
        assert torch.equal(got, again)
        assert torch.equal(got, want)
    assert zcot.abs().max().item() > 0.0


def test_replay_contention_scene(cuda):
    """A tall spike at the centre of a flat 256^2 grid: the 262,144
    (cell, azimuth) winners crowd onto about two thousand level-0 cells and
    a hundred coarse ones, so many lanes of a warp hit one target.  K3
    bit-equal across two runs and to the plain backward."""
    z = np.zeros((256, 256), dtype=np.float32)
    z[128, 128] = 2000.0
    args = fused_sweep.sweep_args(
        torch.from_numpy(z).to(cuda), offset=(64, 64), inner_shape=(128, 128),
        azim_num=16, dist_search=8000.0, dx=25.0, dy=-25.0)
    raw, ids, aux = fused_sweep._ratio_cuda(*args, emit_argmax=True)
    g = torch.from_numpy(np.random.default_rng(7).normal(
        size=tuple(raw.shape)).astype(np.float32)).to(cuda)
    bargs = (tuple(z.shape), g, ids, aux, args[4],
             replay.horizon_shifts(args[3], args[4]))
    cots, zcot = replay._bwd_cuda(*bargs)
    cots2, zcot2 = replay._bwd_cuda(*bargs)
    p_cots, p_zcot = replay.backward_replay_plain(*bargs)
    torch.cuda.synchronize()
    assert [int((c != 0).sum()) for c in p_cots][0] < 4000
    for got, again, want in zip(cots + [zcot], cots2 + [zcot2],
                                p_cots + [p_zcot]):
        assert torch.equal(got, again) and torch.equal(got, want)


def test_gradient_central_finite_difference(cuda):
    """tests/test_pallas.py:118-128 on the card: K1-argmax and K3 behind
    ``torch.autograd``."""
    z = torch.from_numpy(gaussian_bumps_terrain(96, 96, seed=4,
                                                amp=300.0)).to(cuda)
    kw = dict(dx=25.0, dy=-25.0, offset=(32, 32), inner_shape=(32, 32),
              azim_num=4, dist_search=900.0, hori_acc=0.25)

    def loss(zz):
        return torch.mean(fused_sweep.horizon_sweep_fused(zz, **kw).double()
                          ** 2)

    zg = z.clone().requires_grad_(True)
    n0, k0 = fused_sweep.ARGMAX_KERNEL_LAUNCHES, replay.KERNEL_LAUNCHES
    loss(zg).backward()
    assert fused_sweep.ARGMAX_KERNEL_LAUNCHES == n0 + 1
    assert replay.KERNEL_LAUNCHES == k0 + 1
    v = torch.from_numpy(np.random.default_rng(11).normal(
        size=(96, 96)).astype(np.float32)).to(cuda)
    eps = 3e-2
    with torch.no_grad():
        fd = (loss(z + eps * v) - loss(z - eps * v)).item() / (2 * eps)
    an = float((zg.grad.double() * v.double()).sum())
    assert abs(fd - an) < 3e-3 * max(1.0, abs(an)), (fd, an)
    # along a smooth bump (tests/test_torch_grad.py): within 2% relative
    yy, xx = np.mgrid[0:96, 0:96]
    w = torch.from_numpy(np.exp(
        -((yy - 40.32) ** 2 + (xx - 49.92) ** 2) / (2 * 15.36 ** 2))
        .astype(np.float32)).to(cuda)
    with torch.no_grad():
        fd = (loss(z + 0.1 * w) - loss(z - 0.1 * w)).item() / 0.2
    an = float((zg.grad.double() * w.double()).sum())
    assert an != 0.0 and abs(fd - an) <= 2e-2 * abs(an), (fd, an)
    # the same gradient as the CPU path's plain versions
    zc = z.cpu().requires_grad_(True)
    loss(zc).backward()
    scale = zc.grad.abs().max().item()
    assert (zg.grad.cpu() - zc.grad).abs().max().item() <= 1e-5 * scale


def _shadow_case(name):
    """(z, offset, inner, dx, dy, origin, suns relative to the centre) of a
    K2-vs-plain case: the shapes of tests/test_torch_shadow.py and the
    bench row's sun track on a 512^2 block."""
    z128 = gaussian_bumps_terrain(128, 128, seed=5, amp=400.0)
    if name == "pallas_128_inner64":
        return (z128, (32, 32), (64, 64), 25.0, -25.0, (0.0, 0.0),
                [(2.0e5, 1.0e5, 2.0e4), (-1.5e5, -0.5e5, 1.2e4),
                 (0.3e5, -2.0e5, 3.0e4)])
    if name == "dx_ne_dy":
        return (gaussian_bumps_terrain(64, 72, seed=2, amp=500.0), (12, 10),
                (32, 40), 25.0, -30.0, (1000.0, 5.0e5),
                [(2.0e5, 1.0e5, 1.5e4), (-1.0e5, 2.0e5, 1.0e4),
                 (-2.0e5, -0.4e5, 2.0e4), (0.5e5, -2.0e5, 0.8e4)])
    if name == "below_vertical":
        return (z128, (32, 32), (64, 64), 25.0, -25.0, (0.0, 0.0),
                [(1.0e5, 0.0, -1.0e6), (0.0, 0.0, 2.0e4)])
    if name == "far_spike":
        z = np.zeros((256, 256), dtype=np.float32)
        z[2, 250] = 500.0
        return (z, (216, 8), (32, 32), 25.0, -25.0, (0.0, 0.0),
                [(2.1e5, 2.1e5, 6.0e3), (2.0e5, 2.2e5, 8.0e3)])
    if name == "track_1024_inner512":
        tt = np.linspace(0.15, 2.9, 16)
        return (gaussian_bumps_terrain(1024, 1024, seed=3, amp=800.0),
                (256, 256), (512, 512), 25.0, -25.0, (0.0, 0.0),
                list(zip(3.0e5 * np.cos(tt), 3.0e5 * np.sin(tt),
                         2.0e4 + 1.0e4 * np.sin(2 * tt))))
    raise KeyError(name)


SHADOW_CASES = ["pallas_128_inner64", "dx_ne_dy", "below_vertical",
                "far_spike", "track_1024_inner512"]


@pytest.mark.parametrize("name", SHADOW_CASES)
def test_shadow_kernel_matches_plain(cuda, name):
    z, off, inner, dx, dy, origin, rel = _shadow_case(name)
    h, w = z.shape
    cx, cy = origin[0] + 0.5 * (w - 1) * dx, origin[1] + 0.5 * (h - 1) * dy
    suns = np.array([[cx + a, cy + b, c] for a, b, c in rel], np.float32)
    table, _ = ss.shadow_sun_table(suns, (cx, cy), dx, dy)
    zt = torch.from_numpy(z).to(cuda)
    z_inner = zt[off[0]:off[0] + inner[0], off[1]:off[1] + inner[1]]
    z_org = z_inner + float(np.float32(0.05))
    kw = dict(offset=off, inner_shape=inner, dx=dx, dy=dy,
              grid_origin=origin)
    n0 = ss.KERNEL_LAUNCHES
    got = ss.shadow_metric_fused(zt, z_org, z_inner, table, **kw)
    assert ss.KERNEL_LAUNCHES == n0 + 1
    ref = ss.shadow_metric_plain(zt, z_org, z_inner, table, **kw)
    assert ss.KERNEL_LAUNCHES == n0 + 1
    torch.cuda.synchronize()
    assert got.is_cuda and tuple(got.shape) == (len(rel),) + inner
    assert torch.isfinite(got).all()
    assert torch.equal(got, ref)


def _shadow_args(cuda, name):
    """``(metric_args, z_org, table, grid_origin)`` of a shadow case on the
    card."""
    z, off, inner, dx, dy, origin, rel = _shadow_case(name)
    h, w = z.shape
    cx, cy = origin[0] + 0.5 * (w - 1) * dx, origin[1] + 0.5 * (h - 1) * dy
    suns = np.array([[cx + a, cy + b, c] for a, b, c in rel], np.float32)
    table, _ = ss.shadow_sun_table(suns, (cx, cy), dx, dy)
    zt = torch.from_numpy(z).to(cuda)
    z_inner = zt[off[0]:off[0] + inner[0], off[1]:off[1] + inner[1]]
    args = ss.metric_args(zt, z_inner + float(np.float32(0.05)), z_inner,
                          table, offset=off, inner_shape=inner, dx=dx, dy=dy)
    return args, origin


@pytest.mark.parametrize("name", SHADOW_CASES)
def test_shadow_argmax_kernel_matches_plain(cuda, name):
    """K2-argmax: the metric bit-equal to K2's, ids and D equal to the
    plain argmax sweep's (the same float32 operations in the same order)."""
    args, origin = _shadow_args(cuda, name)
    n0 = ss.ARGMAX_KERNEL_LAUNCHES
    met, ids, aux = ss._metric_cuda(*args, grid_origin=origin,
                                    emit_argmax=True)
    assert ss.ARGMAX_KERNEL_LAUNCHES == n0 + 1
    k2 = ss._metric_cuda(*args, grid_origin=origin)
    p_met, p_ids, p_aux = ss._metric_plain(*args, grid_origin=origin,
                                           emit_argmax=True)
    torch.cuda.synchronize()
    assert ids.dtype == torch.int32 and ids.shape == met.shape
    assert torch.equal(met, k2) and torch.equal(met, p_met)
    assert torch.equal(ids, p_ids) and torch.equal(aux, p_aux)
    assert (ids < replay.ID_NONE).all()


@pytest.mark.parametrize("name", SHADOW_CASES)
def test_shadow_replay_kernel_matches_plain_and_repeats(cuda, name):
    """K4 against the plain shadow replay on K2-argmax's record: bit-equal,
    and two K4 runs bit-equal."""
    args, origin = _shadow_args(cuda, name)
    z_org, table, plan = args[0], args[3], args[4]
    met, ids, aux = ss._metric_cuda(*args, grid_origin=origin,
                                    emit_argmax=True)
    g = torch.from_numpy(np.random.default_rng(7).normal(
        size=tuple(met.shape)).astype(np.float32)).to(cuda)
    z_shape = tuple(args[5])
    n0 = replay.SHADOW_KERNEL_LAUNCHES
    shadow = (table, z_org, origin)
    cots, dzorg = replay.backward_replay(z_shape, g, ids, aux, plan,
                                         shadow=shadow)
    assert replay.SHADOW_KERNEL_LAUNCHES == n0 + 1
    cots2, dzorg2 = replay.backward_replay(z_shape, g, ids, aux, plan,
                                           shadow=shadow)
    p_cots, p_dzorg = replay.backward_replay_plain(z_shape, g, ids, aux, plan,
                                                   shadow=shadow)
    torch.cuda.synchronize()
    for got, again, want in zip(cots + [dzorg], cots2 + [dzorg2],
                                p_cots + [p_dzorg]):
        assert torch.equal(got, again)
        assert torch.equal(got, want)
    assert dzorg.abs().max().item() > 0.0


def _terrain_inputs(z, off, inner, dx=25.0):
    """Terrain.initialise inputs from the port's own helpers (north up)."""
    h, w = z.shape
    in0, in1 = inner
    x1 = np.arange(w, dtype=np.float32) * dx
    y1 = -np.arange(h, dtype=np.float32) * dx
    xx, yy = np.meshgrid(x1, y1)
    vec_norm = np.zeros((in0, in1, 3), dtype=np.float32)
    vec_norm[..., 2] = 1.0
    sl1 = (slice(off[0] - 1, off[0] + in0 + 1),
           slice(off[1] - 1, off[1] + in1 + 1))
    vec_tilt = topo_param.slope_plane_meth(xx[sl1], yy[sl1],
                                           z[sl1])[1:-1, 1:-1].numpy()
    mask = np.ones(inner, dtype=np.uint8)
    mask[:3, :20] = 0
    return (auxiliary.rearrange_pad_buffer(xx, yy, z), h, w, off[0], off[1],
            np.ascontiguousarray(vec_tilt), vec_norm,
            topo_param.surface_enlargement_factor(vec_norm,
                                                  vec_tilt).numpy(),
            np.ascontiguousarray(z[off[0]:off[0] + in0,
                                   off[1]:off[1] + in1]), mask)


@pytest.mark.parametrize("refrac_cor", [False, True])
def test_cuda_terrain_matches_cpu_terrain(cuda, refrac_cor):
    z = gaussian_bumps_terrain(96, 160, seed=11, amp=600.0)
    args = _terrain_inputs(z, (16, 16), (64, 128))
    suns = np.array([[1.0e7, 0.0, 1.5e6], [-4.0e6, 8.0e6, 1.5e6],
                     [2.0e6, -1.0e7, 3.0e6], [0.0, 1.0e7, -1.0e6]],
                    dtype=np.float32)
    terrains = []
    for dev in (cuda, "cpu"):
        t = shadow.Terrain()
        t.initialise(*args, sw_dir_cor_fill=-7.0, refrac_cor=refrac_cor,
                     device=dev)
        terrains.append(t)
    tg, tc = terrains
    _, dot_ts = shadow.sun_dots(tc._fields, suns, refrac_cor)
    dot_min = float(np.float32(np.cos(np.radians(tg.ang_max))))
    # the card's sign-exact K2 gives the CPU's exact metric's sign on every
    # cell; only the sun dots, formed by each device's own arithmetic, may
    # fall on the other side of a threshold
    tie = ((dot_ts.abs() <= 1.0e-6) | ((dot_ts - dot_min).abs() <= 1.0e-6))
    n0 = ss.KERNEL_LAUNCHES
    codes = tg.shadow_batch(suns)
    sw = tg.sw_dir_cor_batch(suns)
    assert ss.KERNEL_LAUNCHES == n0 + 2
    assert codes.is_cuda and codes.dtype == torch.uint8 and sw.is_cuda
    codes, sw = codes.cpu(), sw.cpu()
    assert torch.equal(codes[~tie], tc.shadow_batch(suns)[~tie])
    sw_c = tc.sw_dir_cor_batch(suns)
    assert torch.allclose(sw[~tie], sw_c[~tie], rtol=1e-6, atol=1e-5)
    assert torch.equal(tg.shadow(suns[1]).cpu(), codes[1])
    assert tie.float().mean().item() < 0.01


def test_soft_straight_through_on_card(cuda):
    """``sw_dir_cor_soft`` on the card: the straight-through value equals
    the hard ``sw_dir_cor_batch``; its gradient runs K2-argmax and K4 once
    and matches the CPU terrain's (plain versions) within 1e-5 of max |.|
    (K2-argmax records the plain sweep's winners, so the two replay the
    same terms)."""
    z = gaussian_bumps_terrain(96, 160, seed=11, amp=600.0)
    args = _terrain_inputs(z, (16, 16), (64, 128))
    suns = np.array([[1.0e7, 0.0, 1.5e6], [-4.0e6, 8.0e6, 1.5e6],
                     [2.0e6, -1.0e7, 3.0e6]], dtype=np.float32)
    grads = []
    for dev in (cuda, "cpu"):
        t = shadow.Terrain()
        t.initialise(*args, sw_dir_cor_fill=-7.0, device=dev)
        hard = t.sw_dir_cor_batch(suns)
        zg = t._z_outer.clone().requires_grad_(True)
        n0 = ss.ARGMAX_KERNEL_LAUNCHES, replay.SHADOW_KERNEL_LAUNCHES
        soft = t.sw_dir_cor_soft(suns, elevation=zg, soft_tau=8.0)
        assert soft.grad_fn is not None
        assert torch.equal(soft.detach(), hard)
        soft.mean().backward()
        launched = (ss.ARGMAX_KERNEL_LAUNCHES - n0[0],
                    replay.SHADOW_KERNEL_LAUNCHES - n0[1])
        assert launched == ((1, 1) if dev is cuda else (0, 0))
        assert torch.isfinite(zg.grad).all()
        grads.append(zg.grad.cpu())
    scale = grads[1].abs().max().item()
    assert scale > 0.0
    assert (grads[0] - grads[1]).abs().max().item() <= 1e-5 * scale


def test_cuda_terrain_without_kernel_raises(cuda, tmp_path, monkeypatch):
    """No fallback: a CUDA Terrain whose K2 cannot be built raises."""
    z = gaussian_bumps_terrain(48, 160, seed=11, amp=600.0)
    t = shadow.Terrain()
    t.initialise(*_terrain_inputs(z, (8, 16), (32, 128)), device=cuda)
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path / "csrc")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LOADED", {})
    n0 = ss.KERNEL_LAUNCHES
    with pytest.raises(FileNotFoundError, match="horizon_sweep.cu"):
        t.shadow(np.array([1.0e7, 0.0, 1.5e6], np.float32))
    assert ss.KERNEL_LAUNCHES == n0


def _variant_inputs(name):
    """(z, kw, ramp, mask) of a mask / tilt-ramp case: the kernel cases
    above with ramps of a few milliradians and an island mask that leaves
    whole 32 x 8 blocks unlaunched."""
    z, kw = _case(name)
    in0, in1 = kw["inner_shape"]
    rng = np.random.default_rng(2)
    ramp = tuple(rng.uniform(-2e-3, 2e-3, (in0, in1)).astype(np.float32)
                 for _ in range(2))
    yy, xx = np.mgrid[0:in0, 0:in1]
    mask = ((((yy - 0.4 * in0) / (0.3 * in0)) ** 2
             + ((xx - 0.6 * in1) / (0.2 * in1)) ** 2) <= 1.0).astype(np.uint8)
    mask[::7, ::5] = 1                       # scattered cells elsewhere
    return z, kw, ramp, mask


VARIANT_CASES = ["bumps96_d2500", "halo12_dxdy", "spike_d6000",
                 "inner512_d20000"]


@pytest.mark.parametrize("variant", ["tilt", "mask", "tilt_mask"])
@pytest.mark.parametrize("name", VARIANT_CASES)
def test_variant_kernel_matches_plain(cuda, name, variant):
    """K1 and K1-argmax with the tilt ramp, the mask or both: raw ratios,
    ids and D bit-equal to the plain versions'; the ramp moves no id."""
    z, kw, ramp, mask = _variant_inputs(name)
    args = fused_sweep.sweep_args(
        torch.from_numpy(z).to(cuda), **kw,
        tilt_ramp=ramp if "tilt" in variant else None,
        mask=mask if "mask" in variant else None)
    n0 = (fused_sweep.MASK_KERNEL_LAUNCHES, fused_sweep.TILT_KERNEL_LAUNCHES)
    raw = fused_sweep._ratio_cuda(*args)
    a_raw, ids, aux = fused_sweep._ratio_cuda(*args, emit_argmax=True)
    launched = (fused_sweep.MASK_KERNEL_LAUNCHES - n0[0],
                fused_sweep.TILT_KERNEL_LAUNCHES - n0[1])
    assert launched == (2 * ("mask" in variant), 2 * ("tilt" in variant))
    p_raw, p_ids, p_aux = fused_sweep._ratio_plain(*args, emit_argmax=True)
    torch.cuda.synchronize()
    assert torch.equal(raw, a_raw) and torch.equal(raw, p_raw)
    assert torch.equal(ids, p_ids) and torch.equal(aux, p_aux)
    dense = fused_sweep._ratio_cuda(*args[:6], emit_argmax=True)
    keep = torch.ones_like(ids, dtype=torch.bool)
    if "mask" in variant:
        keep = torch.from_numpy(mask != 0).to(cuda).expand_as(ids)
        assert (raw[~keep] == 3.0e38).all()
        assert (ids[~keep] == replay.ID_NONE).all()
        assert (aux[~keep] == 1.0).all()
    assert torch.equal(ids[keep], dense[1][keep])
    assert torch.equal(aux[keep], dense[2][keep])
    if "tilt" not in variant:
        assert torch.equal(raw[keep], dense[0][keep])


def test_unlaunched_blocks_hold_the_masked_values(cuda):
    """A mask whose live cells fill 2 of the 4 x 1 blocks of a 32^2 inner
    domain: the other blocks are never launched and hold what a masked
    cell holds (3e38, ID_NONE, D 1), which K3 then reads as no winner;
    an all-masked mask launches nothing."""
    z, kw = _case("bumps96_d2500")
    zt = torch.from_numpy(z).to(cuda)
    mask = np.zeros((32, 32), np.uint8)
    mask[9, 3] = 1                          # block (1, 0)
    mask[30:, 20:] = 1                      # block (3, 0)
    assert fused_sweep.live_blocks(torch.from_numpy(mask)).tolist() == \
        [[1, 0], [3, 0]]
    args = fused_sweep.sweep_args(zt, mask=mask, **kw)
    n0 = fused_sweep.MASK_KERNEL_LAUNCHES
    raw, ids, aux = fused_sweep._ratio_cuda(*args, emit_argmax=True)
    assert fused_sweep.MASK_KERNEL_LAUNCHES == n0 + 1
    torch.cuda.synchronize()
    keep = torch.from_numpy(mask != 0).to(cuda).expand_as(raw)
    assert (raw[~keep] == 3.0e38).all() and (aux[~keep] == 1.0).all()
    assert (ids[~keep] == replay.ID_NONE).all()
    assert (ids[keep] < replay.ID_NONE).all()
    # the gradient through the mask equals the CPU path's
    grads = []
    for dev in (cuda, "cpu"):
        zg = torch.from_numpy(z).to(dev).requires_grad_(True)
        h = fused_sweep.horizon_sweep_fused(zg, mask=mask, **kw)
        w = torch.from_numpy(mask != 0).to(dev)[..., None]
        torch.mean(torch.where(w, h, 0.0) ** 2).backward()
        grads.append(zg.grad.cpu())
    scale = grads[1].abs().max().item()
    assert scale > 0.0
    assert (grads[0] - grads[1]).abs().max().item() <= 1e-5 * scale
    empty = np.zeros((32, 32), np.uint8)
    n0 = (fused_sweep.KERNEL_LAUNCHES, fused_sweep.MASK_KERNEL_LAUNCHES)
    got = fused_sweep.horizon_sweep_fused(zt, mask=empty, **kw)
    assert (fused_sweep.KERNEL_LAUNCHES,
            fused_sweep.MASK_KERNEL_LAUNCHES) == n0
    assert (got == np.float32(np.radians(-15.0))).all()


def test_masked_gridded_bit_equal_to_dense(cuda):
    """``horizon_gridded`` with a mask on the card: unmasked cells bit-equal
    to the dense run, masked cells the fill, one launch of the variant."""
    n, halo, dx = 352, 96, 25.0
    z = gaussian_bumps_terrain(n, n, seed=8, amp=600.0)
    x1 = np.arange(n, dtype=np.float32) * dx
    x, y = np.meshgrid(x1, x1[::-1].copy())
    inner = n - 2 * halo
    vn = np.zeros((inner, inner, 3), np.float32)
    vn[..., 2] = 1.0
    vno = np.zeros((inner, inner, 3), np.float32)
    vno[..., 1] = 1.0
    vg = auxiliary.rearrange_pad_buffer(x, y, z)
    mask = _variant_inputs("bumps96_d2500")[3]
    mask = np.kron(mask, np.ones((5, 5), np.uint8))[:inner, :inner]
    kw = dict(dist_search=2.0, azim_num=12, verbose=False, hori_fill=-4.0,
              device=cuda)
    dense, _ = horizon.horizon_gridded(vg, n, n, vn, vno, halo, halo, **kw)
    n0 = fused_sweep.MASK_KERNEL_LAUNCHES
    got, _ = horizon.horizon_gridded(vg, n, n, vn, vno, halo, halo,
                                     mask=mask, **kw)
    assert fused_sweep.MASK_KERNEL_LAUNCHES == n0 + 1
    keep = torch.from_numpy(mask == 1).to(cuda)
    assert torch.equal(got[keep], dense[keep])
    assert (got[~keep] == -4.0).all()


def _curved_pipeline_inputs():
    """tests/test_curved.py:187-208's bump on a 100^2 lon/lat grid."""
    n, dlat = 100, 0.002
    lat = 45.0 + (np.arange(n)[::-1] - n / 2) * dlat
    lon = 7.0 + (np.arange(n) - n / 2) * dlat
    lon2, lat2 = np.meshgrid(lon, lat)
    elevation = (500.0 * np.exp(-((lon2 - 7.0) ** 2 + (lat2 - 45.0) ** 2)
                                / (2 * 0.02 ** 2))).astype(np.float32)
    domain = {"lon_min": 6.97, "lon_max": 7.03,
              "lat_min": 44.97, "lat_max": 45.03}
    return lon, lat, elevation, domain


def test_curved_pipeline_on_card(cuda):
    """``CurvedPipeline`` with ``device="cuda"`` against the CPU pipeline
    (the plain versions): the lattice horizon's raw ratios are bit-equal,
    so the horizon agrees to the card's and the CPU's arctan (1e-5 rad),
    SVF within 1e-5; one K1-tilt launch per run, tensors on the card."""
    lon, lat, elevation, domain = _curved_pipeline_inputs()
    outs = []
    for dev in (cuda, "cpu"):
        n0 = fused_sweep.TILT_KERNEL_LAUNCHES
        out = CurvedPipeline(lon, lat, elevation, domain, dist_search=5.0,
                             azim_num=16, ellps="sphere", device=dev).run()
        assert fused_sweep.TILT_KERNEL_LAUNCHES == n0 + (dev is cuda)
        outs.append(out)
    gpu, cpu = outs
    assert all(t.is_cuda for t in gpu.values())
    assert (gpu["hori"].cpu() - cpu["hori"]).abs().max().item() <= TOL
    assert (gpu["svf"].cpu() - cpu["svf"]).abs().max().item() <= 1e-5
    svf = gpu["svf"]
    assert torch.isfinite(svf).all() and (svf > 0.5).all() \
        and (svf <= 1.001).all()
    # the lattice sweep alone: bit-equal raw ratios
    pipe = CurvedPipeline(lon, lat, elevation, domain, dist_search=5.0,
                          azim_num=16, ellps="sphere", device=cuda)
    pipe.build_geometry()
    lat_p = horizon.curved_lattice(pipe.x, pipe.y, pipe.z, pipe.vec_norm,
                                   pipe.offset_0, pipe.offset_1)
    i_lo, i_hi, j_lo, j_hi = lat_p["box"]
    args = fused_sweep.sweep_args(
        torch.from_numpy(lat_p["pg"].z).to(cuda), dx=lat_p["pg"].grid.dx,
        dy=lat_p["pg"].grid.dy, offset=(i_lo, j_lo),
        inner_shape=(i_hi - i_lo, j_hi - j_lo), azim_num=16,
        dist_search=5000.0, tilt_ramp=lat_p["ramp"])
    assert torch.equal(fused_sweep._ratio_cuda(*args),
                       fused_sweep._ratio_plain(*args))


def test_tilt_gradient_on_card(cuda):
    """The z and ramp gradients through K1-argmax with the ramp and the
    mask, then K3, against the CPU path's within 1e-5 of max |.|."""
    z, kw, ramp, mask = _variant_inputs("halo12_dxdy")
    grads = []
    for dev in (cuda, "cpu"):
        zg = torch.from_numpy(z).to(dev).requires_grad_(True)
        ra, rb = (torch.from_numpy(r).to(dev).requires_grad_(True)
                  for r in ramp)
        h = fused_sweep.horizon_sweep_fused(zg, tilt_ramp=(ra, rb),
                                            mask=mask, **kw)
        w = torch.from_numpy(mask != 0).to(dev)[..., None]
        g = torch.autograd.grad(torch.mean(torch.where(w, h, 0.0) ** 2),
                                (zg, ra, rb))
        grads.append([t.cpu() for t in g])
    for got, want in zip(*grads):
        scale = want.abs().max().item()
        assert scale > 0.0 and torch.isfinite(got).all()
        assert (got - want).abs().max().item() <= 1e-5 * scale


# ---------------------------------------------------------------------------
# K5, the read floor
# ---------------------------------------------------------------------------

def _floor_window(seed=0, shape=(176, 256)):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=shape).astype(np.float32))


@pytest.mark.parametrize("mode,source", read_floor.MEASURED)
def test_read_floor_kernel_bit_equal_to_plain(cuda, mode, source):
    win = _floor_window()
    trig = read_floor.first_quadrant_trig(6)
    # ragged cells: the last blocks are partly past the edge
    kw = dict(cells=(21, 75), n_steps=41, offset=(8, 32), source=source,
              chunk=9)
    n0 = read_floor.KERNEL_LAUNCHES
    got = read_floor.read_floor(win.to(cuda), trig, mode, **kw)
    assert read_floor.KERNEL_LAUNCHES == n0 + 1
    want = read_floor.read_floor(win, trig, mode, **kw)
    assert read_floor.KERNEL_LAUNCHES == n0 + 1     # the CPU ran the plain one
    torch.cuda.synchronize()
    assert got.is_cuda and got.dtype == torch.float32
    assert tuple(got.shape) == (6, 21, 75)
    assert torch.equal(got.cpu(), want)


def test_read_floor_large_strip_and_limits(cuda):
    """A strip above 48 KB needs the kernel's raised limit; one above what
    a block can have is refused before the launch."""
    win = _floor_window(1, (512, 512)).to(cuda)
    trig = read_floor.first_quadrant_trig(4)
    kw = dict(cells=(64, 64), n_steps=150, offset=(0, 0))
    rows, ld = read_floor.strip_layout("bilinear", trig, 150, 150)
    assert 48 * 1024 < rows * ld * 4 <= read_floor.MAX_SMEM_BYTES
    got = read_floor.read_floor(win, trig, "bilinear", source="smem",
                                chunk=150, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, read_floor.read_floor(win, trig, "bilinear",
                                                  **kw))
    big = _floor_window(2, (640, 640)).to(cuda)
    with pytest.raises(ValueError, match="shorten the chunk"):
        read_floor.read_floor(big, trig, "bilinear", source="smem",
                              cells=(64, 64), n_steps=246, chunk=246,
                              offset=(0, 0))
    with pytest.raises(ValueError, match="too small"):
        read_floor.read_floor(win, trig, "nearest", cells=(64, 64),
                              n_steps=500, offset=(0, 0))


def test_read_floor_time_modes_on_card(cuda):
    win = _floor_window(3, (256, 256)).to(cuda)
    n0 = read_floor.KERNEL_LAUNCHES
    rows = read_floor.time_modes(win, cells=(64, 64), a_num=4, n_steps=40,
                                 chunk=8, iters=2)
    assert read_floor.KERNEL_LAUNCHES == n0 + 3 * len(read_floor.MEASURED)
    assert [(r["mode"], r["source"]) for r in rows] == list(
        read_floor.MEASURED)
    assert all(r["ms"] > 0.0 and r["gsamples_per_s"] > 0.0 for r in rows)
    assert "tb_per_s" in rows[7] and "tops_per_s" in rows[8]
    assert all(isinstance(read_floor.format_row(r), str) for r in rows)


# ---------------------------------------------------------------------------
# Multires: the combined fine + coarse pyramid
# ---------------------------------------------------------------------------

def _multires_case():
    """tests/test_multires.py:46-82's scene with the isolated far ridge of
    :191-259 on the coarse grid."""
    dx, dist, inner, halo_fine = 25.0, 4000.0, 32, 96
    halo_full = int(dist / dx) + 16
    n_full = inner + 2 * halo_full
    full = gaussian_bumps_terrain(n_full, n_full, seed=9, amp=500.0)
    i0 = halo_full - halo_fine
    z_fine = np.ascontiguousarray(full[i0:i0 + inner + 2 * halo_fine,
                                       i0:i0 + inner + 2 * halo_fine])
    h = n_full - n_full % 4
    z_coarse = full[:h, :h].reshape(h // 4, 4, h // 4, 4).max(axis=(1, 3))
    z_coarse[(halo_full - 120) // 4,
             (halo_full - 16) // 4:(halo_full + 48) // 4] += 900.0
    kw = dict(ratio_log2=2, coarse_offset=(i0, i0), dx=dx, dy=-dx,
              offset=(halo_fine, halo_fine), inner_shape=(inner, inner),
              dist_search=dist, hori_acc=2.0, azim_num=8)
    return z_fine, z_coarse, kw


def test_multires_kernel_matches_plain(cuda):
    z_fine, z_coarse, kw = _multires_case()
    zf, zc = torch.from_numpy(z_fine), torch.from_numpy(z_coarse)
    n0 = fused_sweep.KERNEL_LAUNCHES
    got = multires.horizon_sweep_multires_fused(zf.to(cuda), zc.to(cuda),
                                                **kw)
    assert fused_sweep.KERNEL_LAUNCHES == n0 + 1
    want = multires.horizon_sweep_multires_fused(zf, zc, **kw)
    torch.cuda.synchronize()
    # raw ratios are bit-equal (chip_smoke.py phase K); the card's arctan
    # may differ from the CPU's by an ulp
    assert got.is_cuda and (got.cpu() - want).abs().max().item() <= TOL
    mask = np.zeros(kw["inner_shape"], dtype=np.uint8)
    mask[3:20, 5:28] = 1
    got_m = multires.horizon_sweep_multires_fused(
        zf.to(cuda), zc.to(cuda), mask=mask, **kw)
    keep = torch.from_numpy(mask == 1)
    assert torch.equal(got_m[keep.to(cuda)], got[keep.to(cuda)])


def test_multires_gradients_on_card(cuda):
    z_fine, z_coarse, kw = _multires_case()
    grads = []
    n_am, n_k3 = fused_sweep.ARGMAX_KERNEL_LAUNCHES, replay.KERNEL_LAUNCHES
    for dev in (cuda, "cpu"):
        tf = torch.from_numpy(z_fine).to(dev).requires_grad_(True)
        tc = torch.from_numpy(z_coarse).to(dev).requires_grad_(True)
        h = multires.horizon_sweep_multires_fused(tf, tc, **kw)
        grads.append([g.cpu() for g in torch.autograd.grad(
            torch.mean(h ** 2), (tf, tc))])
    assert fused_sweep.ARGMAX_KERNEL_LAUNCHES == n_am + 1
    assert replay.KERNEL_LAUNCHES == n_k3 + 1
    for got, want in zip(*grads):
        scale = want.abs().max().item()
        assert scale > 0.0 and torch.isfinite(got).all()
        assert (got - want).abs().max().item() <= 1e-5 * scale


def test_tin_route_on_card(cuda):
    """``horizon_gridded(vert_simp=...)`` on the card against the CPU."""
    dx, inner, halo_fine, r = 25.0, 16, 48, 4
    halo_full = int(2000.0 / dx) + 16
    n_full = inner + 2 * halo_full
    full = gaussian_bumps_terrain(n_full, n_full, seed=13, amp=600.0)
    i0 = halo_full - halo_fine
    n_fine = inner + 2 * halo_fine
    h = n_full - n_full % r
    pooled = full[:h, :h].reshape(h // r, r, h // r, r).max(axis=(1, 3))
    nc = pooled.shape[0]
    xa = np.arange(n_full, dtype=np.float64) * dx
    xv, yv = np.meshgrid(xa[:nc * r:r] - i0 * dx, -xa[:nc * r:r] + i0 * dx)
    verts = np.stack([xv, yv, pooled.astype(np.float64)],
                     axis=-1).reshape(-1, 3).astype(np.float32)
    jj, ii = np.meshgrid(np.arange(nc - 1), np.arange(nc - 1))
    a = (ii * nc + jj).ravel()
    tris = np.concatenate([
        np.stack([a, a + 1, a + nc], -1),
        np.stack([a + 1, a + nc + 1, a + nc], -1)]).astype(np.int32).ravel()
    x2, y2 = np.meshgrid(xa[:n_fine], -xa[:n_fine])
    vg = auxiliary.rearrange_pad_buffer(
        x2.astype(np.float32), y2.astype(np.float32),
        np.ascontiguousarray(full[i0:i0 + n_fine, i0:i0 + n_fine]))
    vec_norm = np.zeros((inner, inner, 3), np.float32)
    vec_norm[..., 2] = 1.0
    vec_north = np.zeros((inner, inner, 3), np.float32)
    vec_north[..., 1] = 1.0
    out = [horizon.horizon_gridded(
        vg, n_fine, n_fine, vec_norm, vec_north, halo_fine, halo_fine, 2.0,
        azim_num=8, hori_acc=2.0, verbose=False, device=dev,
        vert_simp=verts.ravel(), num_vert_simp=len(verts),
        tri_ind_simp=tris, num_tri_simp=len(tris) // 3)[0]
        for dev in (cuda, "cpu")]
    assert out[0].is_cuda
    assert (out[0].cpu() - out[1]).abs().max().item() <= TOL


def _model_counts(args, emit_argmax):
    """The (4,) counters of a K1 launch on ``args`` as the plain model of
    its skip test (``fused_sweep.warp_skip_plain``) decides them, and the
    plain sweep that skips where the model does."""
    z_org, z_inner, levels, trig, plan, outer = [
        a.cpu() if isinstance(a, torch.Tensor) else a for a in args[:6]]
    levels = [t.cpu() for t in levels]
    mask = None if args[7] is None else args[7].cpu()
    pooled, pool_min0 = fused_sweep.skip_inputs(levels, plan)
    swept = (torch.ones_like(z_org, dtype=torch.bool) if mask is None
             else mask != 0)
    counts = [0, 0, 0, 0]
    phase_skip = {}

    def hook(ev):
        if "cand_max" in ev or ev.get("masked"):
            return None     # K1 runs its masked d1 pairs without a test
        _, skip = fused_sweep.warp_skip_plain(ev, pooled, pool_min0, plan,
                                                  z_org)
        n, kind = ev["n"], ev["kind"]
        if kind == "d1":
            counts[0] += n * int((swept & ~skip).sum())
            counts[1] += n * int((swept & skip).sum())
        elif kind == "mip_phase":
            # a phase that runs is counted by its chunks, unless it is one
            phase_skip[ev["row"]] = skip
            counts[3] += n * int((swept & skip).sum())
            if n <= fused_sweep.MIP_CHUNK:
                counts[2] += n * int((swept & ~skip).sum())
        else:
            live = swept & ~phase_skip[ev["row"]]
            counts[2] += n * int((live & ~skip).sum())
            counts[3] += n * int((live & skip).sum())
        return skip

    init = None
    if mask is not None:
        init = torch.where(mask != 0, -3.0e38, 3.0e38).to(torch.float32)
    fused_sweep.sweep_plain(z_inner, levels, plan, outer, trig.shape[0],
                            fused_sweep._horizon_rows(z_org, trig, plan),
                            emit_argmax, init, chunk_hook=hook)
    return counts


def _skip_args(cuda, name, variant):
    """``sweep_args`` of a skip scene on the card, with the variant's
    ramps (a few milliradians) and, where the scene has none, a mask."""
    z, kw, mask = skip_scene(name)
    in0, in1 = kw["inner_shape"]
    rng = np.random.default_rng(4)
    ramp = None
    if "tilt" in variant:
        ramp = tuple(rng.uniform(-2e-3, 2e-3, (in0, in1)).astype(np.float32)
                     for _ in range(2))
    if "mask" in variant and mask is None:
        mask = (rng.uniform(size=(in0, in1)) < 0.3).astype(np.uint8)
        mask[:, 40:] = 0
    elif "mask" not in variant:
        mask = None
    return fused_sweep.sweep_args(torch.from_numpy(z).to(cuda),
                                  tilt_ramp=ramp, mask=mask, **kw)


@pytest.mark.parametrize("variant", ["plain", "mask", "tilt", "tilt_mask"])
@pytest.mark.parametrize("name", SKIP_SCENES)
def test_skip_scenes_bit_equal_and_counted(cuda, name, variant):
    args = _skip_args(cuda, name, variant)
    counters = torch.zeros(4, dtype=torch.int64, device=cuda)
    raw = fused_sweep._ratio_cuda(*args, counters=counters)
    a_raw, ids, aux = fused_sweep._ratio_cuda(*args, emit_argmax=True)
    p_raw, p_ids, p_aux = fused_sweep._ratio_plain(*args, emit_argmax=True)
    torch.cuda.synchronize()
    assert torch.equal(raw, p_raw) and torch.equal(a_raw, p_raw)
    assert torch.equal(ids, p_ids) and torch.equal(aux, p_aux)
    got = counters.tolist()
    assert got == _model_counts(args, False)
    if name == "flat_pit":
        assert got[2] == 0 and got[3] > 0      # every mip sample skipped
    if name.startswith("spike") and variant == "plain":
        assert got[2] > 0


def test_spike_azimuth_skips_nothing_on_its_side(cuda):
    """Toward the far spike (azimuth 0, north) the warp whose strip holds
    it runs every chunk that reaches it: its mip samples are taken."""
    args = _skip_args(cuda, "spike_inside", "plain")
    north = args[:3] + (args[3][:1],) + args[4:]
    counters = torch.zeros(4, dtype=torch.int64, device=cuda)
    raw, ids, _ = fused_sweep._ratio_cuda(*north, emit_argmax=True,
                                          counters=counters)
    p_raw, p_ids, _ = fused_sweep._ratio_plain(*north, emit_argmax=True)
    assert torch.equal(raw, p_raw) and torch.equal(ids, p_ids)
    n2 = 2 * north[4]["n_dense"]
    # the spike's column (last of the first warp) wins through a mip read
    assert bool((ids[0, :, 31] >= n2).all())
    assert counters.tolist() == _model_counts(north, True)
    assert counters[2].item() > 0


def test_multires_crop_bit_equal_with_skips(cuda):
    z_fine, z_coarse, kw = _multires_case()
    geo = {k: kw[k] for k in ("dx", "dy", "offset", "inner_shape",
                              "dist_search", "hori_acc")}
    zf = torch.from_numpy(z_fine).to(cuda)
    levels = multires.multires_levels(
        zf, torch.from_numpy(z_coarse).to(cuda), ratio_log2=kw["ratio_log2"],
        coarse_offset=kw["coarse_offset"], **geo)
    for mask in (None, np.eye(*kw["inner_shape"], dtype=np.uint8)):
        args = fused_sweep.sweep_args(zf, pyramid=levels, mask=mask,
                                      azim_num=kw["azim_num"], **geo)
        counters = torch.zeros(4, dtype=torch.int64, device=cuda)
        raw = fused_sweep._ratio_cuda(*args, counters=counters)
        a_raw, ids, aux = fused_sweep._ratio_cuda(*args, emit_argmax=True)
        p_raw, p_ids, p_aux = fused_sweep._ratio_plain(*args,
                                                       emit_argmax=True)
        torch.cuda.synchronize()
        assert torch.equal(raw, p_raw) and torch.equal(a_raw, p_raw)
        assert torch.equal(ids, p_ids) and torch.equal(aux, p_aux)
        assert counters.tolist() == _model_counts(args, False)


@pytest.mark.parametrize("name", ["random", "plateau"])
def test_shadow_kernels_bit_equal_on_skip_scenes(cuda, name):
    """K2 and K2-argmax with the step table, the shifts, the 32-bit offsets
    and their value-exact skips: bit-equal to their plain versions."""
    z, kw, _ = skip_scene(name)
    zt = torch.from_numpy(z).to(cuda)
    (o0, o1), (in0, in1) = kw["offset"], kw["inner_shape"]
    z_in = zt[o0:o0 + in0, o1:o1 + in1].contiguous()
    h, w = z.shape
    c = (0.5 * (w - 1) * 25.0, -0.5 * (h - 1) * 25.0)
    suns = np.array([[c[0] + 2.0e5, c[1] + 1.0e5, 1.5e4],
                     [c[0] - 1.0e5, c[1] + 2.0e5, 0.8e4]], np.float32)
    table, _ = ss.shadow_sun_table(suns, c, 25.0, -25.0)
    args = ss.metric_args(zt, z_in + float(np.float32(0.05)), z_in, table,
                          offset=kw["offset"], inner_shape=kw["inner_shape"],
                          dx=25.0, dy=-25.0)
    for emit in (False, True):
        got = ss._metric_cuda(*args, grid_origin=(0.0, 0.0),
                              emit_argmax=emit)
        ref = ss._metric_plain(*args, grid_origin=(0.0, 0.0),
                               emit_argmax=emit)
        torch.cuda.synchronize()
        for g, r in zip(got if emit else (got,), ref if emit else (ref,)):
            assert torch.equal(g, r)


def _shadow_skip_args(dev, name):
    """``metric_args`` of a shadow skip scene on ``dev`` (grid origin
    (0, 0))."""
    z, off, inner, dx, dy, rel = shadow_skip_scene(name)
    zt = torch.from_numpy(z).to(dev)
    h, w = z.shape
    c = (0.5 * (w - 1) * dx, 0.5 * (h - 1) * dy)
    suns = np.array([[c[0] + a, c[1] + b, cc] for a, b, cc in rel],
                    np.float32)
    table, _ = ss.shadow_sun_table(suns, c, dx, dy)
    z_in = zt[off[0]:off[0] + inner[0], off[1]:off[1] + inner[1]]
    return ss.metric_args(zt, z_in + float(np.float32(0.05)), z_in, table,
                          offset=off, inner_shape=inner, dx=dx, dy=dy)


def _shadow_model(name, exact_metric):
    """``shadow_sweep.metric_model`` on the CPU: (metric, the kernel's four
    counters as the model counts them)."""
    res, counts = ss.metric_model(*_shadow_skip_args("cpu", name),
                                  grid_origin=(0.0, 0.0),
                                  exact_metric=exact_metric)
    return res, [counts[f] for f in fused_sweep.COUNTER_FIELDS]


@pytest.mark.parametrize("name", SHADOW_SKIP_SCENES)
def test_shadow_skip_scenes_bit_equal_and_counted(cuda, name):
    """K2 and K2-argmax with their value-exact skips (the masked d1 pairs'
    too): bit-equal to the plain versions, and each launch's counters equal
    to the plain model's, sample for sample."""
    args = _shadow_skip_args(cuda, name)
    counters = torch.zeros(4, dtype=torch.int64, device=cuda)
    met = ss._metric_cuda(*args, grid_origin=(0.0, 0.0), counters=counters)
    a_counters = torch.zeros(4, dtype=torch.int64, device=cuda)
    a_met, ids, aux = ss._metric_cuda(*args, grid_origin=(0.0, 0.0),
                                      emit_argmax=True, counters=a_counters)
    p_met, p_ids, p_aux = ss._metric_plain(*args, grid_origin=(0.0, 0.0),
                                           emit_argmax=True)
    torch.cuda.synchronize()
    assert torch.equal(met, p_met) and torch.equal(a_met, p_met)
    assert torch.equal(ids, p_ids) and torch.equal(aux, p_aux)
    want = _shadow_model(name, True)[1]
    assert counters.tolist() == want and a_counters.tolist() == want
    assert want[1] + want[3] > 0


@pytest.mark.parametrize("name", SHADOW_SKIP_SCENES)
def test_sign_exact_k2_matches_its_model(cuda, name):
    """K2 with its sign-exact arm: bit-equal to the plain sweep that skips
    where the model's sign-exact votes do, the same counters, the exact
    metric's sign and at most its value."""
    args = _shadow_skip_args(cuda, name)
    counters = torch.zeros(4, dtype=torch.int64, device=cuda)
    got = ss._metric_cuda(*args, grid_origin=(0.0, 0.0), exact_metric=False,
                          counters=counters)
    exact = ss._metric_plain(*args, grid_origin=(0.0, 0.0))
    model, want = _shadow_model(name, False)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), model)
    assert counters.tolist() == want
    assert torch.equal(got > 0.0, exact > 0.0)
    assert bool((got <= exact).all())


def test_sign_exact_argmax_raises(cuda):
    args = _shadow_skip_args(cuda, "flat_pit")
    with pytest.raises(ValueError, match="exact_metric=True"):
        ss._metric_cuda(*args, grid_origin=(0.0, 0.0), emit_argmax=True,
                        exact_metric=False)


# ---------------------------------------------------------------------------
# Curved Terrain and horizon_locations
# ---------------------------------------------------------------------------

def _curved_terrains(dev):
    """The same curved Terrain (tests/test_torch_curved_shadow.py's south
    scene, refraction on) on ``dev`` and on the CPU, and its suns."""
    s = curved_setup(bumps(9, count=10, amp=(200.0, 900.0)), n=160,
                     lat0=-54.35, lon0=-36.3)
    inp = curved_terrain_inputs(s, (60, 12), (40, 64))
    out = []
    for d in (dev, "cpu"):
        t = shadow.Terrain()
        t.initialise(inp["vert_grid"], 160, 160, 60, 12, inp["vec_tilt"],
                     inp["vec_norm"], inp["surf_enl_fac"], inp["elevation"],
                     inp["mask"], refrac_cor=True, device=d)
        out.append(t)
    suns = np.array([[1.0e7, 0.0, 1.5e6], [-4.0e6, 8.0e6, 1.0e6],
                     [2.0e6, -1.0e7, 3.0e6], [0.0, 1.0e7, -1.0e5]],
                    dtype=np.float32)
    return out, suns


def test_curved_terrain_on_card_matches_cpu(cuda):
    (tg, tc), suns = _curved_terrains(cuda)
    assert tg.comp_shape == tc.comp_shape and tg._back[2].is_cuda
    _, dot_ts = shadow.sun_dots(tc._fields, suns, True)
    dot_min = float(np.float32(np.cos(np.radians(tg.ang_max))))
    tie = ((dot_ts.abs() <= 1.0e-6) | ((dot_ts - dot_min).abs() <= 1.0e-6))
    n0 = ss.KERNEL_LAUNCHES
    codes = tg.shadow_batch(suns)
    sw = tg.sw_dir_cor_batch(suns)
    assert ss.KERNEL_LAUNCHES == n0 + 2
    assert codes.is_cuda and sw.is_cuda
    assert tuple(codes.shape) == (4, 40, 64)
    codes, sw = codes.cpu(), sw.cpu()
    assert torch.equal(codes[~tie], tc.shadow_batch(suns)[~tie])
    assert torch.allclose(sw[~tie], tc.sw_dir_cor_batch(suns)[~tie],
                          rtol=1e-6, atol=1e-5)
    assert tie.float().mean().item() < 0.01
    assert (codes == 2).any() and (codes == 0).any()


def test_curved_soft_gradient_on_card(cuda):
    (tg, tc), suns = _curved_terrains(cuda)
    w = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (4, 40, 64)).astype(np.float32))

    def grad(t):
        z = t._z_outer.clone().requires_grad_(True)
        out = t.sw_dir_cor_soft(suns, elevation=z, soft_tau=8.0)
        torch.sum(out * w.to(z.device)).backward()
        return out.detach(), z.grad

    n0 = ss.ARGMAX_KERNEL_LAUNCHES
    (out, g1), (_, g2) = grad(tg), grad(tg)
    assert ss.ARGMAX_KERNEL_LAUNCHES == n0 + 2
    assert torch.equal(g1, g2)
    assert torch.equal(out, tg.sw_dir_cor_batch(suns))
    _, gc = grad(tc)
    scale = gc.abs().max().item()
    assert scale > 0.0
    assert (g1.cpu() - gc).abs().max().item() <= 1e-5 * scale


def test_horizon_locations_on_card_matches_cpu(cuda):
    """Curved mesh, 300 locations drawn in its interior, 72 azimuths."""
    s = curved_setup(bumps(4), n=160)
    rng = np.random.default_rng(0)
    ii, jj = rng.integers(40, 120, 300), rng.integers(40, 120, 300)
    coords = np.stack([s["x"][ii, jj], s["y"][ii, jj], s["z"][ii, jj]],
                      axis=-1).astype(np.float32)
    args = (auxiliary.rearrange_pad_buffer(s["x"], s["y"], s["z"]), 160,
            160, coords, s["vec_norm"][ii, jj], s["vec_north"][ii, jj])
    kw = dict(dist_search=6.0, azim_num=72, hori_dist_out=True)
    hg, dg, ag = horizon.horizon_locations(*args, device=cuda, **kw)
    hc, dc, ac = horizon.horizon_locations(*args, device="cpu", **kw)
    assert hg.is_cuda and dg.is_cuda and ag.is_cuda
    assert tuple(hg.shape) == (300, 72)
    assert (hg.cpu() - hc).abs().max().item() <= 1e-6
    assert torch.allclose(dg.cpu(), dc, rtol=1e-6, atol=0.0)
    assert torch.equal(ag.cpu(), ac)


def _mask_scene(dev):
    """(shadow_metric_fused arguments, mask) of the K2-mask tests: a
    100 x 200 block (partial edge blocks) at (60, 60) of 256 x 320 bumps,
    three suns, an island and two scattered cells, leaving whole 32 x 8
    blocks unlaunched."""
    z = gaussian_bumps_terrain(256, 320, seed=4, amp=500.0)
    off, inner = (60, 60), (100, 200)
    cx, cy = 0.5 * 319 * 25.0, -0.5 * 255 * 25.0
    suns = np.array([[cx + 2.0e5, cy + 1.0e5, 2.0e4],
                     [cx - 1.5e5, cy - 0.5e5, 1.2e4],
                     [cx + 0.3e5, cy - 2.0e5, 3.0e4]], np.float32)
    table, _ = ss.shadow_sun_table(suns, (cx, cy), 25.0, -25.0)
    zt = torch.from_numpy(z).to(dev)
    z_in = zt[60:160, 60:260].contiguous()
    mask = np.zeros(inner, np.uint8)
    mask[10:40, 20:90] = 1
    mask[71, 150] = 1
    mask[99, 199] = 1
    kw = dict(offset=off, inner_shape=inner, dx=25.0, dy=-25.0,
              grid_origin=(0.0, 0.0))
    return (zt, z_in + float(np.float32(0.05)), z_in, table), kw, \
        torch.from_numpy(mask).to(dev)


@pytest.mark.parametrize("exact", [True, False])
def test_k2_mask_bit_equal_to_dense_and_plain(cuda, exact):
    """K2-mask launches only the live blocks: on their cells it is
    bit-equal to the dense K2 in the same mode (the warps take the same
    skips), the exact arm also to its plain version on every cell; the
    blocks it does not launch hold -3e38; an all-masked mask launches
    nothing."""
    args, kw, mask = _mask_scene(cuda)
    dense = ss.shadow_metric_fused(*args, exact_metric=exact, **kw)
    n0, m0 = ss.KERNEL_LAUNCHES, ss.MASK_KERNEL_LAUNCHES
    got = ss.shadow_metric_fused(*args, exact_metric=exact, mask=mask, **kw)
    assert (ss.KERNEL_LAUNCHES - n0, ss.MASK_KERNEL_LAUNCHES - m0) == (1, 1)
    live = ss.live_cells(mask)
    assert 0 < int(live.sum()) < live.numel()
    assert torch.equal(got[:, live], dense[:, live])
    assert bool(torch.all(got[:, ~live] == np.float32(-3.0e38)))
    if exact:
        plain = ss.shadow_metric_plain(*args, mask=mask, **kw)
        assert torch.equal(got, plain)
    assert (got[:, mask != 0] > 0).any() and (got[:, mask != 0] <= 0).any()
    none = ss.shadow_metric_fused(*args, exact_metric=exact,
                                  mask=torch.zeros_like(mask), **kw)
    assert ss.MASK_KERNEL_LAUNCHES - m0 == 1
    assert bool(torch.all(none == np.float32(-3.0e38)))


def test_refraction_divides_once_on_card(cuda):
    """The refraction's divisions on the card bit-equal to NumPy's
    float32 division on the same 200,000 inputs (the card's own tan and
    power on both sides): tensor over tensor, never a product with a
    reciprocal."""
    rng = np.random.default_rng(20)
    n = 200_000
    elev = rng.uniform(-2.0, 91.0, n).astype(np.float32)
    temp = rng.uniform(-30.0, 30.0, n).astype(np.float32)
    pres = rng.uniform(50.0, 105.0, n).astype(np.float32)
    height = rng.uniform(-100.0, 4800.0, n).astype(np.float32)

    def fn(name, x):
        t = torch.from_numpy(x).to(cuda)
        out = torch.tan(t) if name == "tan" else t ** refraction.BAROMETRIC_EXP
        return out.cpu().numpy()

    want = refraction_numpy(elev, temp, pres, height, fn)
    got = refraction.atmos_refrac(*(torch.from_numpy(a).to(cuda)
                                    for a in (elev, temp, pres)))
    assert got.is_cuda
    np.testing.assert_array_equal(got.cpu().numpy(), want[0])
    t, p = refraction.reference_atmosphere(torch.from_numpy(height).to(cuda))
    np.testing.assert_array_equal(t.cpu().numpy(), want[1])
    np.testing.assert_array_equal(p.cpu().numpy(), want[2])


def test_card_glue_divides_like_the_cpu(cuda):
    """The glue around the kernels divides on the card as on the CPU
    (``metric / soft_tau``, the refraction, ``azim_spac / (2 pi)``): with
    ``soft_tau = 0.3`` and refraction, the card's ``sw_dir_cor`` within
    1e-5 plus 1e-6 relative of the CPU's outside the sun-dot thresholds,
    its soft gradient within 1e-5 of max|g|, and SVF and VSF at 7
    azimuths within 1e-6.  Left to differ: the card's float32 tan,
    arccos, sin, cos, power and sigmoid against the CPU's (an ulp each),
    and the order of the sums over azimuths."""
    z = gaussian_bumps_terrain(96, 160, seed=11, amp=600.0)
    args = _terrain_inputs(z, (16, 16), (64, 128))
    suns = np.array([[1.0e7, 0.0, 1.5e6], [-4.0e6, 8.0e6, 1.5e6],
                     [2.0e6, -1.0e7, 3.0e6]], dtype=np.float32)
    res = []
    for dev in (cuda, "cpu"):
        t = shadow.Terrain()
        t.initialise(*args, sw_dir_cor_fill=-7.0, refrac_cor=True,
                     device=dev)
        zg = t._z_outer.clone().requires_grad_(True)
        soft = t.sw_dir_cor_soft(suns, elevation=zg, soft_tau=0.3)
        soft.mean().backward()
        res.append((t, t.sw_dir_cor_batch(suns).cpu(), zg.grad.cpu()))
    (tg, sw_g, g_g), (tc, sw_c, g_c) = res
    _, dot_ts = shadow.sun_dots(tc._fields, suns, True)
    dot_min = float(np.float32(np.cos(np.radians(tg.ang_max))))
    tie = ((dot_ts.abs() <= 1.0e-6) | ((dot_ts - dot_min).abs() <= 1.0e-6))
    assert tie.float().mean().item() < 0.01
    assert torch.allclose(sw_g[~tie], sw_c[~tie], rtol=1e-6, atol=1e-5)
    assert torch.equal(torch.isnan(g_g), torch.isnan(g_c))
    ok = ~torch.isnan(g_c)
    scale = g_c[ok].abs().max().item()
    assert scale > 0.0
    assert (g_g[ok] - g_c[ok]).abs().max().item() <= 1e-5 * scale
    azim = horizon.azimuth_angles(7)
    hori = np.random.default_rng(3).uniform(-0.2, 0.6, (40, 52, 7)) \
        .astype(np.float32)
    vt = np.ascontiguousarray(args[5][:40, :52])
    for fn in (topo_param.sky_view_factor, topo_param.visible_sky_fraction):
        on_card = fn(torch.from_numpy(azim).to(cuda),
                     torch.from_numpy(hori).to(cuda),
                     torch.from_numpy(vt).to(cuda))
        assert on_card.is_cuda
        assert (on_card.cpu() - fn(azim, hori, vt)).abs().max().item() \
            <= 1e-6


def test_xla_engines_on_card_match_cpu(cuda):
    """The XLA engines in plain torch on the card: the general-basis
    sweep's raw ratios and distances bit-equal to the CPU's (the same
    float32 operations, a correctly rounded divide and square root; the
    arctan may differ by an ulp), the multires engine's angles within 2
    ulp, and ``Terrain(engine="sweep"/"scan")``'s metric bit-equal, codes
    equal and ``sw_dir_cor`` equal."""
    z = gaussian_bumps_terrain(128, 128, seed=11, amp=400.0)
    r = 6.371e6 / 30.0
    xs = (np.arange(128) - 64) * 25.0
    xx, yy = np.meshgrid(xs, -xs)
    norm = np.stack([-xx / r, -yy / r, np.ones_like(xx)], axis=-1)
    norm /= np.linalg.norm(norm, axis=-1, keepdims=True)
    north = np.stack([np.zeros_like(xx), np.ones_like(xx), yy / r], axis=-1)
    north -= np.sum(north * norm, axis=-1, keepdims=True) * norm
    north /= np.linalg.norm(north, axis=-1, keepdims=True)
    sl = (slice(32, 96), slice(32, 96))
    n32, e32 = norm[sl].astype(np.float32), north[sl].astype(np.float32)
    azim = horizon.azimuth_angles(7)
    kw = dict(dx=25.0, dy=-25.0, offset=(32, 32), inner_shape=(64, 64),
              azim=azim, dist_search=3000.0, hori_acc=2.0,
              geom=terrain.basis_fields(n32, e32),
              u_xy=terrain.mean_marching_directions(azim, n32, e32),
              track_dist=True)
    (hg, dg), (hc, dc) = (sweep.horizon_sweep(torch.from_numpy(z).to(d),
                                              **kw) for d in (cuda, "cpu"))
    assert hg.is_cuda and (hg.cpu() - hc).abs().max().item() <= 2.4e-7
    assert torch.equal(dg.cpu(), dc)
    full = gaussian_bumps_terrain(384, 384, seed=9, amp=500.0)
    zc = full.reshape(96, 4, 96, 4).max(axis=(1, 3))
    mkw = dict(ratio_log2=2, coarse_offset=(80, 80), dx=25.0, dy=-25.0,
               offset=(96, 96), inner_shape=(32, 32), azim=azim,
               dist_search=4000.0, hori_acc=2.0)
    mg, mc = (multires.horizon_sweep_multires(
        torch.from_numpy(full[80:304, 80:304].copy()).to(d),
        torch.from_numpy(zc).to(d), **mkw) for d in (cuda, "cpu"))
    assert (mg.cpu() - mc).abs().max().item() <= 2.4e-7
    args = _terrain_inputs(gaussian_bumps_terrain(96, 160, seed=11,
                                                  amp=600.0),
                           (16, 16), (64, 128))
    suns = np.array([[1.0e7, 0.0, 1.5e6], [-4.0e6, 8.0e6, 1.5e6],
                     [2.0e6, -1.0e7, 3.0e6]], dtype=np.float32)
    for engine in ("sweep", "scan"):
        out = []
        for dev in (cuda, "cpu"):
            t = shadow.Terrain()
            t.initialise(*args, engine=engine, device=dev)
            f = t._fields
            met, _ = t._xla_metric(suns, f["z_org_r"], f["z_inner_r"],
                                   t._levels, scan=engine == "scan")
            out.append((met.cpu(), t.shadow_batch(suns).cpu(),
                        t.sw_dir_cor_batch(suns).cpu()))
        (mg, cg, sg), (mc, cc, sc) = out
        assert torch.equal(mg, mc), engine
        assert torch.equal(cg, cc), engine
        assert torch.allclose(sg, sc, rtol=1e-6, atol=1e-5, equal_nan=True)
        assert (cg == 2).any()


# ---------------------------------------------------------------------------
# The shard variants (horayzon_tpu_torch.parallel): the shards of a mesh run
# in turn on one card, on tests/test_torch_sharding.py's scenes
# ---------------------------------------------------------------------------

def _slot_mesh(dev, n_tile, n_azim):
    return parallel.make_mesh(n_tile, n_azim,
                              devices=[torch.device(dev)] * (n_tile * n_azim))


def _records(fwd, records, like):
    """The shards' (ids, aux) laid out by rows and azimuths."""
    ids, aux = torch.empty_like(like[1]), torch.empty_like(like[2])
    for t, a, i, d in records:
        sl = (slice(a * fwd.az_loc, (a + 1) * fwd.az_loc),
              slice(t * fwd.rows, (t + 1) * fwd.rows))
        ids[sl], aux[sl] = i, d
    return ids, aux


@pytest.mark.parametrize("n_tile,n_azim", SHARD_MESHES)
def test_k1_shard_variants_bit_equal(cuda, n_tile, n_azim):
    """K1, K1-argmax and K1-tilt over the shards: the assembled raw ratios
    (ids and D) bit-equal to the single launch on the card and to the
    sharded plain version on the CPU; one launch per slot."""
    s = sharded_scenes()
    mesh = _slot_mesh(cuda, n_tile, n_azim)
    cpu_mesh = _slot_mesh("cpu", n_tile, n_azim)
    for tilt in (False, True):
        for argmax in (False, True):
            out = []
            for dev, m in ((cuda, mesh), ("cpu", cpu_mesh)):
                ramp = tuple(torch.from_numpy(r).to(dev)
                             for r in s["ramp"]) if tilt else None
                args = fused_sweep.sweep_args(
                    torch.from_numpy(s["terrain"]).to(dev), tilt_ramp=ramp,
                    hori_acc=0.25, **s["tilt_kw"])
                n0 = fused_sweep.SHARD_KERNEL_LAUNCHES
                fwd = shard._HzForward(m, args)
                raw, rec = fwd.run(emit_argmax=argmax)
                if dev == cuda:
                    assert (fused_sweep.SHARD_KERNEL_LAUNCHES
                            == n0 + n_tile * n_azim)
                    single = fused_sweep._ratio_cuda(*args,
                                                     emit_argmax=argmax)
                    single = single if argmax else (single,)
                got = (raw,) + (_records(fwd, rec, single) if argmax
                                else ())
                out.append(tuple(t.cpu() for t in got))
            torch.cuda.synchronize()
            for g, w, p in zip(out[0], single, out[1]):
                assert torch.equal(g, w.cpu()) and torch.equal(g, p), (
                    tilt, argmax)


@pytest.mark.parametrize("n_tile,n_azim", [(8, 1), (2, 2)])
def test_k2_shard_variants_bit_equal(cuda, n_tile, n_azim):
    """K2 and K2-argmax over the tiles: metric, ids and D bit-equal to the
    single launch and to the sharded plain version."""
    s = sharded_scenes()
    for argmax in (False, True):
        out = []
        for dev in (cuda, "cpu"):
            args = ss.metric_args(
                torch.from_numpy(s["terrain"]).to(dev), s["z_org"],
                s["z_in"], s["table3"],
                **{k: v for k, v in s["shadow_kw"].items()
                   if k != "grid_origin"})
            n0 = ss.SHARD_KERNEL_LAUNCHES
            met, rec = shard._shadow_run(_slot_mesh(dev, n_tile, n_azim),
                                         args, (0.0, 0.0), argmax)
            if dev == cuda:
                assert ss.SHARD_KERNEL_LAUNCHES == n0 + n_tile
                single = ss._metric_cuda(*args, grid_origin=(0.0, 0.0),
                                         emit_argmax=argmax)
                single = single if argmax else (single,)
            got = [met]
            if argmax:
                ids, aux = torch.empty_like(met, dtype=torch.int32), \
                    torch.empty_like(met)
                rows = 32 // n_tile
                for t, _, i, d in rec:
                    ids[:, t * rows:(t + 1) * rows] = i
                    aux[:, t * rows:(t + 1) * rows] = d
                got += [ids, aux]
            out.append([t.cpu() for t in got])
        torch.cuda.synchronize()
        for g, w, p in zip(out[0], single, out[1]):
            assert torch.equal(g, w.cpu()) and torch.equal(g, p), argmax


def test_k3_k4_shard_variants_bit_equal(cuda):
    """K3 and K4's shard variants: the sharded gradients on the card
    bit-equal to the single-device gradients on the card (and across two
    runs), and the sharded replay's level and z_org cotangents bit-equal to
    its plain version's on the same record and cotangent."""
    s = sharded_scenes()
    mesh = _slot_mesh(cuda, 4, 2)

    def hz_step(fn, dev):
        zz = torch.from_numpy(s["terrain"]).to(dev).requires_grad_(True)
        rr = tuple(torch.from_numpy(r).to(dev).requires_grad_(True)
                   for r in s["ramp"])
        torch.mean(fn(zz, rr) ** 2).backward()
        return zz.grad, rr[0].grad, rr[1].grad

    n3 = replay.SHARD_KERNEL_LAUNCHES
    runs = [hz_step(lambda zz, rr: shard.horizon_sweep_fused_sharded(
        mesh, zz, tilt_ramp=rr, **s["tilt_kw"]), cuda) for _ in range(2)]
    assert replay.SHARD_KERNEL_LAUNCHES == n3 + 2 * (3 * 8 + 1)
    want = hz_step(lambda zz, rr: fused_sweep.horizon_sweep_fused(
        zz, tilt_ramp=rr, **s["tilt_kw"]), cuda)
    for a, b, c in zip(*runs, want):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert want[0].abs().max().item() > 0.0

    def sh_step(fn, dev):
        zz = torch.from_numpy(s["terrain"]).to(dev).requires_grad_(True)
        zo = (torch.from_numpy(s["z_org"]).to(dev)).requires_grad_(True)
        met = fn(zz, zo, zz[16:48, 16:48])
        torch.mean(torch.sigmoid(met / 5.0)).backward()
        return zz.grad, zo.grad

    n4 = replay.SHADOW_SHARD_KERNEL_LAUNCHES
    got = sh_step(lambda zz, zo, zi: shard.shadow_metric_fused_sharded(
        mesh, zz, zo, zi, s["table3"], **s["shadow_kw"]), cuda)
    assert replay.SHADOW_SHARD_KERNEL_LAUNCHES == n4 + 3 * 4 + 1
    want = sh_step(lambda zz, zo, zi: ss.shadow_metric_fused(
        zz, zo, zi, s["table3"], **s["shadow_kw"]), cuda)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # the replay alone, card against CPU, on one record and cotangent
    g = torch.from_numpy(np.random.default_rng(7).normal(
        size=(8, 32, 32)).astype(np.float32))
    res = []
    for dev in (cuda, "cpu"):
        args = fused_sweep.sweep_args(torch.from_numpy(s["terrain"]).to(dev),
                                      hori_acc=0.25, **s["tilt_kw"])
        m = _slot_mesh(dev, 4, 2)
        fwd = shard._HzForward(m, args)
        _, rec = fwd.run(emit_argmax=True)
        cots, zcot = shard._sharded_replay(
            m, (64, 64), fwd.plan, g.to(dev), rec,
            replay.horizon_shifts(fwd.trig, fwd.plan), fwd.rows, fwd.az_loc)
        res.append([c.cpu() for c in cots] + [zcot.cpu()])
    for a, b in zip(*res):
        assert torch.equal(a, b)


def test_multires_shard_windows_guarded(cuda):
    """Every tile's fine windows, each between guard rows of 1e6 m (a read
    past a window would win the maximum: a NaN guard would not show, since
    the kernel's max drops NaN): K1-argmax per slot bit-equal to the single
    launch's rows and azimuths; the sharded call's angles and both
    gradients bit-equal to the single-device call's on the card."""
    s = sharded_scenes()
    zf, zc = (torch.from_numpy(s[k]).to(cuda) for k in ("z_fine", "z_coarse"))
    kw = s["mr_kw"]
    geo = {k: kw[k] for k in ("dx", "dy", "offset", "inner_shape",
                              "dist_search", "hori_acc")}
    levels = multires.multires_levels(zf, zc, ratio_log2=2,
                                      coarse_offset=kw["coarse_offset"],
                                      **geo)
    args = fused_sweep.sweep_args(zf, pyramid=levels, azim_num=8, **geo)
    single = fused_sweep._ratio_cuda(*args, emit_argmax=True)
    mesh = _slot_mesh(cuda, 4, 2)
    fwd = shard._HzForward(mesh, args, n_fine=2)
    guard = 8
    for t, a, dev in mesh.local_slots():
        windows, (pool, pmin) = fwd.slot_levels(t, dev)
        guarded = []
        for lvl, w in enumerate(windows):
            if lvl >= 2:
                guarded.append(w)
                continue
            buf = torch.full((w.shape[0] + 2 * guard, w.shape[1]), 1.0e6,
                             device=dev)
            buf[guard:guard + w.shape[0]] = w
            guarded.append(buf[guard:guard + w.shape[0]])
        r0, az0 = t * fwd.rows, a * fwd.az_loc
        got = fused_sweep._ratio_cuda(
            args[0][r0:r0 + 8].contiguous(), args[1][r0:r0 + 8].contiguous(),
            guarded, fwd.trig[az0:az0 + 4], fwd.slot_plan(t), args[5],
            emit_argmax=True, pooled=(pool, pmin))
        for g, w in zip(got, single):
            assert torch.equal(g, w[az0:az0 + 4, r0:r0 + 8]), (t, a)

    def step(fn):
        f = zf.clone().requires_grad_(True)
        c = zc.clone().requires_grad_(True)
        h = fn(f, c)
        torch.mean(h ** 2).backward()
        return h.detach(), f.grad, c.grad

    got = step(lambda f, c: shard.horizon_sweep_multires_fused_sharded(
        mesh, f, c, **kw))
    want = step(lambda f, c: multires.horizon_sweep_multires_fused(
        f, c, **kw))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_xla_engines_sharded_on_card(cuda):
    """The sharded XLA engines on cuda:0 slots equal their single-device
    calls on the card."""
    s = sharded_scenes()
    z = torch.from_numpy(s["terrain"]).to(cuda)
    azim = (2 * np.pi / 8) * np.arange(8)
    kw = dict(dx=25.0, dy=-25.0, offset=(16, 16), inner_shape=(32, 32),
              dist_search=500.0)
    ref, _ = sweep.horizon_sweep(z, azim=azim, **kw)
    got = shard.horizon_sweep_sharded(_slot_mesh(cuda, 2, 4), z, azim=azim,
                                      **kw)
    assert got.is_cuda and torch.equal(got, ref)
    sched = sweep.build_schedule(25.0, s["diag"], sweep.default_rel_err(0.25))
    fields = [torch.from_numpy(f).to(cuda) for f in
              (s["z_org"], s["z_in"], np.full((32, 32), 0.2, np.float32))]
    u = np.array([0.0, 1.0 / 25.0], dtype=np.float32)
    ref = sweep.shadow_metric(z, *fields, u, sched, (16, 16), (32, 32))
    got = shard.shadow_metric_sharded(_slot_mesh(cuda, 8, 1), z, *fields, u,
                                      sched, (16, 16), (32, 32))
    assert torch.equal(got, ref)


def test_mixed_device_mesh(cuda):
    """Slots alternating between the card and the CPU (K1-K4's shard
    variants on the card, their plain versions on the CPU): the angles,
    the metric and every gradient bit-equal to the single-device call on
    the card, through the cross-device paths (each slot's inputs, the
    words' sum, a tile's z_org sum continued from one device on the
    other)."""
    s = sharded_scenes()
    devs = [cuda, torch.device("cpu")] * 4

    def hz_step(fn):
        zz = torch.from_numpy(s["terrain"]).to(cuda).requires_grad_(True)
        rr = tuple(torch.from_numpy(r).to(cuda).requires_grad_(True)
                   for r in s["ramp"])
        h = fn(zz, rr)
        torch.mean(h ** 2).backward()
        return h.detach(), zz.grad, rr[0].grad, rr[1].grad

    mesh = parallel.make_mesh(4, 2, devices=devs)
    got = hz_step(lambda zz, rr: shard.horizon_sweep_fused_sharded(
        mesh, zz, tilt_ramp=rr, **s["tilt_kw"]))
    want = hz_step(lambda zz, rr: fused_sweep.horizon_sweep_fused(
        zz, tilt_ramp=rr, **s["tilt_kw"]))
    for g, w in zip(got, want):
        assert g.is_cuda and torch.equal(g, w)

    def sh_step(fn):
        zz = torch.from_numpy(s["terrain"]).to(cuda).requires_grad_(True)
        zo = torch.from_numpy(s["z_org"]).to(cuda).requires_grad_(True)
        met = fn(zz, zo, zz[16:48, 16:48])
        torch.mean(torch.sigmoid(met / 5.0)).backward()
        return met.detach(), zz.grad, zo.grad

    mesh = parallel.make_mesh(8, 1, devices=devs)
    got = sh_step(lambda zz, zo, zi: shard.shadow_metric_fused_sharded(
        mesh, zz, zo, zi, s["table3"], **s["shadow_kw"]))
    want = sh_step(lambda zz, zo, zi: ss.shadow_metric_fused(
        zz, zo, zi, s["table3"], **s["shadow_kw"]))
    for g, w in zip(got, want):
        assert g.is_cuda and torch.equal(g, w)


# --- the streaming runners and profiling (horayzon_tpu_torch.utils) -------

@pytest.mark.parametrize("name", sorted(RUNNER_SCENES))
def test_tiled_runner_on_card(cuda, tmp_path, name):
    z, scene, tile = RUNNER_SCENES[name]
    kw = dict(dx=25.0, dy=-25.0, azim=horizon.azimuth_angles(4), tile=tile,
              **scene)
    runner = streaming.TiledHorizonRunner(z, out_dir=str(tmp_path / "card"),
                                          device=cuda, **kw)
    assert runner.fused
    tiles = list(runner.tiles())
    n0 = fused_sweep.KERNEL_LAUNCHES
    runner.run(verbose=False)
    assert fused_sweep.KERNEL_LAUNCHES == n0 + len(tiles)
    got = runner.assemble()
    cpu = streaming.TiledHorizonRunner(z, out_dir=str(tmp_path / "cpu"),
                                       device="cpu", **kw)
    cpu.run(verbose=False)
    np.testing.assert_allclose(got, cpu.assemble(), rtol=0, atol=TOL)
    zc, zt = torch.from_numpy(z).to(cuda), torch.from_numpy(z)
    off = scene["offset"]
    for i0, j0, m0, m1 in tiles:
        tkw = dict(dx=25.0, dy=-25.0, offset=(off[0] + i0, off[1] + j0),
                   inner_shape=(m0, m1), azim_num=4,
                   dist_search=scene["dist_search"])
        own = fused_sweep.horizon_sweep_fused(zc, **tkw)
        np.testing.assert_array_equal(got[i0:i0 + m0, j0:j0 + m1],
                                      own.cpu().numpy())
        raw = fused_sweep._ratio_cuda(*fused_sweep.sweep_args(zc, **tkw))
        assert torch.equal(raw.cpu(), fused_sweep._ratio_plain(
            *fused_sweep.sweep_args(zt, **tkw)))


def test_sun_track_runner_on_card(cuda, tmp_path):
    args, suns = sun_track_terrain_inputs()
    t = shadow.Terrain()
    t.initialise(*args, device=cuda)
    want = t.sw_dir_cor_batch(suns).cpu().numpy()
    runner = streaming.SunTrackRunner(t, suns, out_dir=str(tmp_path),
                                      chunk=3)
    n0 = ss.KERNEL_LAUNCHES
    runner.run(verbose=False)
    assert ss.KERNEL_LAUNCHES == n0 + len(list(runner.chunks()))
    np.testing.assert_array_equal(runner.assemble(), want)
    # a resumed run launches nothing for the chunks on disk
    os.unlink(runner._chunk_path(3))
    n0 = ss.KERNEL_LAUNCHES
    runner.run(verbose=False)
    assert ss.KERNEL_LAUNCHES == n0 + 1
    np.testing.assert_array_equal(runner.assemble(), want)


def test_profiling_sync_waits_for_the_card(cuda):
    start = torch.cuda.Event(enable_timing=True)
    done = torch.cuda.Event(enable_timing=True)
    x = torch.ones(4, device=cuda)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    torch.cuda._sleep(200_000_000)       # about 0.1 s of spinning
    y = x * 2.0
    done.record()
    assert not done.query()              # queued, not yet run
    assert profiling.sync({"y": [y], "cpu": torch.ones(2)})["y"][0] is y
    host_ms = 1e3 * (time.perf_counter() - t0)
    assert done.query()                  # sync returned after it ran
    card_ms = start.elapsed_time(done)
    assert card_ms > 20.0 and host_ms >= card_ms, (host_ms, card_ms)
    def spin():
        torch.cuda._sleep(20_000_000)
        return x * 2.0

    stats = profiling.time_sweep(spin, cells=1, azim_num=1,
                                 samples_per_cell_azim=1, iters=2)
    assert stats.wall_time_s > 1e-3
