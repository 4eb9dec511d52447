"""Kernels K1 (csrc/horizon_sweep.cu, with its argmax variant) and K3
(csrc/horizon_replay_bwd.cu) on the card, against their plain torch
versions on the same card, and the gradient path they make.

Marked ``cuda`` and skipped without a CUDA device.  This file imports no
JAX, so on a machine with the card it runs without the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: 1e-5 rad on the horizon angle.  Kernel and plain version do
the same float32 operations in the same order (no FMA contraction,
correctly rounded sqrt and divide), so they agree to a few ulp of the
arctan; the argmax variant's raw ratios, ids and D are equal.  K3 against
the plain backward: rtol 1e-5 of max |.| per cotangent (the same terms
summed in another order); two K3 runs bit-equal.
"""

import numpy as np
import pytest
import torch

from horayzon_tpu_torch.ops import _build, fused_sweep, replay

from reference_impl import gaussian_bumps_terrain

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
    bargs = (tuple(zt.shape), g, ids, aux, args[4], args[3])
    n0 = replay.KERNEL_LAUNCHES
    cots, zcot = replay._bwd_cuda(*bargs)
    assert replay.KERNEL_LAUNCHES == n0 + 1
    cots2, zcot2 = replay._bwd_cuda(*bargs)
    p_cots, p_zcot = replay.backward_replay_plain(*bargs)
    torch.cuda.synchronize()
    for got, again, want in zip(cots + [zcot], cots2 + [zcot2],
                                p_cots + [p_zcot]):
        assert torch.equal(got, again)
        scale = want.abs().max().item()
        assert (got - want).abs().max().item() <= 1e-5 * scale
    assert zcot.abs().max().item() > 0.0


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
