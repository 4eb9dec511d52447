"""Kernel K1 (csrc/horizon_sweep.cu) on the card, against its plain torch
version on the same card.

Marked ``cuda`` and skipped without a CUDA device.  This file imports no
JAX, so on a machine with the card it runs without the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerance: 1e-5 rad on the horizon angle.  Kernel and plain version do the
same float32 operations in the same order (no FMA contraction, correctly
rounded sqrt and divide), so they agree to a few ulp of the arctan.
"""

import numpy as np
import pytest
import torch

from horayzon_tpu_torch.ops import _build, fused_sweep

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
