"""The port's fused sweep on the CPU (its plain torch version) against the
reference kernel, ``horizon_sweep_pallas(..., interpret=True)``.

Tolerance: 1e-5 rad on the horizon angle.  The port performs the
kernel's float32 operations in the order its source writes them, as the
Mosaic compiler does; on these cases the two agree to a few ulp of the
arctan (max 3e-8 rad).

The reference runs in a subprocess under :data:`AS_WRITTEN_XLA_FLAGS`.  With
XLA:CPU's default pipeline, interpret mode does not evaluate the kernel as
written: the algebraic simplifier reassociates products of a vector with
two scalars (``(y * c) * s`` becomes ``y * (c * s)``) and LLVM contracts
multiply-adds into FMAs.  The kernel's division-free parabola candidate
``b - 2 a s + 2 g`` cancels terms of a few thousand down to ~0.2 at an
isolated spike, so those one-ulp changes move the angle by up to 5e-4 rad
there.  The flags switch both rewrites off; nothing in the JAX package
changes.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horayzon_tpu.ops import pallas_sweep
from horayzon_tpu_torch.ops import fused_sweep, mip

from reference_impl import gaussian_bumps_terrain

TOL = 1.0e-5
AS_WRITTEN_XLA_FLAGS = "--xla_disable_hlo_passes=algsimp --xla_cpu_max_isa=AVX"
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_ORACLE = r"""
import json, sys
import numpy as np
from horayzon_tpu.ops import pallas_sweep
inputs = np.load(sys.argv[1])
calls = json.load(open(sys.argv[2]))
out = {}
for i, kw in enumerate(calls):
    kw["offset"] = tuple(kw["offset"])
    kw["inner_shape"] = tuple(kw["inner_shape"])
    out[str(i)] = np.asarray(pallas_sweep.horizon_sweep_pallas(
        inputs[str(i)], tile=kw["inner_shape"], interpret=True, **kw))
np.savez(sys.argv[3], **out)
"""


def interpret_reference(calls, tmp_dir):
    """``horizon_sweep_pallas(z, interpret=True, **kw)`` for each
    ``(z, kw)`` of ``calls``, evaluated as written (see the module
    docstring), with the inner block as the tile."""
    tmp_dir = str(tmp_dir)
    paths = [os.path.join(tmp_dir, n) for n in ("in.npz", "calls.json",
                                                "out.npz")]
    np.savez(paths[0], **{str(i): z for i, (z, _) in enumerate(calls)})
    with open(paths[1], "w") as f:
        json.dump([kw for _, kw in calls], f)
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": AS_WRITTEN_XLA_FLAGS,
           "PYTHONPATH": os.pathsep.join(
               [_REPO, os.environ.get("PYTHONPATH", "")])}
    res = subprocess.run([sys.executable, "-c", _ORACLE, *paths], env=env,
                         capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    out = np.load(paths[2])
    return [out[str(i)] for i in range(len(calls))]


def _spike():
    """tests/test_pallas.py's far-field case: a 500 m spike 5.8 km north
    of inner cell (136, 32), caught only by the mip phases."""
    halo, inner = int(6000.0 / 25) + 16, 64
    z = np.zeros((inner + 2 * halo,) * 2, dtype=np.float32)
    z[halo - 96, halo + 32] = 500.0
    return z, halo, inner


def _case_list():
    z96 = gaussian_bumps_terrain(96, 96, seed=3, amp=300.0)
    z_sp, halo, inner = _spike()
    b96 = dict(dx=25.0, dy=-25.0, offset=(32, 32), inner_shape=(32, 32),
               hori_acc=0.25)
    sp = dict(dx=25.0, dy=-25.0, offset=(halo, halo),
              inner_shape=(inner, inner), dist_search=6000.0,
              hori_acc=0.25)
    return {
        # tests/test_pallas.py:9-54 shapes: safe d2, safe and masked d1
        "bumps96_d800_a4": (z96, dict(b96, dist_search=800.0, azim_num=4)),
        "bumps96_d2500_a4": (z96, dict(b96, dist_search=2500.0,
                                       azim_num=4)),
        "bumps96_d2500_a7": (z96, dict(b96, dist_search=2500.0,
                                       azim_num=7)),
        "spike_d6000_a4": (z_sp, dict(sp, azim_num=4)),
        "spike_d6000_a7": (z_sp, dict(sp, azim_num=7)),
        # 12-cell halo: masked d2 steps, an odd masked d1 tail, dx != dy
        "halo12_dxdy_d825_a5": (
            gaussian_bumps_terrain(56, 56, seed=5, amp=300.0),
            dict(dx=25.0, dy=-30.0, offset=(12, 12), inner_shape=(32, 32),
                 dist_search=825.0, hori_acc=0.25, azim_num=5)),
        # coarse accuracy: mip levels 1-4 (strip path up to 16x16 blocks)
        "bumps576_acc2_d6000_a6": (
            gaussian_bumps_terrain(576, 576, seed=9, amp=600.0),
            dict(sp, hori_acc=2.0, azim_num=6)),
        # max_level caps the pyramid: the level-2 phase runs to dist
        "bumps576_acc2_lvl2_d6000_a3": (
            gaussian_bumps_terrain(576, 576, seed=9, amp=600.0),
            dict(sp, hori_acc=2.0, azim_num=3, max_level=2)),
        # n_safe = n_dense - 1: one masked trailing step after an even
        # safe d1 run (it reuses the near-field h2, as the reference does)
        "halo34_d825_a4": (
            gaussian_bumps_terrain(100, 100, seed=7, amp=300.0),
            dict(dx=25.0, dy=-25.0, offset=(34, 34), inner_shape=(32, 32),
                 dist_search=825.0, hori_acc=0.25, azim_num=4)),
    }


CASES = _case_list()


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    names = sorted(CASES)
    refs = interpret_reference([CASES[n] for n in names],
                               tmp_path_factory.mktemp("oracle"))
    return dict(zip(names, refs))


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_interpret_pallas(reference, name):
    z, kw = CASES[name]
    n0 = fused_sweep.KERNEL_LAUNCHES
    got = fused_sweep.horizon_sweep_fused(torch.from_numpy(z), **kw)
    assert fused_sweep.KERNEL_LAUNCHES == n0      # CPU: the plain version
    ref = reference[name]
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert tuple(got.shape) == ref.shape
    assert np.abs(got.numpy() - ref).max() <= TOL


def test_jax_pyramid_gives_same_result(reference):
    """The JAX package's padded levels, laid out by pyramid_from_jax, drive
    the port's sweep to the same values as its own pyramid."""
    z, kw = CASES["spike_d6000_a4"]
    plan = pallas_sweep.plan_sweep(
        z.shape, tile=kw["inner_shape"], **{
            k: kw[k] for k in ("inner_shape", "offset", "azim_num",
                               "dist_search", "dx", "dy", "hori_acc")})
    padded, _ = pallas_sweep.build_padded_pyramid(
        jnp.asarray(z), plan["pads"], plan["levels_meta"])
    levels = mip.pyramid_from_jax([np.asarray(p) for p in padded],
                                  plan["pads"], "cpu")
    zt = torch.from_numpy(z)
    got = fused_sweep.horizon_sweep_fused(zt, pyramid=levels, **kw)
    assert torch.equal(got, fused_sweep.horizon_sweep_fused(zt, **kw))
    assert np.abs(got.numpy() - reference["spike_d6000_a4"]).max() <= TOL


@pytest.mark.parametrize("name", ["bumps96_d2500_a4", "spike_d6000_a4",
                                  "halo12_dxdy_d825_a5"])
def test_plan_matches_reference(name):
    z, kw = CASES[name]
    geo = {k: kw[k] for k in ("inner_shape", "offset", "dist_search", "dx",
                              "dy", "hori_acc")}
    got = fused_sweep.plan_sweep(z.shape, **geo)
    ref = pallas_sweep.plan_sweep(z.shape, tile=kw["inner_shape"],
                                  azim_num=kw["azim_num"], **geo)
    for key in ("phases_meta", "pads", "near_ex", "n_safe", "step", "dist",
                "rel_err", "offset", "inner_shape"):
        assert got[key] == ref[key], key


def test_trig_table_is_the_float32_azimuth_convention():
    t = fused_sweep.trig_table(7)
    az = ((2.0 * np.pi) / 7 * np.arange(7)).astype(np.float32)
    assert t.dtype == np.float32 and t.shape == (7, 2)
    np.testing.assert_array_equal(t[:, 0], np.sin(az.astype(np.float64))
                                  .astype(np.float32))
    np.testing.assert_array_equal(t[:, 1], np.cos(az.astype(np.float64))
                                  .astype(np.float32))


def test_entry_validation():
    z = np.zeros((64, 64), dtype=np.float32)
    kw = dict(dx=25.0, dy=-25.0, offset=(16, 16), inner_shape=(32, 32),
              azim_num=4, dist_search=500.0)
    zt = torch.from_numpy(z)
    for bad, match in [
            (dict(dist_search=0.0), "dist_search must be positive"),
            (dict(dist_search=-5.0), "dist_search must be positive"),
            (dict(azim_num=0), "azim_num"),
            (dict(offset=(40, 16)), "does not lie inside"),
            (dict(offset=(-1, 16)), "does not lie inside"),
            (dict(inner_shape=(0, 32)), "does not lie inside")]:
        with pytest.raises(ValueError, match=match):
            fused_sweep.horizon_sweep_fused(zt, **dict(kw, **bad))
    # the reference rejects a non-positive distance the same way
    with pytest.raises(ValueError, match="dist_search must be positive"):
        pallas_sweep.horizon_sweep_pallas(
            z, tile=(32, 32), interpret=True, **dict(kw, dist_search=0.0))
    with pytest.raises(ValueError, match="2-D"):
        fused_sweep.horizon_sweep_fused(zt[None], **kw)
    plan = fused_sweep.plan_sweep((64, 64), **{
        k: kw[k] for k in ("offset", "inner_shape", "dist_search", "dx",
                           "dy")})
    levels = mip.padded_levels(zt, plan["pads"])
    with pytest.raises(ValueError, match="expected"):
        fused_sweep.horizon_sweep_fused(
            zt, pyramid=[lv[1:] for lv in levels], **kw)
    with pytest.raises(ValueError, match="levels"):
        fused_sweep.horizon_sweep_fused(zt, pyramid=levels + levels, **kw)
    with pytest.raises(ValueError, match="no horizon sweep for device"):
        fused_sweep.horizon_sweep_fused(zt.to("meta"), **kw)
    with pytest.raises(ValueError, match="mip level"):
        fused_sweep.plan_sweep((64, 64), inner_shape=(32, 32),
                               offset=(16, 16), dist_search=1.0e9, dx=25.0,
                               dy=-25.0, max_level=20)
