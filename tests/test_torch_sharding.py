"""The port's sharded entries (``horayzon_tpu_torch.parallel``) on meshes of
CPU slots: against the port's single-device calls, bit-equal, and against
the JAX package's sharded calls.

* Port against port: on the reference's mesh shapes
  (``tests/test_sharding.py:38``: (8, 1), (2, 4), (1, 8), (2, 2)) and
  (4, 2), ``horizon_sweep_fused_sharded`` (with and without the tilt ramp,
  the argmax triple assembled from the shards' records, the gradients
  w.r.t. the heightfield and the ramp), ``shadow_metric_fused_sharded``
  (the metric and both gradients) and
  ``horizon_sweep_multires_fused_sharded`` (the angles from the fine
  windows and both gradients) each equal their single-device call bit for
  bit.  So do the two XLA engines against the port's XLA engine on one
  mesh each.
* Port against JAX: the reference's cases of ``tests/test_sharding.py:
  97-398`` (same seeds, shapes and meshes) against its sharded calls in
  interpret mode, run in one subprocess with 8 virtual devices and the
  as-written flags of ``test_torch_fused_sweep.AS_WRITTEN_XLA_FLAGS``,
  started by the first test and read by the last ones, so that it runs
  beside the port's tests.  Tolerances, the single-device ones: angles
  within :data:`ANGLE_TOL` (``test_torch_sweep_engine``'s two float32 ulp
  of the arctan), the shadow metric within :data:`ULPS` float32 ulp, the
  gradients within ``1e-5 * max|g|`` (``test_torch_grad.py``,
  ``test_torch_shadow_grad.py``, ``test_torch_multires.py``).
* Rejections: indivisible rows or azimuths raise ``ValueError``.

Cost on the CPU: about 45 s of wall for the JAX subprocess (75-95 s of
CPU: XLA compiles on several threads) and about 20 s for the port's side,
which run together: about 50 s of wall for the file.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from horayzon_tpu_torch import parallel
from horayzon_tpu_torch.ops import fused_sweep, multires, shadow_sweep, sweep
from horayzon_tpu_torch.parallel import shard

from torch_scenes import SHARD_MESHES, sharded_scenes

ANGLE_TOL = 2.4e-7
ULPS = 2
GRAD_RTOL = 1.0e-5
AS_WRITTEN_XLA_FLAGS = ("--xla_disable_hlo_passes=algsimp "
                        "--xla_cpu_max_isa=AVX "
                        "--xla_force_host_platform_device_count=8")
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S = sharded_scenes()

_ORACLE = r"""
import sys
import numpy as np
import jax
import jax.numpy as jnp
from horayzon_tpu.ops import sweep as _sweep
from horayzon_tpu.parallel import mesh as pmesh
from horayzon_tpu.parallel import shard as pshard

inp = np.load(sys.argv[1])
assert len(jax.devices()) == 8
m42 = pmesh.make_mesh(n_tile=4, n_azim=2)
m81 = pmesh.make_mesh(n_tile=8, n_azim=1)
z = inp["terrain"]
out = {}
# tests/test_sharding.py:97-115, 118-134
kw = dict(dx=25.0, dy=-25.0, offset=(16, 16), inner_shape=(32, 32))
out["hz"] = pshard.horizon_sweep_pallas_sharded(
    m42, z, dist_search=600.0, hori_acc=0.25, azim_num=16, a_chunk=4,
    tile=(8, 32), interpret=True, **kw)
out["tilt"] = pshard.horizon_sweep_pallas_sharded(
    m42, z, dist_search=500.0, azim_num=8, a_chunk=4, tile=(8, 32),
    tilt_ramp=(inp["ramp_a"], inp["ramp_b"]), interpret=True, **kw)
# :137-163
sched = _sweep.build_schedule(25.0, float(inp["diag"]),
                              _sweep.default_rel_err(0.25))
skw = dict(schedule=sched, offset=(16, 16), inner_shape=(32, 32), dx=25.0,
           dy=-25.0, grid_origin=(0.0, 0.0), t_chunk=2, interpret=True)
out["shadow"] = pshard.shadow_metric_pallas_sharded(
    m81, z, inp["z_org"], inp["z_in"], inp["table2"], tile=(4, 32), **skw)
# :166-183 (the angles) and :282-339 (both gradients of mean(h^2))
i0 = int(inp["i0"])
mkw = dict(ratio_log2=2, coarse_offset=(i0, i0), dx=25.0, dy=-25.0,
           offset=(96, 96), inner_shape=(32, 32), dist_search=4000.0,
           hori_acc=2.0, azim_num=8, tile=(8, 32), a_chunk=4,
           interpret=True)
mr, vjp = jax.vjp(
    lambda f, c: pshard.horizon_sweep_multires_pallas_sharded(
        m42, f, c, **mkw),
    jnp.asarray(inp["z_fine"]), jnp.asarray(inp["z_coarse"]))
out["mr"] = mr
out["g_mr_f"], out["g_mr_c"] = vjp(2.0 * mr / mr.size)
# :236-279
gkw = dict(dx=25.0, dy=-25.0, offset=(16, 16), inner_shape=(8, 32),
           dist_search=150.0, azim_num=2, a_chunk=1, tile=(2, 32),
           interpret=True)


def loss_hz(zz, r):
    return jnp.mean(pshard.horizon_sweep_pallas_sharded(
        m42, zz, tilt_ramp=r, **gkw) ** 2)


gz, gr = jax.grad(loss_hz, argnums=(0, 1))(
    jnp.asarray(z), (jnp.asarray(inp["gramp_a"]), jnp.asarray(inp["gramp_b"])))
out["g_hz_z"], out["g_hz_a"], out["g_hz_b"] = gz, gr[0], gr[1]
# :342-398


def loss_sh(zz, zorg):
    z_i = jax.lax.dynamic_slice(zz, (16, 16), (32, 32))
    met = pshard.shadow_metric_pallas_sharded(
        m42, zz, zorg, z_i, inp["table3"], tile=(8, 32), **skw)
    return jnp.mean(jax.nn.sigmoid(met / 5.0))


zj = jnp.asarray(z)
out["g_sh_z"], out["g_sh_o"] = jax.grad(loss_sh, argnums=(0, 1))(
    zj, jax.lax.dynamic_slice(zj, (16, 16), (32, 32)) + 0.05)
# the XLA engines, :23-35 and :186-204
out["xla_hz"] = pshard.horizon_sweep_sharded(
    m42, z, azim=(2 * np.pi / 16) * np.arange(16), dist_search=600.0,
    hori_acc=0.25, **kw)
out["xla_sh"] = pshard.shadow_metric_sharded(
    m81, z, inp["z_org"], inp["z_in"], np.full((32, 32), 0.2, np.float32),
    np.array([0.0, 1.0 / 25.0], dtype=np.float32), sched, (16, 16),
    (32, 32))
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
"""


class _Oracle:
    """The JAX package's sharded results, computed in a subprocess started
    at construction; :meth:`result` waits for them."""

    def __init__(self, tmp_dir):
        self.paths = [os.path.join(str(tmp_dir), n)
                      for n in ("in.npz", "out.npz")]
        np.savez(self.paths[0], terrain=S["terrain"], ramp_a=S["ramp"][0],
                 ramp_b=S["ramp"][1], gramp_a=S["gramp"][0],
                 gramp_b=S["gramp"][1], table2=S["table2"],
                 table3=S["table3"], z_in=S["z_in"], z_org=S["z_org"],
                 diag=np.float64(S["diag"]), z_fine=S["z_fine"],
                 z_coarse=S["z_coarse"], i0=S["i0"])
        env = {**os.environ, "JAX_PLATFORMS": "cpu",
               "XLA_FLAGS": AS_WRITTEN_XLA_FLAGS,
               "PYTHONPATH": os.pathsep.join(
                   [_REPO, os.environ.get("PYTHONPATH", "")])}
        self.proc = subprocess.Popen(
            [sys.executable, "-c", _ORACLE, *self.paths], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        self.out = None

    def result(self):
        if self.out is None:
            _, err = self.proc.communicate(timeout=900)
            assert self.proc.returncode == 0, err[-3000:]
            self.out = dict(np.load(self.paths[1]))
        return self.out

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


@pytest.fixture(scope="module", autouse=True)
def oracle(tmp_path_factory):
    o = _Oracle(tmp_path_factory.mktemp("shard_oracle"))
    yield o
    o.close()


def _mesh(n_tile, n_azim):
    return parallel.make_mesh(n_tile, n_azim,
                              devices=[torch.device("cpu")] * (n_tile
                                                               * n_azim))


def ulp_diff(a, b):
    """Largest distance in float32 ulp between two float32 arrays."""
    def ordered(x):
        i = np.ascontiguousarray(x, dtype=np.float32).view(np.int32) \
            .astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int(np.abs(ordered(a) - ordered(b)).max())


def _grads(fn, *inputs):
    """``(out, grads)`` of ``mean(fn(*inputs)**2)`` w.r.t. every input."""
    xs = [torch.as_tensor(x).clone().requires_grad_(True) for x in inputs]
    out = fn(*xs)
    torch.mean(out ** 2).backward()
    return out.detach(), [x.grad for x in xs]


def _shadow_grads(fn):
    """The metric and the gradients of ``mean(sigmoid(metric / 5))`` w.r.t.
    the heightfield and the ray origins, the reference's loss
    (``tests/test_sharding.py:374-377``)."""
    z = torch.from_numpy(S["terrain"]).requires_grad_(True)
    z_org = (torch.from_numpy(S["terrain"])[16:48, 16:48] + 0.05) \
        .requires_grad_(True)
    met = fn(z, z_org, z[16:48, 16:48], S["table3"])
    torch.mean(torch.sigmoid(met / 5.0)).backward()
    return met.detach(), z.grad, z_org.grad


@pytest.fixture(scope="module")
def single():
    """The port's single-device results the sharded ones must equal."""
    z = torch.from_numpy(S["terrain"])
    ramp = tuple(torch.from_numpy(r) for r in S["ramp"])
    tilt_kw = dict(S["tilt_kw"], hori_acc=0.25)
    args = fused_sweep.sweep_args(z, tilt_ramp=ramp, **tilt_kw)
    out = dict(
        hz=fused_sweep.horizon_sweep_fused(z, **S["tilt_kw"]),
        tilt=_grads(lambda zz, a, b: fused_sweep.horizon_sweep_fused(
            zz, tilt_ramp=(a, b), **S["tilt_kw"]), z, *ramp),
        argmax=fused_sweep._ratio_plain(*args, emit_argmax=True),
        shadow=_shadow_grads(
            lambda zz, zo, zi, t: shadow_sweep.shadow_metric_fused(
                zz, zo, zi, t, **S["shadow_kw"])),
        mr=_grads(lambda f, c: multires.horizon_sweep_multires_fused(
            f, c, **S["mr_kw"]), S["z_fine"], S["z_coarse"]))
    return out


def _equal(got, want, what):
    assert got.shape == want.shape, what
    assert torch.equal(got, want), (what, (got - want).abs().max().item())


@pytest.mark.parametrize("n_tile,n_azim", SHARD_MESHES)
def test_horizon_sharded_bit_equal(single, n_tile, n_azim):
    mesh = _mesh(n_tile, n_azim)
    z = torch.from_numpy(S["terrain"])
    kw = S["tilt_kw"]
    _equal(shard.horizon_sweep_fused_sharded(mesh, z, **kw), single["hz"],
           "angles")
    out, grads = _grads(lambda zz, a, b: shard.horizon_sweep_fused_sharded(
        mesh, zz, tilt_ramp=(a, b), **kw), z,
        *(torch.from_numpy(r) for r in S["ramp"]))
    want_out, want_grads = single["tilt"]
    _equal(out, want_out, "angles with the tilt ramp")
    for g, w, what in zip(grads, want_grads, ("z", "ramp A", "ramp B")):
        _equal(g, w, f"gradient w.r.t. {what}")
    assert want_grads[0].abs().max() > 0.0
    # the argmax triple: the shards' records laid out by rows and azimuths
    args = fused_sweep.sweep_args(
        z, tilt_ramp=tuple(torch.from_numpy(r) for r in S["ramp"]),
        hori_acc=0.25, **kw)
    fwd = shard._HzForward(mesh, args)
    raw, records = fwd.run(emit_argmax=True)
    ids = torch.empty_like(single["argmax"][1])
    aux = torch.empty_like(single["argmax"][2])
    for t, a, i, d in records:
        sl = (slice(a * fwd.az_loc, (a + 1) * fwd.az_loc),
              slice(t * fwd.rows, (t + 1) * fwd.rows))
        ids[sl], aux[sl] = i, d
    for got, want, what in zip((raw, ids, aux), single["argmax"],
                               ("raw", "ids", "D")):
        _equal(got, want, what)


@pytest.mark.parametrize("n_tile,n_azim", SHARD_MESHES)
def test_shadow_sharded_bit_equal(single, n_tile, n_azim):
    mesh = _mesh(n_tile, n_azim)
    got = _shadow_grads(
        lambda zz, zo, zi, t: shard.shadow_metric_fused_sharded(
            mesh, zz, zo, zi, t, **S["shadow_kw"]))
    for g, w, what in zip(got, single["shadow"],
                          ("metric", "dz", "dz_org")):
        _equal(g, w, what)
    assert single["shadow"][1].abs().max() > 0.0


@pytest.mark.parametrize("n_tile,n_azim", SHARD_MESHES)
def test_multires_sharded_bit_equal(single, n_tile, n_azim):
    mesh = _mesh(n_tile, n_azim)
    out, grads = _grads(
        lambda f, c: shard.horizon_sweep_multires_fused_sharded(
            mesh, f, c, **S["mr_kw"]), S["z_fine"], S["z_coarse"])
    want_out, want_grads = single["mr"]
    _equal(out, want_out, "angles")
    for g, w, what in zip(grads, want_grads, ("z_fine", "z_coarse")):
        _equal(g, w, f"gradient w.r.t. {what}")
        assert w.abs().max() > 0.0


def test_multires_windows_are_cut_and_separate():
    """Each tile holds a window of every fine level, a separate allocation
    smaller than the level (the coarse levels are whole), and a read
    outside it raises."""
    zf, zc = (torch.from_numpy(S[k]) for k in ("z_fine", "z_coarse"))
    kw = S["mr_kw"]
    geo = {k: kw[k] for k in ("dx", "dy", "offset", "inner_shape",
                              "dist_search", "hori_acc")}
    levels = multires.multires_levels(zf, zc, ratio_log2=2,
                                      coarse_offset=kw["coarse_offset"],
                                      **geo)
    args = fused_sweep.sweep_args(zf, pyramid=levels, azim_num=8, **geo)
    fwd = shard._HzForward(_mesh(4, 2), args, n_fine=2)
    for t in range(4):
        windows, _ = fwd.slot_levels(t, torch.device("cpu"))
        for lvl, (win, full) in enumerate(zip(windows, levels)):
            o, e = fwd.windows[t][lvl]
            if lvl < 2:
                assert o % 8 == 0 and e - o < full.shape[0] // 2
                assert win.untyped_storage().data_ptr() != \
                    full.untyped_storage().data_ptr()
            else:
                assert (o, e) == (0, full.shape[0])
            assert torch.equal(win, full[o:e])
    # a window one row short at its end is read past: the plain sweep raises
    plan = fwd.slot_plan(3)
    windows, _ = fwd.slot_levels(3, torch.device("cpu"))
    short = [windows[0][:-1].clone()] + list(windows[1:])
    with pytest.raises(IndexError, match="outside the padded level"):
        fused_sweep._ratio_plain(args[0][-8:].contiguous(),
                                 args[1][-8:].contiguous(), short, args[3],
                                 plan, args[5])


def test_xla_engines_sharded_equal_single():
    z = torch.from_numpy(S["terrain"])
    azim = (2 * np.pi / 8) * np.arange(8)
    kw = dict(dx=25.0, dy=-25.0, offset=(16, 16), inner_shape=(32, 32),
              dist_search=500.0)
    ref, _ = sweep.horizon_sweep(z, azim=azim, **kw)
    got = shard.horizon_sweep_sharded(_mesh(2, 4), z, azim=azim, **kw)
    _equal(got, ref, "XLA horizon")
    sched = sweep.build_schedule(25.0, S["diag"], sweep.default_rel_err(0.25))
    fields = (torch.from_numpy(S["z_org"]), torch.from_numpy(S["z_in"]),
              torch.full((32, 32), 0.2))
    u_cells = np.array([0.0, 1.0 / 25.0], dtype=np.float32)
    ref = sweep.shadow_metric(z, *fields, u_cells, sched, (16, 16), (32, 32))
    got = shard.shadow_metric_sharded(_mesh(4, 2), z, *fields, u_cells,
                                      sched, (16, 16), (32, 32))
    _equal(got, ref, "XLA shadow metric")


def test_indivisible_shards_raise():
    z = torch.from_numpy(S["terrain"])
    mesh = _mesh(3, 1)
    with pytest.raises(ValueError, match="not divisible by tile axis"):
        shard.horizon_sweep_fused_sharded(mesh, z, **S["tilt_kw"])
    with pytest.raises(ValueError, match="not divisible by tile axis"):
        shard.shadow_metric_fused_sharded(mesh, z, S["z_org"], S["z_in"],
                                          S["table2"], **S["shadow_kw"])
    with pytest.raises(ValueError, match="not divisible by azim axis"):
        shard.horizon_sweep_fused_sharded(_mesh(1, 3), z, **S["tilt_kw"])
    with pytest.raises(ValueError, match="not divisible by azim axis"):
        shard.horizon_sweep_sharded(_mesh(2, 3), z, azim=np.zeros(8),
                                    dx=25.0, dy=-25.0, offset=(16, 16),
                                    inner_shape=(32, 32), dist_search=500.0)
    with pytest.raises(ValueError, match="not divisible by tile axis"):
        shard.horizon_sweep_multires_fused_sharded(
            _mesh(3, 1), S["z_fine"], S["z_coarse"], **S["mr_kw"])


def test_mesh_layout_and_single_process_init():
    mesh = parallel.init_distributed(n_azim=2,
                                     devices=[torch.device("cpu")] * 8)
    assert mesh.shape == {parallel.AXIS_TILE: 4, parallel.AXIS_AZIM: 2}
    assert (mesh.world, mesh.rank) == (1, 0)
    assert [(t, a) for t, a, _ in mesh.local_slots()] == [
        (t, a) for t in range(4) for a in range(2)]
    with pytest.raises(ValueError, match="mesh 3x2"):
        parallel.make_mesh(3, 2, devices=["cpu"] * 8)
    if torch.cuda.device_count() == 0:
        with pytest.raises(ValueError, match="no CUDA device"):
            parallel.make_mesh()


def test_horizon_matches_jax_sharded(oracle):
    ref = oracle.result()
    mesh = _mesh(4, 2)
    z = torch.from_numpy(S["terrain"])
    got = shard.horizon_sweep_fused_sharded(mesh, z, **S["hz_kw"])
    assert np.abs(got.numpy() - ref["hz"]).max() <= ANGLE_TOL
    got = shard.horizon_sweep_fused_sharded(
        mesh, z, tilt_ramp=S["ramp"], **S["tilt_kw"])
    assert np.abs(got.numpy() - ref["tilt"]).max() <= ANGLE_TOL


def test_shadow_matches_jax_sharded(oracle):
    ref = oracle.result()
    got = shard.shadow_metric_fused_sharded(
        _mesh(8, 1), S["terrain"], S["z_org"], S["z_in"], S["table2"],
        **S["shadow_kw"])
    assert ulp_diff(got.numpy(), ref["shadow"]) <= ULPS


def test_multires_matches_jax_sharded(oracle):
    ref = oracle.result()
    out, (gf, gc) = _grads(
        lambda f, c: shard.horizon_sweep_multires_fused_sharded(
            _mesh(4, 2), f, c, **S["mr_kw"]), S["z_fine"], S["z_coarse"])
    assert np.abs(out.numpy() - ref["mr"]).max() <= ANGLE_TOL
    for g, w in ((gf, ref["g_mr_f"]), (gc, ref["g_mr_c"])):
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_RTOL * np.abs(w).max())


def test_gradients_match_jax_sharded(oracle):
    ref = oracle.result()
    mesh = _mesh(4, 2)
    _, grads = _grads(lambda zz, a, b: shard.horizon_sweep_fused_sharded(
        mesh, zz, tilt_ramp=(a, b), **S["grad_kw"]), S["terrain"],
        *S["gramp"])
    for g, key in zip(grads, ("g_hz_z", "g_hz_a", "g_hz_b")):
        w = ref[key]
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_RTOL * np.abs(w).max())
    _, gz, go = _shadow_grads(
        lambda zz, zo, zi, t: shard.shadow_metric_fused_sharded(
            mesh, zz, zo, zi, t, **S["shadow_kw"]))
    for g, key in ((gz, "g_sh_z"), (go, "g_sh_o")):
        w = ref[key]
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_RTOL * np.abs(w).max())


def test_xla_engines_match_jax_sharded(oracle):
    ref = oracle.result()
    z = torch.from_numpy(S["terrain"])
    got = shard.horizon_sweep_sharded(
        _mesh(4, 2), z, azim=(2 * np.pi / 16) * np.arange(16),
        **{k: v for k, v in S["hz_kw"].items() if k != "azim_num"})
    assert np.abs(got.numpy() - ref["xla_hz"]).max() <= ANGLE_TOL
    got = shard.shadow_metric_sharded(
        _mesh(8, 1), z, S["z_org"], S["z_in"], np.full((32, 32), 0.2,
                                                       np.float32),
        np.array([0.0, 1.0 / 25.0], dtype=np.float32),
        sweep.build_schedule(25.0, S["diag"], sweep.default_rel_err(0.25)),
        (16, 16), (32, 32))
    assert ulp_diff(got.numpy(), ref["xla_sh"]) <= ULPS
