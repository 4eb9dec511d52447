"""The port's recompute VJP (``HZT_GRAD_RECOMPUTE=1``), single-device and
sharded, on the CPU: against the JAX package's ``jax.grad`` under the same
variable in interpret mode, against the port's winner replay, and the
switch's edges.

* Port against JAX: ``tests/torch_scenes.recompute_scenes``'s spike, bumps
  with a tilt ramp (``z`` and both ramp cotangents) and masked scenes
  through the reference's custom VJP ``_pallas_hz`` (what
  ``horizon_sweep_pallas`` calls; one compile serves the three, the
  unmasked ones with an all-ones mask and a zero ramp), and its sharded
  case through ``horizon_sweep_pallas_sharded`` on the meshes (8, 1),
  (2, 4) and (1, 8) of 8 virtual devices.  One subprocess, with
  ``HZT_GRAD_RECOMPUTE=1`` and the as-written flags of
  ``test_torch_sharding.AS_WRITTEN_XLA_FLAGS``, started by the first test
  and read by the last tests.  Tolerance: ``1e-5 * max|g|``, as the
  other gradient tests, but ``1e-4 * max|g|`` on the masked scene, whose
  recompute gradient moves by 3.2e-5 of max|g| between two roundings of
  the port's own backward (:data:`JAX_RTOL`).
* Port against port: the spike's recompute gradient equals the replay's
  within the reference's own ``atol=5e-9`` and norm ratio 1e-3
  (``tests/test_pallas.py:303-312``); with ``pyramid=`` given, or the
  variable unset or not ``"1"``, every gradient is bit-equal to the
  replay's; the sharded recompute equals the single-device one within
  ``1e-5 * max|g|`` (a shard's heights are ``z_org - ray_org_elev``,
  rounded as the reference rounds them), also over two gloo processes
  whose level cotangents are all-reduced; the chunked VJP equals autograd
  through the whole XLA equivalent (``fused_sweep.hz_xla_equiv``,
  ``shard.psh_xla_equiv``) within ``1e-6 * max|g|`` (only the order of
  float sums differs).
* The mask (a reference quirk): the recompute backward ignores it, so a
  masked cell's cotangent passes on the unmasked sweep's gradient; an
  all-masked call gives zero gradients, as the reference's constant
  result.
* ``sweep.tie_clip``: the gradient at an exact bound is 0.5, as
  ``jax.grad(jnp.clip)``'s; ``sweep.horizon_sweep``'s forward is bit-equal
  to the ``torch.clamp`` it replaced.
* The chunk model: ``fused_sweep.RECOMPUTE_STEP_BYTES`` bounds the bytes
  autograd saves (``saved_tensors_hooks``) within a factor of 2, and a
  block whose single azimuth does not fit raises.

Cost on the CPU: about 80-100 s of wall for the JAX subprocess (one
compile of the single-device VJP, about 30 s, and one per mesh, about 15
s each; XLA compiles the recompute's scans slowly under the as-written
flags) and about 25 s for the port's side (the two-process run about 8
s), which run together.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horayzon_tpu_torch import parallel
from horayzon_tpu_torch.ops import fused_sweep, mip, replay, sweep
from horayzon_tpu_torch.parallel import shard

from reference_impl import gaussian_bumps_terrain
from test_torch_sharding import AS_WRITTEN_XLA_FLAGS, _REPO
from torch_scenes import recompute_scenes

GRAD_RTOL = 1.0e-5
#: The masked scene's terrain (seed 13) holds interior-parabola winners
#: whose partials through the stationary point cancel, so the recompute's
#: rounding shows: two equally valid roundings of the port's own backward
#: (the square root's derivative in float64 or float32, the division's as
#: torch or as JAX forms it) move its gradient by 3.2e-5 of max|g|, and
#: the port and JAX differ by 3.3e-5 there (both on the CPU).  The other
#: scenes agree within 3.0e-6.
JAX_RTOL = {"masked": 1.0e-4}
MESHES = [(8, 1), (2, 4), (1, 8)]
LIMS = (-15.0, 89.98)
S = recompute_scenes()

_ORACLE = r"""
import os, sys
import numpy as np
import jax
import jax.numpy as jnp
from horayzon_tpu.ops import pallas_sweep as ps
from horayzon_tpu.parallel import mesh as pmesh
from horayzon_tpu.parallel import shard as pshard

assert os.environ["HZT_GRAD_RECOMPUTE"] == "1"
assert len(jax.devices()) == 8
inp = np.load(sys.argv[1])
out = {}
# the cfg horizon_sweep_pallas builds (pallas_sweep.py:1219-1243) for the
# spike geometry, one 32^2 tile
geo = {k: int(inp[k]) for k in ("halo", "inner")}
kw = dict(dx=25.0, dy=-25.0, offset=(geo["halo"],) * 2,
          inner_shape=(geo["inner"],) * 2, dist_search=6000.0,
          hori_acc=0.25, azim_num=4)
plan = ps.plan_sweep(inp["spike_z"].shape, tile=(32, 32), a_chunk=4, **kw)
tmap = ps.tile_schedule(plan["inner_shape"], plan["tile"])
cfg = ps._HzCfg(
    outer_shape=tuple(inp["spike_z"].shape), azim_num=4,
    azim_pad=plan["azim_pad"], ray_org_elev=0.01, elev_lims=(-15.0, 89.98),
    tile_map=tuple(map(tuple, tmap.tolist())), interpret=True,
    **{k: plan[k] for k in ("levels_meta", "phases_meta", "pads", "tile",
                            "a_chunk", "offset", "inner_shape", "dx", "dy",
                            "step", "dist", "near_ex", "n_safe", "rel_err",
                            "max_level")})


def loss(z, ra, rb, m, w, s):
    h = ps._pallas_hz(cfg, z, (ra, rb), m)
    return jnp.sum(w * h) + s * jnp.mean(h ** 2)


grad = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))
for name in ("spike", "bumps", "masked"):
    args = [jnp.asarray(inp[f"{name}_{k}"]) for k in ("z", "ra", "rb", "m",
                                                      "w")]
    dz, da, db = grad(*args, float(inp[f"{name}_s"]))
    out[f"{name}/dz"], out[f"{name}/da"], out[f"{name}/db"] = dz, da, db
# tests/test_sharding.py:236-279's case at 8 azimuths
gkw = dict(dx=25.0, dy=-25.0, offset=(16, 16), inner_shape=(8, 32),
           dist_search=150.0, hori_acc=0.25, azim_num=8, a_chunk=1,
           tile=(1, 32), interpret=True)
for nt, na in ((8, 1), (2, 4), (1, 8)):
    mesh = pmesh.make_mesh(n_tile=nt, n_azim=na)

    def loss_sh(z, ra, rb, mesh=mesh):
        return jnp.mean(pshard.horizon_sweep_pallas_sharded(
            mesh, z, tilt_ramp=(ra, rb), **gkw) ** 2)

    dz, da, db = jax.jit(jax.grad(loss_sh, argnums=(0, 1, 2)))(
        *(jnp.asarray(inp[f"shard_{k}"]) for k in ("z", "ra", "rb")))
    key = f"shard{nt}x{na}"
    out[f"{key}/dz"], out[f"{key}/da"], out[f"{key}/db"] = dz, da, db
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
"""


def _oracle_inputs():
    arrays = dict(halo=S["spike"][1]["offset"][0],
                  inner=S["spike"][1]["inner_shape"][0])
    for name in ("spike", "bumps", "masked"):
        z, kw, ramp, mask, cot = S[name]
        shape = kw["inner_shape"]
        zero = np.zeros(shape, np.float32)
        arrays.update({
            f"{name}_z": z,
            f"{name}_ra": zero if ramp is None else ramp[0],
            f"{name}_rb": zero if ramp is None else ramp[1],
            f"{name}_m": (np.ones(shape, np.uint8) if mask is None
                          else mask),
            f"{name}_w": (np.zeros(shape + (kw["azim_num"],), np.float32)
                          if cot is None else cot),
            f"{name}_s": np.float32(cot is None)})
    z, _, ramp, _, _ = S["shard"]
    arrays.update(shard_z=z, shard_ra=ramp[0], shard_rb=ramp[1])
    return arrays


class _Oracle:
    """The JAX package's recompute gradients, computed in a subprocess
    started at construction; :meth:`result` waits for them."""

    def __init__(self, tmp_dir):
        self.paths = [os.path.join(str(tmp_dir), n)
                      for n in ("in.npz", "out.npz")]
        np.savez(self.paths[0], **_oracle_inputs())
        env = {**os.environ, "JAX_PLATFORMS": "cpu",
               "XLA_FLAGS": AS_WRITTEN_XLA_FLAGS, "HZT_GRAD_RECOMPUTE": "1",
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
    o = _Oracle(tmp_path_factory.mktemp("recompute_oracle"))
    yield o
    o.close()


@pytest.fixture
def recompute(monkeypatch):
    monkeypatch.setenv("HZT_GRAD_RECOMPUTE", "1")


def _grads(name, sweep_fn=fused_sweep.horizon_sweep_fused):
    """``(dz, dA, dB)`` of scene ``name``: loss ``mean(h^2)``, or with the
    scene's cotangent ``sum(cot * h)``; ``dA``, ``dB`` None without a
    ramp.  ``sweep_fn(z, tilt_ramp=..., mask=..., **keywords)``."""
    z, kw, ramp, mask, cot = S[name]
    zz = torch.from_numpy(z).requires_grad_(True)
    rr = None if ramp is None else tuple(
        torch.from_numpy(r).requires_grad_(True) for r in ramp)
    h = sweep_fn(zz, tilt_ramp=rr, mask=mask, **kw)
    loss = (torch.mean(h ** 2) if cot is None
            else torch.sum(torch.from_numpy(cot) * h))
    loss.backward()
    return (zz.grad,) + ((None, None) if rr is None
                         else tuple(r.grad for r in rr))


def _close(got, want, what, rtol=GRAD_RTOL):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    scale = float(np.abs(want).max())
    assert scale > 0.0, what
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (what, err, scale)


def _mesh(n_tile, n_azim):
    return parallel.make_mesh(n_tile, n_azim,
                              devices=[torch.device("cpu")] * 8)


# ---------------------------------------------------------------------------
# The tie-splitting clip and the XLA engine's forward
# ---------------------------------------------------------------------------

def test_tie_clip_splits_ties_like_jnp_clip():
    lo, hi = np.deg2rad(-15.0), np.deg2rad(89.98)
    x = np.array([np.float32(lo), np.float32(hi), -1.0, 0.3, 2.0,
                  np.float32(lo) + 1e-6], dtype=np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = sweep.tie_clip(xt, float(lo), float(hi))
    y.sum().backward()
    want = np.asarray(jax.vmap(jax.grad(
        lambda v: jnp.clip(v, float(lo), float(hi))))(jnp.asarray(x)))
    np.testing.assert_array_equal(xt.grad.numpy(), want)
    np.testing.assert_array_equal(xt.grad.numpy()[:2], [0.5, 0.5])
    np.testing.assert_array_equal(
        y.detach().numpy(), np.asarray(jnp.clip(x, float(lo), float(hi))))


def test_horizon_sweep_forward_unchanged_by_the_clip():
    """``sweep.horizon_sweep``'s angles bit-equal to ``torch.clamp`` of the
    same unclipped angles, with limits that clip on both sides."""
    z = torch.from_numpy(gaussian_bumps_terrain(64, 64, seed=4, amp=400.0))
    kw = dict(dx=25.0, dy=-25.0, offset=(16, 16), inner_shape=(32, 32),
              dist_search=600.0, hori_acc=0.25)
    azim = (2 * np.pi / 8) * np.arange(8)
    lo, hi = -2.0, 6.0
    hori, _ = sweep.horizon_sweep(z, azim=azim, elev_ang_low_lim=lo,
                                  elev_ang_up_lim=hi, **kw)
    free, _ = sweep.horizon_sweep(z, azim=azim, elev_ang_low_lim=-90.0,
                                  elev_ang_up_lim=90.0, **kw)
    want = torch.clamp(free, np.deg2rad(lo), np.deg2rad(hi))
    assert torch.equal(hori, want)
    assert bool((free < np.deg2rad(lo)).any()) and bool(
        (free > np.deg2rad(hi)).any())


# ---------------------------------------------------------------------------
# The switch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("value,mode", [(None, "replay"), ("0", "replay"),
                                        ("", "replay"), ("true", "replay"),
                                        ("1", "recompute")])
def test_grad_mode_reads_the_variable(monkeypatch, value, mode):
    if value is None:
        monkeypatch.delenv("HZT_GRAD_RECOMPUTE", raising=False)
    else:
        monkeypatch.setenv("HZT_GRAD_RECOMPUTE", value)
    assert fused_sweep._grad_mode() == mode


def _replay_grads(name):
    """The replay gradient of scene ``name`` from the replay's pieces (the
    argmax sweep, the clip/arctan chain, the plain replay and the
    pyramid's VJP), as the gradient entry formed it before the recompute
    mode existed."""
    z, kw, ramp, mask, cot = S[name]
    zt = torch.from_numpy(z)
    rr = None if ramp is None else tuple(torch.from_numpy(r) for r in ramp)
    args = fused_sweep.sweep_args(zt, tilt_ramp=rr, mask=mask, **kw)
    raw, ids, aux = fused_sweep._ratio_plain(*args, emit_argmax=True)
    h = fused_sweep._angles(raw.clone(), *LIMS)
    g = (2.0 * h / h.numel() if cot is None else torch.from_numpy(cot))
    graw = fused_sweep.raw_cotangent(raw, g, LIMS)
    plan, trig = args[4], args[3]
    cots, zcot = replay.backward_replay(tuple(zt.shape), graw, ids, aux, plan,
                                        replay.horizon_shifts(trig, plan))
    dz = replay.z_cotangent(zt, plan, cots, zcot)
    dr = (None, None) if rr is None else fused_sweep.ramp_cotangent(graw, trig)
    return (dz,) + tuple(dr)


@pytest.mark.parametrize("value", [None, "0"])
@pytest.mark.parametrize("name", ["bumps", "masked"])
def test_replay_gradient_unchanged_without_the_variable(monkeypatch, name,
                                                        value):
    if value is None:
        monkeypatch.delenv("HZT_GRAD_RECOMPUTE", raising=False)
    else:
        monkeypatch.setenv("HZT_GRAD_RECOMPUTE", value)
    for got, want in zip(_grads(name), _replay_grads(name)):
        assert (got is None) == (want is None)
        if got is not None:
            assert torch.equal(got, want)


def test_given_pyramid_keeps_the_replay(monkeypatch):
    """With ``pyramid=`` the reference's ``_mr_hz`` reads no variable: the
    gradient through the given levels is the replay's, bit for bit."""
    z, kw, ramp, _, _ = S["bumps"]
    plan = fused_sweep.plan_sweep(
        z.shape, **{k: kw[k] for k in ("inner_shape", "offset", "dist_search",
                                       "dx", "dy", "hori_acc")})

    def grads():
        zz = torch.from_numpy(z).requires_grad_(True)
        rr = tuple(torch.from_numpy(r).requires_grad_(True) for r in ramp)
        h = fused_sweep.horizon_sweep_fused(
            zz, tilt_ramp=rr, pyramid=mip.padded_levels(zz, plan["pads"]),
            **kw)
        torch.mean(h ** 2).backward()
        return [zz.grad] + [r.grad for r in rr]

    monkeypatch.delenv("HZT_GRAD_RECOMPUTE", raising=False)
    want = grads()
    monkeypatch.setenv("HZT_GRAD_RECOMPUTE", "1")
    n0 = fused_sweep.ARGMAX_KERNEL_LAUNCHES
    got = grads()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert fused_sweep.ARGMAX_KERNEL_LAUNCHES == n0     # a CPU run


# ---------------------------------------------------------------------------
# Single device
# ---------------------------------------------------------------------------

def test_spike_recompute_matches_replay(monkeypatch):
    """tests/test_pallas.py:303-312 on the port: the recompute equals the
    replay where the far field's mip winners carry the gradient."""
    monkeypatch.delenv("HZT_GRAD_RECOMPUTE", raising=False)
    g_rep = _grads("spike")[0].numpy()
    monkeypatch.setenv("HZT_GRAD_RECOMPUTE", "1")
    g_rc = _grads("spike")[0].numpy()
    halo = S["spike"][1]["offset"][0]
    assert np.abs(g_rc[halo - 97:halo - 95, halo + 15:halo + 18]).max() > 0
    np.testing.assert_allclose(g_rep, g_rc, atol=5e-9)
    assert abs(np.linalg.norm(g_rep) / np.linalg.norm(g_rc) - 1.0) < 1e-3


def test_masked_cells_pass_the_unmasked_gradient(recompute):
    """The reference quirk: the recompute backward takes no mask, so the
    masked run's gradient under a fixed cotangent on every cell is the
    unmasked run's."""
    masked = _grads("masked")
    z, kw, _, _, cot = S["masked"]
    zz = torch.from_numpy(z).requires_grad_(True)
    h = fused_sweep.horizon_sweep_fused(zz, **kw)
    torch.sum(torch.from_numpy(cot) * h).backward()
    assert torch.equal(masked[0], zz.grad)


def test_all_masked_gives_zero_gradients(recompute):
    """An all-masked call is the reference's constant result
    (``pallas_sweep.py:1226-1229``): the lower limit, zero gradients."""
    z, kw, ramp, _, _ = S["bumps"]
    zz = torch.from_numpy(z).requires_grad_(True)
    rr = tuple(torch.from_numpy(r).requires_grad_(True) for r in ramp)
    h = fused_sweep.horizon_sweep_fused(
        zz, tilt_ramp=rr, mask=np.zeros(kw["inner_shape"], np.uint8), **kw)
    assert bool((h == np.float32(np.deg2rad(LIMS[0]))).all())
    torch.mean(h ** 2).backward()
    for t in (zz, *rr):
        assert not bool(t.grad.any())


@pytest.mark.parametrize("a_chunk", [1, 3])
def test_chunked_vjp_equals_autograd_through_the_equivalent(a_chunk):
    """``recompute_vjp`` in chunks of ``a_chunk`` azimuths against autograd
    through ``hz_xla_equiv`` in one graph, at the same cotangent."""
    z, kw, ramp, _, _ = S["shard_wide"]
    zt = torch.from_numpy(z)
    args = fused_sweep.sweep_args(zt, **kw)
    plan, trig = args[4], args[3]
    g = torch.from_numpy(np.random.default_rng(3).normal(
        0.0, 1.0, kw["inner_shape"] + (kw["azim_num"],)).astype(np.float32))
    zz = zt.clone().requires_grad_(True)
    rr = tuple(torch.from_numpy(r).requires_grad_(True) for r in ramp)
    h = fused_sweep.hz_xla_equiv(plan, trig, zz, rr)
    want = torch.autograd.grad(h, [zz, *rr], g)
    orig = fused_sweep.recompute_chunk
    try:
        fused_sweep.recompute_chunk = lambda *a: a_chunk
        dz, dr = fused_sweep.recompute_vjp(
            zt, tuple(torch.from_numpy(r) for r in ramp), g, plan, trig,
            ray_org_elev=0.01, lims=LIMS)
    finally:
        fused_sweep.recompute_chunk = orig
    assert fused_sweep.LAST_RECOMPUTE_CHUNK == a_chunk
    for got, w, what in zip((dz, *dr), want, ("dz", "dA", "dB")):
        _close(got, w.numpy(), what, rtol=1e-6)


def test_step_bytes_bound_the_saved_tensors():
    """:data:`fused_sweep.RECOMPUTE_STEP_BYTES` over a schedule with d2, d1
    and mip phases (masked and safe) against the bytes autograd saves for
    one chunk (the levels aside): an upper bound, within a factor of 2."""
    z = torch.from_numpy(gaussian_bumps_terrain(400, 400, seed=7,
                                                amp=400.0))
    kw = dict(dx=25.0, dy=-25.0, offset=(168, 168), inner_shape=(64, 64),
              dist_search=8000.0, azim_num=3)
    args = fused_sweep.sweep_args(z, **kw)
    plan, trig = args[4], args[3]
    sched = fused_sweep.recompute_schedule(plan, tuple(z.shape))
    assert {m[0] for m in sched.meta()} == {"d2", "d1", "mip"}
    levels = [t.requires_grad_(True) for t in
              mip.padded_levels(z, plan["pads"])]
    own = {t.untyped_storage().data_ptr() for t in levels}
    x = z[168:232, 168:232].clone().requires_grad_(True)
    tables = sweep.horizon_shift_tables(
        sched, fused_sweep.equiv_azimuths(3), 25.0, -25.0, (168, 168))
    saved = {}

    def pack(t):
        st = t.untyped_storage()
        if st.data_ptr() not in own:
            saved[st.data_ptr()] = st.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        raw = fused_sweep.equiv_raw(levels, x + 0.01, x, tables, trig, sched,
                                    tuple(z.shape), a_chunk=3)
        fused_sweep.equiv_angles(raw, trig, None, LIMS)
    measured = sum(saved.values())
    estimate = 3 * fused_sweep.recompute_bytes(sched, (64, 64))
    assert measured <= estimate <= 2 * measured, (measured, estimate)


def test_recompute_chunk_sizes_and_raises(monkeypatch):
    z, kw, _, _, _ = S["bumps"]
    args = fused_sweep.sweep_args(torch.from_numpy(z), **kw)
    plan = args[4]
    sched = fused_sweep.recompute_schedule(plan, z.shape)
    dev = torch.device("cpu")
    one = fused_sweep.recompute_chunk(sched, (32, 32), 1, args[2], dev)
    assert one == 1
    per_az = fused_sweep.recompute_bytes(sched, (32, 32))
    monkeypatch.setattr(fused_sweep, "RECOMPUTE_CPU_BYTES", 2.5 * per_az)
    # two azimuths fit: 5 azimuths in three balanced chunks of 2
    assert fused_sweep.recompute_chunk(sched, (32, 32), 5, args[2], dev) == 2
    monkeypatch.setattr(fused_sweep, "RECOMPUTE_CPU_BYTES", 0.5 * per_az)
    with pytest.raises(MemoryError, match="one azimuth"):
        fused_sweep.recompute_chunk(sched, (32, 32), 4, args[2], dev)


# ---------------------------------------------------------------------------
# Sharded
# ---------------------------------------------------------------------------

def _shard_sweep(mesh):
    def fn(z, tilt_ramp=None, mask=None, **kw):
        assert mask is None
        return shard.horizon_sweep_fused_sharded(mesh, z, tilt_ramp=tilt_ramp,
                                                 **kw)
    return fn


@pytest.mark.parametrize("n_tile,n_azim", MESHES)
def test_sharded_recompute_wide_matches_single(recompute, n_tile, n_azim):
    """A block whose schedule has a masked d2 phase: the sharded recompute
    against the single-device recompute, and its forward bit-equal."""
    mesh = _mesh(n_tile, n_azim)
    got = _grads("shard_wide", _shard_sweep(mesh))
    single = _grads("shard_wide")
    for g, s, k in zip(got, single, ("dz", "dA", "dB")):
        _close(g, s.numpy(), f"{k}")
    z, kw, ramp, _, _ = S["shard_wide"]
    rr = tuple(torch.from_numpy(r) for r in ramp)
    assert torch.equal(
        shard.horizon_sweep_fused_sharded(mesh, torch.from_numpy(z),
                                          tilt_ramp=rr, **kw),
        fused_sweep.horizon_sweep_fused(torch.from_numpy(z), tilt_ramp=rr,
                                        **kw))


def test_sharded_chunked_vjp_equals_autograd_through_the_equivalent():
    """``shard._sharded_recompute`` against autograd through
    ``shard.psh_xla_equiv`` in one graph, at the same cotangent, on
    (2, 4)."""
    mesh = _mesh(2, 4)
    z, kw, ramp, _, _ = S["shard_wide"]
    zt = torch.from_numpy(z)
    args = fused_sweep.sweep_args(zt, **kw)
    plan, trig = args[4], args[3]
    g = torch.from_numpy(np.random.default_rng(4).normal(
        0.0, 1.0, kw["inner_shape"] + (kw["azim_num"],)).astype(np.float32))
    zz = zt.clone().requires_grad_(True)
    rr = tuple(torch.from_numpy(r).requires_grad_(True) for r in ramp)
    want = torch.autograd.grad(
        shard.psh_xla_equiv(mesh, plan, trig, zz, rr), [zz, *rr], g)
    dz, dr = shard._sharded_recompute(
        mesh, zt, tuple(torch.from_numpy(r) for r in ramp), g, plan, trig,
        0.01, LIMS)
    for got, w, what in zip((dz, *dr), want, ("dz", "dA", "dB")):
        _close(got, w.numpy(), what, rtol=1e-6)


def test_sharded_multires_keeps_the_replay(monkeypatch):
    """The sharded multires entry's gradient is the replay's under the
    variable, as the reference's ``_mr_hz_sharded`` reads none."""
    from torch_scenes import sharded_scenes
    sc = sharded_scenes()
    mesh = _mesh(4, 2)
    mkw = dict(sc["mr_kw"], azim_num=8)

    def grads():
        f = torch.from_numpy(sc["z_fine"]).requires_grad_(True)
        c = torch.from_numpy(sc["z_coarse"]).requires_grad_(True)
        h = shard.horizon_sweep_multires_fused_sharded(mesh, f, c, **mkw)
        torch.mean(h ** 2).backward()
        return f.grad, c.grad

    monkeypatch.setenv("HZT_GRAD_RECOMPUTE", "1")
    got = grads()
    monkeypatch.delenv("HZT_GRAD_RECOMPUTE")
    want = grads()
    assert all(torch.equal(a, b) for a, b in zip(got, want))


_PAIR_WORKER = r"""
import sys

import numpy as np
import torch
import torch.distributed as dist

from horayzon_tpu_torch import parallel
from horayzon_tpu_torch.ops import fused_sweep
from torch_scenes import recompute_scenes

pid = int(sys.argv[1])
mesh = parallel.init_distributed(
    n_azim=2, devices=[torch.device("cpu")] * 2, backend="gloo")
assert mesh.shape == {"tile": 2, "azim": 2} and dist.get_rank() == pid
z, kw, ramp, _, _ = recompute_scenes()["shard_wide"]


def step(fn):
    zz = torch.from_numpy(z).requires_grad_(True)
    rr = tuple(torch.from_numpy(r).requires_grad_(True) for r in ramp)
    h = fn(zz, rr)
    torch.mean(h ** 2).backward()
    return h.detach(), zz.grad, rr[0].grad, rr[1].grad


got = step(lambda zz, rr: parallel.horizon_sweep_fused_sharded(
    mesh, zz, tilt_ramp=rr, **kw))
want = step(lambda zz, rr: fused_sweep.horizon_sweep_fused(
    zz, tilt_ramp=rr, **kw))
assert torch.equal(got[0], want[0])
for name, a, b in zip(("dz", "dA", "dB"), got[1:], want[1:]):
    scale = b.abs().max().item()
    err = (a - b).abs().max().item()
    assert scale > 0.0 and err <= 1e-5 * scale, (name, err, scale)
dist.destroy_process_group()
print(f"proc {pid}: RECOMPUTE-PAIR-OK", flush=True)
"""


def test_sharded_recompute_two_processes(tmp_path):
    """Two gloo processes, a (2, 2) mesh whose tile axis spans them, with
    ``HZT_GRAD_RECOMPUTE=1``: the level cotangents all-reduced, the rows'
    cotangents assembled; the forward bit-equal to one device and the
    gradients within ``1e-5 * max|g|`` of its recompute."""
    import socket

    worker = tmp_path / "pair_worker.py"
    worker.write_text(_PAIR_WORKER)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    tests_dir = os.path.dirname(os.path.abspath(__file__))
    procs = []
    for i in range(2):
        env = {k: v for k, v in os.environ.items()
               if k not in ("HZT_COORDINATOR", "HZT_NUM_PROCESSES",
                            "HZT_PROCESS_ID")}
        env.update(HZT_COORDINATOR=f"127.0.0.1:{port}", HZT_NUM_PROCESSES="2",
                   HZT_PROCESS_ID=str(i), HZT_GRAD_RECOMPUTE="1",
                   OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join(
                       [_REPO, tests_dir, os.environ.get("PYTHONPATH", "")]))
        procs.append(subprocess.Popen(
            [sys.executable, str(worker), str(i)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, env=env, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"proc {i}: RECOMPUTE-PAIR-OK" in out, (
            i, out[-3000:])


# ---------------------------------------------------------------------------
# Against the JAX package (the subprocess started by the first test)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["spike", "bumps", "masked"])
def test_recompute_matches_jax(oracle, recompute, name):
    got = _grads(name)
    out = oracle.result()
    rtol = JAX_RTOL.get(name, GRAD_RTOL)
    _close(got[0], out[f"{name}/dz"], f"{name} dz", rtol)
    if S[name][2] is not None:
        _close(got[1], out[f"{name}/da"], f"{name} dA", rtol)
        _close(got[2], out[f"{name}/db"], f"{name} dB", rtol)


@pytest.mark.parametrize("n_tile,n_azim", MESHES)
def test_sharded_recompute_matches_jax_and_single(oracle, recompute, n_tile,
                                                  n_azim):
    got = _grads("shard", _shard_sweep(_mesh(n_tile, n_azim)))
    single = _grads("shard")
    out = oracle.result()
    key = f"shard{n_tile}x{n_azim}"
    for g, s, k in zip(got, single, ("dz", "da", "db")):
        _close(g, out[f"{key}/{k}"], f"{key} {k} against JAX")
        _close(g, s.numpy(), f"{key} {k} against one device")
