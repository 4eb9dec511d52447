"""K1's value-exact skips, held on the CPU through their plain models.

* The pooled companions (``mip.pool8``) are bit-equal to the reference's
  ``pallas_sweep._pool8`` over the same padded levels, on the shared
  extent, for a single grid's levels and a combined multires pyramid.
* The step table (``fused_sweep.step_table``) is bit-equal to the float32
  distances the plain sweep forms, sample by sample, and to the reciprocals
  its point candidate multiplies by: integer and non-integer steps, and a
  plan with ``n_safe = n_dense - 1``.
* The plain model of the kernel's per-warp skip test
  (``fused_sweep.warp_skip_plain``) bounds every candidate of the chunk
  from above, for every cell, and a plain sweep that skips wherever the
  model allows (re-reading h1 at the table's distance) is bit-equal to the
  unskipped plain sweep: raw ratios, winner ids and D.  The scenes
  (``tests/torch_scenes.py``): random terrain at a step of 25 m and of
  24.7 m (where float32 rounds the multiples of the step), a spike just
  inside and just outside a warp's strip, a block on a plateau (terrain
  below the origins: negative numerators), a flat pit where every far
  chunk skips, and a mask; eight azimuths cover the axes and the
  diagonals.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horayzon_tpu.ops import pallas_sweep
from horayzon_tpu_torch.ops import fused_sweep, mip, multires

from reference_impl import gaussian_bumps_terrain
from torch_scenes import SKIP_SCENES, skip_scene


def _jax_pool8(levels):
    """The reference's companions of port-layout levels, cropped to the
    port's extent (its margins only serve the TPU's window copies)."""
    meta = [(0,) * 6] * len(levels)
    got = pallas_sweep._pool8([jnp.asarray(t.numpy()) for t in levels], meta)
    return [np.asarray(g)[:-(-t.shape[0] // 8), :-(-t.shape[1] // 8)]
            for g, t in zip(got, levels)]


def _combined_levels():
    z_full = gaussian_bumps_terrain(400, 400, seed=17, amp=500.0)
    zf = torch.from_numpy(np.ascontiguousarray(z_full[100:233, 100:241]))
    zc = torch.from_numpy(z_full.reshape(200, 2, 200, 2).max(axis=(1, 3)))
    return multires.multires_levels(
        zf, zc, ratio_log2=1, coarse_offset=(100, 100), dx=25.0, dy=-30.0,
        offset=(50, 54), inner_shape=(32, 32), dist_search=3000.0,
        hori_acc=2.0)


@pytest.mark.parametrize("source", ["single", "combined"])
def test_pool8_bit_equal_to_reference(source):
    if source == "single":
        z = torch.from_numpy(gaussian_bumps_terrain(77, 90, seed=4))
        plan = fused_sweep.plan_sweep((77, 90), inner_shape=(21, 30),
                                      offset=(28, 30), dist_search=9000.0,
                                      dx=25.0, dy=-25.0)
        levels = mip.padded_levels(z, plan["pads"])
    else:
        levels = _combined_levels()
    got = mip.pool8(levels)
    ref = _jax_pool8(levels)
    assert len(got) == len(levels) >= 2
    for g, r, t in zip(got, ref, levels):
        assert tuple(g.shape) == (-(-t.shape[0] // 8), -(-t.shape[1] // 8))
        np.testing.assert_array_equal(g.numpy(), r)


PLANS = {
    # outer shape, inner, offset, dist, dx
    "int_step": ((260, 250), (24, 40), (110, 100), 14000.0, 25.0),
    "dx24.7": ((260, 250), (24, 40), (110, 100), 14000.0, 24.7),
    # n_safe = n_dense - 1: an even safe run, then one masked single
    "halo34_d825": ((100, 100), (32, 32), (34, 34), 825.0, 25.0),
}


@pytest.mark.parametrize("name", PLANS)
def test_step_table_bit_equal_to_plain_distances(name):
    shape, inner, off, dist, dx = PLANS[name]
    z = torch.from_numpy(gaussian_bumps_terrain(*shape, seed=1))
    args = fused_sweep.sweep_args(z, dx=dx, dy=-dx, offset=off,
                                  inner_shape=inner, azim_num=3,
                                  dist_search=dist)
    z_org, z_inner, levels, trig, plan, outer = args[:6]
    if name == "halo34_d825":
        assert plan["n_safe"] == plan["n_dense"] - 1
    else:
        assert len(plan["phases_meta"]) > 2, plan["phases_meta"]
    row = fused_sweep._horizon_rows(z_org, trig, plan)
    seen = []

    def recording(r):
        sh_i, sh_j, point, quad = row(r)

        def rec_point(he, s):
            seen.append(s)
            return point(he, s)

        return sh_i, sh_j, rec_point, quad

    fused_sweep.sweep_plain(z_inner, levels, plan, outer, 1, recording)
    tab = fused_sweep.step_table(plan)
    s = np.array(seen)
    assert tab.dtype == np.float32 and s.dtype == np.float32
    np.testing.assert_array_equal(tab[:, 0], s)
    np.testing.assert_array_equal(tab[:, 1], np.float32(1.0) / s)


@pytest.mark.parametrize("name", SKIP_SCENES)
def test_skips_bound_every_candidate_and_keep_values(name):
    z, kw, mask = skip_scene(name)
    args = fused_sweep.sweep_args(torch.from_numpy(z), mask=mask, **kw)
    z_org, z_inner, levels, trig, plan, outer = args[:6]
    pooled, pool_min0 = fused_sweep.skip_inputs(levels, plan)
    row = fused_sweep._horizon_rows(z_org, trig, plan)
    init = None
    if mask is not None:
        init = torch.where(args[7] != 0, -3.0e38, 3.0e38).to(torch.float32)
    stats = {"d1": [0, 0], "mip": [0, 0], "mip_phase": [0, 0]}
    open_bounds = []

    def hook(ev):
        if ev.get("masked"):
            return None     # K1 runs its masked d1 pairs without a test
        if "cand_max" not in ev:
            bound, skip = fused_sweep.warp_skip_plain(ev, pooled, pool_min0,
                                                      plan, z_org)
            open_bounds.append(bound)
            stats[ev["kind"]][0] += 1
            stats[ev["kind"]][1] += int(skip.all())
            return skip
        bound = open_bounds.pop()
        live = ev["cand_max"] > -3.0e38
        assert bool((ev["cand_max"][live] <= bound[live]).all()), \
            (ev["kind"], ev["row"], ev["first"])
        return None

    ref = fused_sweep.sweep_plain(z_inner, levels, plan, outer, 8, row,
                                  emit_argmax=True, init=init)
    got = fused_sweep.sweep_plain(z_inner, levels, plan, outer, 8, row,
                                  emit_argmax=True, init=init,
                                  chunk_hook=hook)
    assert not open_bounds
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert stats["d1"][0] > 0 and stats["mip_phase"][0] > 0
    n2 = 2 * plan["n_dense"]
    if name == "flat_pit":
        # every mip phase of every row skips at once
        assert stats["mip_phase"][1] == stats["mip_phase"][0]
    if name.startswith("spike"):
        # the spike wins somewhere, through a mip read
        assert int((ref[1] >= n2).sum()) > 0
    if name in ("random", "flat_pit"):
        assert stats["d1"][1] + stats["mip_phase"][1] + stats["mip"][1] > 0
