"""K2's skips, held on the CPU through their plain models.

* The in-domain floor of level 0 (``mip.pool8_floor``) is the minimum of
  the in-domain cells of each 8 x 8 block, by brute force.
* The plain model of K2's per-warp skip test
  (``fused_sweep.warp_skip_plain`` with the ray slopes ``m``) bounds every
  live candidate of every chunk from above, for every cell and sun: safe
  and masked d1 pairs, mip phases and chunks.  A plain sweep that skips
  wherever the value-exact model allows (``shadow_sweep.metric_model``,
  re-reading h1 and re-forming v1 after a skipped chunk) is bit-equal to
  the unskipped plain sweep: metric, winner ids and D.
* With the sign-exact arm the metric is at most the exact one on every
  cell and has its sign, and each of the arm's two votes (no candidate
  positive, the cell occluded already) skips some chunk the value-exact
  vote alone would run.
* The scenes (``tests/torch_scenes.py``): random terrain with dx != dy, a
  sun below the cells (m < 0) and one near overhead (m up to 500); a flat
  pit; a far spike that the mip reads catch; low suns grazing a concave
  ridge, where parabola vertices win; near-overhead suns.
* ``shadow_metric_fused(exact_metric=False)`` on the CPU returns the exact
  plain metric; with a gradient asked it raises ``ValueError``, as the
  reference does; ``pooled`` is validated.  ``Terrain``'s codes from the
  sign-exact model metric equal those from the exact metric (the card's
  ``Terrain`` runs K2 sign-exact; the CPU's runs the plain metric, which
  ``tests/test_torch_shadow.py`` holds against the JAX package's
  ``Terrain``).
"""

import numpy as np
import pytest
import torch

from horayzon_tpu_torch import shadow
from horayzon_tpu_torch.ops import fused_sweep, mip
from horayzon_tpu_torch.ops import shadow_sweep as ss

from reference_impl import gaussian_bumps_terrain
from torch_scenes import SHADOW_SKIP_SCENES, shadow_skip_scene

ORIGIN = (0.0, 0.0)


def _args(name):
    """``metric_args`` of a shadow skip scene on the CPU."""
    z, off, inner, dx, dy, rel = shadow_skip_scene(name)
    zt = torch.from_numpy(z)
    h, w = z.shape
    c = (0.5 * (w - 1) * dx, 0.5 * (h - 1) * dy)
    suns = np.array([[c[0] + a, c[1] + b, cc] for a, b, cc in rel],
                    np.float32)
    table, _ = ss.shadow_sun_table(suns, c, dx, dy)
    z_in = zt[off[0]:off[0] + inner[0], off[1]:off[1] + inner[1]]
    return ss.metric_args(zt, z_in + float(np.float32(0.05)), z_in, table,
                          offset=off, inner_shape=inner, dx=dx, dy=dy)


def _skipping_sweep(args, emit_argmax, sign_exact, arms=None):
    """The plain sweep in the kernel's chunks, skipping where the model
    allows; asserts every live candidate of every chunk lies at or below
    its cell's bound.  ``arms``: a dict counting the chunks that skip only
    through the sign-exact arm's bound <= 0 vote ("neg") or acc > 0 vote
    ("pos").  Returns the result and the number of (cell, chunk) skips."""
    z_org, z_inner, levels, table, plan, outer = args
    pooled, floor = fused_sweep.skip_inputs(levels, plan)
    slope = ss.ray_slopes(z_org, table, plan, ORIGIN)
    open_bounds = []
    seen = {"d1": 0, "masked": 0, "mip": 0, "skips": 0}

    def hook(ev):
        if "cand_max" in ev:
            bound = open_bounds.pop()
            live = ev["cand_max"] > -3.0e38
            assert bool((ev["cand_max"][live] <= bound[live]).all()), \
                (ev["kind"], ev["row"], ev["first"])
            return None
        m = slope(ev["row"])
        bound, skip = fused_sweep.warp_skip_plain(
            ev, pooled, floor, plan, z_org, m=m, sign_exact=sign_exact)
        open_bounds.append(bound)
        seen["masked" if ev.get("masked") else ev["kind"][:3]] += 1
        seen["skips"] += int(skip.sum())
        if arms is not None:
            acc = ev["acc"]
            for arm, other in (("neg", acc > 0.0), ("pos", bound <= 0.0)):
                # the warp skips, but not without this vote
                alone = _warp_all((bound <= acc) | other)
                arms[arm] += int((skip & ~alone).sum())
        return skip

    res = fused_sweep.sweep_plain(
        z_inner, levels, plan, outer, table.shape[0],
        ss._shadow_rows(z_org, table, plan, ORIGIN), emit_argmax,
        chunk_hook=hook)
    assert not open_bounds
    assert seen["d1"] > 0 and seen["masked"] > 0 and seen["mip"] > 0, seen
    return res, seen["skips"]


def _warp_all(vote):
    """Each cell: whether every cell of its warp (32 columns) votes yes."""
    in0, in1 = vote.shape
    n_w = -(-in1 // fused_sweep.BLOCK_COLS) * fused_sweep.BLOCK_COLS
    full = torch.ones((in0, n_w), dtype=torch.bool)
    full[:, :in1] = vote
    warps = full.view(in0, -1, fused_sweep.BLOCK_COLS).all(dim=2)
    return warps.repeat_interleave(fused_sweep.BLOCK_COLS, dim=1)[:, :in1]


def test_pool8_floor_is_the_in_domain_minimum():
    lv = torch.from_numpy(gaussian_bumps_terrain(45, 70, seed=2))
    pad = 11
    level = torch.nn.functional.pad(lv, (pad,) * 4, value=mip.PAD_VALUE)
    got = mip.pool8_floor(level, pad).numpy()
    h, w = level.shape
    assert got.shape == (-(-h // 8), -(-w // 8))
    want = np.full(got.shape, -mip.PAD_VALUE, np.float32)
    for i in range(pad, h - pad):
        for j in range(pad, w - pad):
            want[i // 8, j // 8] = min(want[i // 8, j // 8], level[i, j])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", SHADOW_SKIP_SCENES)
def test_value_exact_skips_bound_every_candidate_and_keep_values(name):
    args = _args(name)
    ref = ss._metric_plain(*args, grid_origin=ORIGIN, emit_argmax=True)
    got, n_skips = _skipping_sweep(args, True, False)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert n_skips > 0
    (met, ids, aux), counts = ss.metric_model(*args, grid_origin=ORIGIN,
                                              emit_argmax=True)
    assert torch.equal(met, ref[0]) and torch.equal(ids, ref[1])
    assert torch.equal(aux, ref[2])
    plan = args[4]
    per_cell = (plan["n_dense"] - plan["nx"]
                + sum(ph[1] for ph in plan["phases_meta"][1:]))
    assert (counts["d1_taken"] + counts["d1_skipped"] + counts["mip_taken"]
            + counts["mip_skipped"]) == per_cell * met.numel()
    n2 = 2 * plan["n_dense"]
    if name == "ridge_low_sun":
        # parabola vertices win on the crest, in the d1 range
        assert int(((ref[1] >= 2 * plan["nx"]) & (ref[1] < n2)
                    & (ref[1] % 2 == 1)).sum()) > 0
    if name == "spike":
        # the far spike wins through a mip read, so some mip chunk runs
        assert int(((ref[1] >= n2) & (ref[1] < 2 ** 30)).sum()) > 0
        assert counts["mip_taken"] > 0
    if name in ("flat_pit", "overhead"):
        # every masked d1 chunk and every mip sample skipped
        assert counts["masked_d1_taken"] == counts["mip_taken"] == 0


@pytest.mark.parametrize("name", SHADOW_SKIP_SCENES)
def test_sign_exact_skips_keep_the_sign(name):
    args = _args(name)
    exact = ss._metric_plain(*args, grid_origin=ORIGIN)
    arms = {"neg": 0, "pos": 0}
    got, _ = _skipping_sweep(args, False, True, arms)
    assert bool((got <= exact).all())
    assert torch.equal(got > 0.0, exact > 0.0)
    model, counts = ss.metric_model(*args, grid_origin=ORIGIN,
                                    exact_metric=False)
    assert torch.equal(model, got)
    _, exact_counts = ss.metric_model(*args, grid_origin=ORIGIN)
    assert (counts["d1_skipped"] + counts["mip_skipped"]
            >= exact_counts["d1_skipped"] + exact_counts["mip_skipped"])
    if name == "random":
        # both votes of the sign-exact arm skip chunks of their own, and
        # the metric's value moves on some cell
        assert arms["neg"] > 0 and arms["pos"] > 0, arms
        assert not torch.equal(got, exact)


def test_sign_exact_needs_no_argmax():
    args = _args("flat_pit")
    with pytest.raises(ValueError, match="exact_metric=True"):
        ss.metric_model(*args, grid_origin=ORIGIN, emit_argmax=True,
                        exact_metric=False)


def _fused_kw(name):
    z, off, inner, dx, dy, rel = shadow_skip_scene(name)
    args = _args(name)
    kw = dict(offset=off, inner_shape=inner, dx=dx, dy=dy,
              grid_origin=ORIGIN)
    return torch.from_numpy(z), args, kw


@pytest.mark.parametrize("which", ["z_outer", "z_org_r"])
def test_exact_metric_false_with_a_gradient_raises(which):
    z, args, kw = _fused_kw("flat_pit")
    z_org = args[0].clone()
    if which == "z_outer":
        z = z.clone().requires_grad_(True)
    else:
        z_org.requires_grad_(True)
    with pytest.raises(ValueError, match="exact_metric=True"):
        ss.shadow_metric_fused(z, z_org, args[1], args[3],
                               exact_metric=False, **kw)


def test_cpu_path_returns_the_exact_metric_either_way():
    z, args, kw = _fused_kw("random")
    want = ss._metric_plain(*args, grid_origin=ORIGIN)
    levels, plan = args[2], args[4]
    pooled = fused_sweep.skip_inputs(levels, plan)
    for exact in (True, False):
        got = ss.shadow_metric_fused(z, args[0], args[1], args[3],
                                     exact_metric=exact, pyramid=levels,
                                     pooled=pooled, **kw)
        assert torch.equal(got, want)


def test_pooled_is_validated():
    z, args, kw = _fused_kw("flat_pit")
    levels, plan = args[2], args[4]
    pooled = fused_sweep.skip_inputs(levels, plan)
    with pytest.raises(ValueError, match="pyramid it was built from"):
        ss.shadow_metric_fused(z, args[0], args[1], args[3], pooled=pooled,
                               **kw)
    with pytest.raises(ValueError, match="pooled"):
        ss.shadow_metric_fused(z, args[0], args[1], args[3], pyramid=levels,
                               pooled=(pooled[0][:-1], pooled[1]), **kw)
    with pytest.raises(ValueError, match="pooled companion"):
        ss.shadow_metric_fused(z, args[0], args[1], args[3], pyramid=levels,
                               pooled=(pooled[0], pooled[1][:-1]), **kw)


def test_terrain_codes_from_the_sign_exact_metric():
    """``Terrain``'s query as the card runs it (K2 sign-exact, here its
    plain model) classifies every cell of every sun as the exact metric
    does: a low sun track over bumps, some cells occluded."""
    n, halo, dx = 120, 40, 25.0
    z = gaussian_bumps_terrain(n, n, seed=4, amp=500.0)
    x = np.arange(n, dtype=np.float32) * dx
    xx, yy = np.meshgrid(x, -x)
    inner = n - 2 * halo
    vec_norm = np.zeros((inner, inner, 3), np.float32)
    vec_norm[..., 2] = 1.0
    from horayzon_tpu_torch import auxiliary
    terrain = shadow.Terrain()
    terrain.initialise(auxiliary.rearrange_pad_buffer(xx, yy, z), n, n,
                       halo, halo, vec_norm, vec_norm,
                       np.ones((inner, inner), np.float32),
                       z[halo:-halo, halo:-halo].copy(),
                       np.ones((inner, inner), np.uint8), device="cpu")
    az = np.radians(np.linspace(0.0, 330.0, 12))
    cx, cy = terrain._center
    suns = np.stack([cx + 2e5 * np.sin(az), cy + 2e5 * np.cos(az),
                     np.full_like(az, 1.2e4)], -1).astype(np.float32)
    codes = terrain.shadow_batch(suns)
    table, near_vert = ss.shadow_sun_table(suns, terrain._center,
                                           terrain.grid.dx, terrain.grid.dy)
    f = terrain._fields
    args = ss.metric_args(terrain._z_outer, f["z_org_r"], f["z_inner_r"],
                          table, offset=terrain.offset,
                          inner_shape=terrain.comp_shape, dx=terrain.grid.dx,
                          dy=terrain.grid.dy, hori_acc=terrain.acc,
                          pyramid=terrain._levels, pooled=terrain._pooled)
    metric, _ = ss.metric_model(*args, grid_origin=terrain._grid_origin,
                                exact_metric=False, pooled=terrain._pooled)
    occluded = (metric > 0.0) & ~torch.from_numpy(near_vert)[:, None, None]
    got = shadow._classify(terrain._fields, suns, occluded, mode="shadow",
                           refrac_cor=False, ang_max=terrain.ang_max)
    assert torch.equal(got, codes)
    assert 0 < int((codes == 2).sum()) < codes.numel()
