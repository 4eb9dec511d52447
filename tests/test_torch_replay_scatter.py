"""The replay's exact fixed-point accumulation on the CPU
(``horayzon_tpu_torch.ops.replay``: the plain version of kernels K3 and K4,
which round the same terms to the same grid).

* The fixed-point cotangents against the same terms summed in float64:
  within the printed per-level bound (:func:`replay.level_report`) plus one
  float32 ulp of the result, and within 1e-5 of max |.| of the float32
  accumulation the replay used before.
* Accumulating the terms in another order (rows reversed, terms shuffled)
  gives bit-equal cotangents.
* All winners on one coarse cell of a 7-level pyramid, as many as the
  plan's bound ``2**c_bits`` allows: no overflow, the exact sum, in one
  word and in two.
* A deep level that needs the two-word split: within its (much smaller)
  two-word bound of the exact sum.
* A non-finite cotangent makes the level it reaches NaN over its box.
"""

import numpy as np
import pytest
import torch

from horayzon_tpu_torch.ops import fused_sweep, replay
from horayzon_tpu_torch.ops import shadow_sweep as ss

from reference_impl import gaussian_bumps_terrain


def _horizon_record(z, kw):
    args = fused_sweep.sweep_args(torch.from_numpy(z), **kw)
    raw, ids, aux = fused_sweep._ratio_plain(*args, emit_argmax=True)
    g = torch.from_numpy(np.random.default_rng(7).normal(
        size=tuple(raw.shape)).astype(np.float32))
    return ((z.shape, g, ids, aux, args[4]),
            dict(shifts=replay.horizon_shifts(args[3], args[4])))


def _record(name):
    """``(backward_replay_plain's arguments, its mode keywords)`` of a small
    case: its argmax forward's winners and a seeded cotangent."""
    if name == "bumps96":
        return _horizon_record(
            gaussian_bumps_terrain(96, 96, seed=3, amp=300.0),
            dict(offset=(32, 32), inner_shape=(32, 32), azim_num=4,
                 dist_search=2500.0, dx=25.0, dy=-25.0))
    if name == "spike_d6000":
        halo, inner = 256, 32
        z = np.zeros((inner + 2 * halo,) * 2, dtype=np.float32)
        z[halo - 96, halo + 16] = 500.0
        return _horizon_record(z, dict(
            offset=(halo, halo), inner_shape=(inner, inner), azim_num=5,
            dist_search=6000.0, dx=25.0, dy=-25.0))
    if name == "deep_dx2_d3000":
        halo, inner = 1532, 32
        z = gaussian_bumps_terrain(inner + 2 * halo, inner + 2 * halo,
                                   seed=7, amp=1200.0, dx=2.0)
        z += np.random.default_rng(5).standard_normal(z.shape).astype(
            np.float32)
        return _horizon_record(z, dict(
            offset=(halo, halo), inner_shape=(inner, inner), azim_num=4,
            dist_search=3000.0, dx=2.0, dy=-2.0))
    if name == "shadow_bumps":
        z = gaussian_bumps_terrain(128, 128, seed=5, amp=400.0)
        zt = torch.from_numpy(z)
        off, inner, dx, dy = (32, 32), (64, 64), 25.0, -25.0
        cx, cy = 0.5 * 127 * dx, 0.5 * 127 * dy
        suns = np.array([[cx + a, cy + b, c] for a, b, c in
                         [(2.0e5, 1.0e5, 2.0e4), (-1.5e5, -0.5e5, 1.2e4),
                          (0.3e5, -2.0e5, 3.0e4)]], np.float32)
        table, _ = ss.shadow_sun_table(suns, (cx, cy), dx, dy)
        z_inner = zt[off[0]:off[0] + inner[0], off[1]:off[1] + inner[1]]
        args = ss.metric_args(zt, z_inner + float(np.float32(0.05)), z_inner,
                              table, offset=off, inner_shape=inner, dx=dx,
                              dy=dy)
        met, ids, aux = ss._metric_plain(*args, grid_origin=(0.0, 0.0),
                                         emit_argmax=True)
        g = torch.from_numpy(np.random.default_rng(7).normal(
            size=tuple(met.shape)).astype(np.float32))
        return ((z.shape, g, ids, aux, args[4]),
                dict(shadow=(args[3], args[0], (0.0, 0.0))))
    raise KeyError(name)


CASES = ["bumps96", "spike_d6000", "deep_dx2_d3000", "shadow_bumps"]


def _fields(bargs, mode):
    """The replay's coefficient fields of a record, in the plain version's
    order."""
    _, g, ids, aux, plan = bargs
    shifts = replay._row_shifts(mode.get("shifts"), mode.get("shadow"))
    return replay.replay_coefficients(g, ids, aux, plan, shifts,
                                      "shadow" in mode)


def _float_sum(bargs, mode, dtype):
    """The level cotangents as the same terms summed in ``dtype``."""
    plan = bargs[4]
    cots = [torch.zeros(s, dtype=dtype) for s in
            replay.padded_level_shapes(bargs[0], plan["pads"])]
    for lvl, place, coef in _fields(bargs, mode):
        for index, term in replay.spread(plan, lvl, place, coef):
            replay.add_at(cots[lvl], index, term.to(dtype))
    return cots


@pytest.mark.parametrize("name", CASES)
def test_fixed_point_within_its_bound(name):
    bargs, mode = _record(name)
    cots, _ = replay.backward_replay_plain(*bargs, **mode)
    report = replay.level_report()
    exact = _float_sum(bargs, mode, torch.float64)
    single = _float_sum(bargs, mode, torch.float32)
    assert len(report) == len(cots) == len(exact)
    reached = 0
    for (lvl, c_bits, words, m, bound), got, want, f32 in zip(
            report, cots, exact, single):
        print(f"{name} level {lvl}: c_bits {c_bits}, {words} word(s), max "
              f"{m:.3e}, bound {bound:.3e}, error "
              f"{(got.double() - want).abs().max().item():.3e}")
        assert words == (1 if c_bits <= replay._ONE_WORD_BITS else 2)
        assert bound <= m * 2.0 ** -26
        # the float64 sum's own error, then one float32 rounding
        slack = bound + 2.0 ** (c_bits - 52) * m + np.spacing(
            want.abs().to(torch.float32).numpy()).astype(np.float64)
        assert ((got.double() - want).abs().numpy() <= slack).all()
        scale = f32.abs().max().item()
        assert (got - f32).abs().max().item() <= 1e-5 * scale
        reached += scale > 0.0
    assert reached >= (2 if name in ("spike_d6000", "deep_dx2_d3000")
                       else 1)


@pytest.mark.parametrize("order", ["rows_reversed", "terms_shuffled"])
@pytest.mark.parametrize("name", ["spike_d6000", "shadow_bumps"])
def test_order_does_not_change_the_bits(name, order):
    bargs, mode = _record(name)
    cots, _ = replay.backward_replay_plain(*bargs, **mode)
    z_shape, g, ids, aux, plan = bargs
    if order == "rows_reversed":
        rev = dict(mode)
        if "shifts" in mode:
            rev["shifts"] = mode["shifts"][::-1].copy()
        else:
            table, z_org, origin = mode["shadow"]
            rev["shadow"] = (table[::-1].copy(), z_org, origin)
        got, _ = replay.backward_replay_plain(
            z_shape, g.flip(0).contiguous(), ids.flip(0).contiguous(),
            aux.flip(0).contiguous(), plan, **rev)
    else:
        fixed, maxima = replay.LAST_LEVELS
        scales = replay.level_scales(maxima.tolist(), fixed)
        terms = [(lvl, index, term) for lvl, place, coef in
                 _fields(bargs, mode)
                 for index, term in replay.spread(plan, lvl, place, coef)]
        accs = [[torch.zeros_like(c, dtype=torch.int64)
                 for _ in range(words)] for c, (_, words) in zip(cots, fixed)]
        for k in np.random.default_rng(3).permutation(len(terms)):
            lvl, index, term = terms[k]
            for acc, q in zip(accs[lvl], replay.quantize(term, *scales[lvl])):
                replay.add_at(acc, index, q)
        got = [replay.dequantize(acc, *s) for acc, s in zip(accs, scales)]
    assert all(torch.equal(a, b) for a, b in zip(got, cots))
    assert any(c.abs().max().item() > 0.0 for c in cots)


def _one_target(a_num, sign=1.0, seed=None):
    """Every (row, cell) winner on one coarse cell: a 64^2 inner block at an
    offset of 64 on a 7-level pyramid (1 m cells, 6 km), zero shifts, every
    id the one sample of the level-6 phase, whose 64 x 64 coarse cell holds
    the whole block.  ``g`` constant (``seed`` None) or seeded."""
    inner, off = 64, 64
    z_shape = (inner + 2 * off,) * 2
    plan = fused_sweep.plan_sweep(z_shape, inner_shape=(inner, inner),
                                  offset=(off, off), dist_search=6000.0,
                                  dx=1.0, dy=-1.0, hori_acc=0.25)
    lvl, n_m, s_first, step_l, id_off = replay._mip_phases(plan)[-1]
    assert (lvl, n_m, len(plan["pads"])) == (6, 1, 7)
    shape = (a_num, inner, inner)
    ids = torch.full(shape, id_off, dtype=torch.int32)
    if seed is None:
        g = torch.full(shape, sign * 0.75, dtype=torch.float32)
    else:
        g = torch.from_numpy(np.random.default_rng(seed).normal(
            size=shape).astype(np.float32))
    cots, _ = replay.backward_replay_plain(
        z_shape, g, ids, torch.ones(shape), plan,
        shifts=np.zeros((a_num, 2), np.float32))
    s = replay._mip_s(s_first, step_l, 0, plan["consts"]["dist"])
    coef = g * float(np.float32(1.0) / s)
    return cots[lvl], coef, replay.level_report()[lvl]


@pytest.mark.parametrize("a_num, words", [(32, 1), (128, 2)])
@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_one_target_at_the_plan_bound_cannot_overflow(a_num, words, sign):
    cot, coef, (_, c_bits, n_words, m, _) = _one_target(a_num, sign)
    n = coef.numel()
    assert (n_words, 2 ** c_bits) == (words, n)
    # n equal terms of the level's largest |coefficient| on one cell: the
    # sum is n * coef exactly (n a power of two), nothing else is touched
    assert m == abs(coef[0, 0, 0].item())
    (r, c), = torch.nonzero(cot).tolist()
    assert cot[r, c].item() == n * coef[0, 0, 0].item()


def test_two_word_split_on_a_deep_level():
    cot, coef, (lvl, c_bits, words, m, bound) = _one_target(128, seed=11)
    assert words == 2 and c_bits > replay._ONE_WORD_BITS
    one_word = replay.precision_bound(m, c_bits, 1)
    assert bound < 2.0 ** -40 * one_word
    want = coef.double().sum().item()
    got = cot[torch.nonzero(cot, as_tuple=True)]
    assert got.numel() == 1
    assert abs(got.item() - want) <= bound + np.spacing(np.float32(want)) \
        + 2.0 ** (c_bits - 52) * m


def test_non_finite_coefficient_makes_its_level_nan():
    """A non-finite cotangent cannot be rounded to the grid: the level it
    reaches is NaN over its target box (the kernels do the same), the other
    levels keep their exact sums."""
    bargs, mode = _record("spike_d6000")
    z_shape, g, ids, aux, plan = bargs
    cots, _ = replay.backward_replay_plain(*bargs, **mode)
    n2 = 2 * plan["n_dense"]
    mip_cell = tuple(torch.nonzero((ids >= n2) & (ids < replay.ID_NONE))[0])
    g = g.clone()
    g[mip_cell] = float("inf")
    got, _ = replay.backward_replay_plain(z_shape, g, ids, aux, plan, **mode)
    assert torch.equal(got[0], cots[0]) and not torch.isnan(cots[1]).any()
    r0, r1, c0, c1 = replay._target_boxes(z_shape, plan, mode["shifts"])[1]
    box = torch.zeros_like(got[1], dtype=torch.bool)
    box[r0:r1, c0:c1] = True
    assert torch.isnan(got[1][box]).all() and not got[1][~box].any()
