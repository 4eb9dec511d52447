# Copyright (c) 2026
# MIT License
"""Winner-replay backward of the fused sweep: the counterpart of
``horayzon_tpu.ops.pallas_sweep.backward_replay_fn`` (horizon mode, no
tilt ramp) and of ``shadow_backward_replay_fn`` (shadow mode).

The argmax forward (``fused_sweep`` or ``shadow_sweep``,
``emit_argmax=True``) records per (azimuth or sun, inner cell) the id of the
candidate that won the running maximum and, for a parabola winner, its
stationary denominator D.  The backward replays only those winners:
envelope-theorem partials, closed-form in D, so no height is re-read.
:func:`backward_replay` returns one cotangent array per padded pyramid
level (the layout of :func:`mip.padded_levels`) and the (in0, in1)
cotangent of ``z_org``; :func:`z_cotangent` routes them to the outer
heightfield.  Two implementations of identical terms:

* kernels K3 (horizon) and K4 (shadow), ``csrc/horizon_replay_bwd.cu``
  (CUDA C++ for ``sm_90a``, a scatter driven by the winners), run for CUDA
  tensors;
* :func:`backward_replay_plain`, a scatter in plain torch vectorised over
  the inner cells, run for CPU tensors and used on the card as the
  kernels' reference.

Both accumulate the level cotangents exactly, in fixed point: every
float32 term is rounded to a per-level grid ``2**-e`` and added as int64
(two int64 words on a level whose targets can receive many terms), and the
sum is converted to float32 once.  Integer addition is associative, so the
result does not depend on the order of the terms: two kernel runs and the
plain version are bit-equal.  ``e`` is fixed before the scatter from the
largest coefficient of the level and :func:`fixed_point_levels`'s bound on
the terms one target can receive, so that no sum can overflow; the
rounding costs at most :func:`precision_bound` per target.

Both take the mode the same way: the horizon mode the per-row shifts
(:func:`horizon_shifts`) as the forward read them, the shadow mode
``shadow = (sun_table, z_org, grid_origin)``, whose shifts are the table's
columns 5-6.  The shadow mode's coefficients are bare (no ``1/s``,
``1/D``) and its z_org term is ``g * (-1 - S * dm/dz_org)``
(:func:`shadow_dmdz`, ``pallas_sweep.py:1786-1812``).

Winner ids (``pallas_sweep.py:563-857``): ``2m`` / ``2m+1`` for the point /
parabola of dense step m (a d1 pair starting at m records ``2m``,
``2(m+1)`` and parabola ``2(m+1)+1``); mip phase p counts on from
``2 * n_dense``; :data:`ID_NONE` means no winner.  Sample distances and
gates are those of the reference *backward* (``pallas_sweep.py:1864-2038``),
including its d1 parabola gate ``nx + 1 <= mm < n_dense``.

The port has no azimuth padding, so the reference's two azimuth counts
(``a_num`` rows, ``a_den`` in the angle formula, ``pallas_sweep.py:2300``)
are one: row k has angle ``2*pi*k / a_num``.
"""

import ctypes
import math

import numpy as np
import torch

from horayzon_tpu_torch.ops import _build
from horayzon_tpu_torch.ops import mip as _mip

#: No-winner id of the argmax forward (``pallas_sweep.ID_NONE``).
ID_NONE = 1 << 30
#: HZ_MAX_LEVELS of csrc/horizon_replay_bwd.cu.
_MAX_LEVELS = 32

#: Launches of kernel K3 made by this process (incremented only where the
#: wrapper launches it).
KERNEL_LAUNCHES = 0
#: Launches of kernel K4 (the shadow mode) made by this process.
SHADOW_KERNEL_LAUNCHES = 0
#: Launches of K3's shard variant (one per pass of a shard of a sharded
#: replay, :class:`ShardReplay`, and one per sharded replay for the
#: conversion of the summed words, :func:`convert`), and of K4's.
SHARD_KERNEL_LAUNCHES = 0
SHADOW_SHARD_KERNEL_LAUNCHES = 0
#: Bits of the ``passes`` of ``replay_bwd_passes_launch``
#: (csrc/horizon_replay_bwd.cu): the level maxima, the scatter, the
#: conversion of the boxes, the z_org sum.
PASS_MAX, PASS_SCATTER, PASS_CONVERT, PASS_ZORG = 1, 2, 4, 8
#: A level whose bound C on the terms per target is at most 2**18 takes one
#: int64 word: its rounding error per target, C * 2**-e / 2, is then at most
#: 2**-26 of its largest coefficient (a quarter of a float32 ulp).  Levels
#: above take two words (a 124-bit value, 62 bits each).
_ONE_WORD_BITS = 18
#: Above 2**36 terms per target even two words round by more than 2**-16
#: of the largest coefficient: refused.
_MAX_C_BITS = 36
#: ``(fixed_point_levels, maxima)`` of the last replay in this process (the
#: kernel's or the plain version's): ``maxima`` the (levels,) float32 tensor
#: of each level's largest |coefficient|, on the replay's device.  Read by
#: :func:`level_report`.
LAST_LEVELS = None


def padded_level_shapes(z_shape, pads):
    """Shapes of the padded levels of an outer grid ``z_shape``."""
    return [(h + 2 * p, w + 2 * p)
            for (h, w), p in zip(_mip.level_shapes(tuple(z_shape), len(pads)),
                                 pads)]


def _mip_phases(plan):
    """(level, n, s_first, step_l, id offset) of each mip phase."""
    out = []
    off = 2 * plan["n_dense"]
    for lvl, n_m, s_first, step_l in plan["phases_meta"][1:]:
        out.append((lvl, n_m, s_first, step_l, off))
        off += n_m
    return out


def horizon_shifts(trig, plan):
    """(A, 2) float32 row and column shifts (sh_i, sh_j) [cells per metre]
    of the horizon azimuths: ``trig / (dy, dx)`` in float32, as the
    reference forms them (``pallas_sweep.py:383-386``)."""
    f32 = np.float32
    return np.stack([trig[:, 1].astype(f32) / f32(plan["dy"]),
                     trig[:, 0].astype(f32) / f32(plan["dx"])], axis=-1)


def _row_shifts(shifts, shadow):
    """The (A, 2) float32 (sh_i, sh_j) of the replay's rows: ``shifts`` in
    the horizon mode, the sun table's columns 5-6 (the shifts K2 read) in
    the shadow mode ``shadow = (sun_table, z_org, grid_origin)``."""
    if (shifts is None) == (shadow is None):
        raise ValueError("pass the horizon shifts or the shadow inputs "
                         "(sun_table, z_org, grid_origin), exactly one")
    rows = shifts if shadow is None else shadow[0][:, 5:7]
    return np.ascontiguousarray(rows, dtype=np.float32)


def _mip_s(s_first, step_l, m, dist):
    f32 = np.float32
    return np.minimum(f32(s_first) + f32(m) * f32(step_l), dist)


def sqrt_rn(x):
    """Correctly rounded float32 square root (through float64: torch's
    float32 CPU sqrt is not always correctly rounded)."""
    return torch.sqrt(x.double()).float()


def lattice_xy(plan, grid_origin, device):
    """float32 x (in1,) of the inner block's global outer columns and y
    (in0,) of its rows (``pallas_sweep.py:355-358``)."""
    f32 = np.float32
    in0, in1 = plan["inner_shape"]
    off0, off1 = plan["offset"]
    xr = ((torch.arange(off1, off1 + in1, device=device).to(torch.float32)
           * float(f32(plan["dx"]))) + float(f32(grid_origin[0])))
    yr = ((torch.arange(off0, off0 + in0, device=device).to(torch.float32)
           * float(f32(plan["dy"]))) + float(f32(grid_origin[1])))
    return xr, yr


def shadow_dmdz(z_org, table, plan, grid_origin):
    """(T, in0, in1) derivative of each cell's ray slope ``m`` toward each
    sun w.r.t. its ray-origin height, as ``_bwd_kernel(mode="shadow")``
    forms it (``pallas_sweep.py:1801-1812``): ``-1 / dot`` where the
    horizontal advance ``adv = dot / mag`` exceeds 1e-4 (there ``m =
    szr / dot``), else ``-(sxr^2 + syr^2) / (mag^3 * 1e-4)`` (the clamped
    arm ``m = (szr / mag) / 1e-4``)."""
    xr, yr = lattice_xy(plan, grid_origin, z_org.device)
    eps = float(np.float32(1.0e-4))
    out = torch.empty((table.shape[0],) + tuple(z_org.shape),
                      dtype=torch.float32, device=z_org.device)
    for t in range(table.shape[0]):
        sun_x, sun_y, sun_z, kx_u, ky_u = (float(v) for v in table[t, :5])
        sxr = sun_x - xr
        syr = sun_y - yr
        szr = sun_z - z_org
        hor2 = (sxr * sxr)[None, :] + (syr * syr)[:, None]
        mag = sqrt_rn(hor2 + szr * szr)
        dot = (sxr * kx_u)[None, :] + (syr * ky_u)[:, None]
        out[t] = torch.where(dot / mag > eps, -1.0 / dot,
                             -hor2 / (((mag * mag) * mag) * eps))
    return out


# ---------------------------------------------------------------------------
# Fixed-point accumulation (shared by the kernels and the plain version)
# ---------------------------------------------------------------------------

def fixed_point_levels(plan, a_num, n_levels):
    """Per padded level ``(c_bits, words)``: ``2**c_bits`` bounds the terms
    one target cell of the level can receive, and ``words`` (1 or 2) is the
    number of int64 words its accumulator takes.

    Per row (azimuth or sun) a target receives at most one term per
    (sample slot, bilinear corner) on level 0 (4 * nx d2 slots, the d1
    positions, 4 corners), at most ``min(4**l, in0 * in1)`` per sample of a
    phase on mip level l, and never more than its row's winners put on the
    level (12 and 1 per cell)."""
    in0, in1 = plan["inner_shape"]
    nx, n_dense = plan["nx"], plan["n_dense"]
    cells = in0 * in1
    slots = 4 * nx + n_dense - max(nx - 2, 0)
    counts = [a_num * min(4 * slots, 12 * cells)] + [0] * (n_levels - 1)
    for lvl, n_m, _, _, _ in _mip_phases(plan):
        counts[lvl] += n_m * min(4 ** lvl, cells)
    out = []
    for lvl, c in enumerate(counts):
        if lvl:
            c = a_num * min(c, cells)
        c_bits = (c - 1).bit_length() if c > 0 else 0
        if c_bits > _MAX_C_BITS:
            raise ValueError(f"level {lvl} can receive 2**{c_bits} terms per "
                             f"cell, over the replay's 2**{_MAX_C_BITS}")
        out.append((c_bits, 1 if c_bits <= _ONE_WORD_BITS else 2))
    return out


def level_scales(maxima, fixed):
    """Per level ``(e, low_bits, words)`` from its largest |coefficient|
    ``maxima[l]`` (a float32 value) and ``fixed[l] = (c_bits, words)``:
    terms are rounded to multiples of ``2**-e``.  With ``2**E <= max <
    2**(E+1)`` one word takes ``e = 61 - c_bits - E``, so that ``2**c_bits``
    terms of at most ``2**(62 - c_bits)`` units sum to at most ``2**62``; two
    words take ``e = 123 - 2 c_bits - E`` and split each term at
    ``low_bits = 62 - c_bits`` (``csrc/horizon_replay_bwd.cu``'s
    ``level_scale``)."""
    out = []
    for m, (c_bits, words) in zip(maxima, fixed):
        ex = math.frexp(m)[1] - 1 if 0.0 < m < math.inf else 0
        if words == 1:
            out.append((61 - c_bits - ex, 0, 1))
        else:
            out.append((123 - 2 * c_bits - ex, 62 - c_bits, 2))
    return out


def precision_bound(m, c_bits, words):
    """Largest rounding error of one target cell of a level whose largest
    |coefficient| is ``m``: ``2**c_bits`` terms, each rounded by half a unit
    ``2**-e``, i.e. ``m * 2**(2 c_bits - 62)`` with one word and ``m *
    2**(3 c_bits - 124)`` with two."""
    return m * 2.0 ** ((2 * c_bits - 62) if words == 1 else (3 * c_bits - 124))


def quantize(term, e, low_bits, words):
    """The int64 word(s) of float32 ``term`` on the grid ``2**-e``:
    ``x = rint(term * 2**e)`` (exact in float64, ties to even), with two
    words ``hi = trunc(x * 2**-low_bits)`` and ``x - hi * 2**low_bits``."""
    x = torch.round(term.double() * 2.0 ** e)
    if words == 1:
        return (x.to(torch.int64),)
    hi = torch.trunc(x * 2.0 ** -low_bits)
    return hi.to(torch.int64), (x - hi * 2.0 ** low_bits).to(torch.int64)


def dequantize(acc, e, low_bits, words):
    """float32 value of the accumulated word(s) ``acc``, rounded once from
    float64 as the kernel rounds it."""
    v = acc[0].double()
    if words == 2:
        v = v * 2.0 ** low_bits + acc[1].double()
    return (v * 2.0 ** -e).float()


def level_report():
    """Rows ``(level, c_bits, words, max |coefficient|, precision bound)``
    of the last replay run in this process."""
    fixed, maxima = LAST_LEVELS
    return [(lvl, c_bits, words, m, precision_bound(m, c_bits, words))
            for lvl, ((c_bits, words), m) in enumerate(zip(fixed,
                                                           maxima.tolist()))]


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

def _envelope(kind, qt):
    """Envelope polynomial of a parabola's sample ``kind`` (0 at s0, 1 in
    the middle, 2 at the far end) in q*t* (``pallas_sweep.py:1910-1914``)."""
    qt2 = qt * qt
    if kind == 0:
        return 2.0 * qt2 - 3.0 * qt + 1.0
    if kind == 1:
        return 4.0 * qt - 4.0 * qt2
    return 2.0 * qt2 - qt


def replay_coefficients(graw, ids, aux, plan, shifts, bare):
    """Every coefficient field of the replay, row by row: yields ``(lvl,
    place, coef)`` with ``coef`` an (in0, in1) float32 field, 0 where the
    cell's winner does not use this sample, and ``place`` either ``(s,
    sh_i, sh_j)`` for a level-0 sample at distance s (spread onto its
    bilinear corners by :func:`spread`) or the ``(rows, cols)`` index
    tensors of the coarse cells on mip level ``lvl``.  ``bare``: the shadow
    mode's coefficients (g instead of g / s, g / D).  Each field is formed
    with the kernels' float32 operations in their order; a d1 position's
    field adds the point's and up to three parabolas' terms, of which each
    cell has at most one that is not 0."""
    f32 = np.float32
    k = plan["consts"]
    in0, in1 = plan["inner_shape"]
    off0, off1 = plan["offset"]
    nx, n_dense, pads = plan["nx"], plan["n_dense"], plan["pads"]
    dev = graw.device
    rows = torch.arange(off0, off0 + in0, device=dev)
    cols = torch.arange(off1, off1 + in1, device=dev)
    step = k["step"]
    for az in range(shifts.shape[0]):
        sh_i, sh_j = f32(shifts[az, 0]), f32(shifts[az, 1])
        g, idv, ax = graw[az], ids[az], aux[az]

        def per_s(coef, s):
            """A point winner's coefficient at distance s from ``where(
            winner, g, 0)``: horizon g / s, shadow g."""
            return coef if bare else coef * float(f32(1.0) / s)

        def quad_coef(m):
            """g / D (shadow: g) of the parabola winners 2m+1 (D > 1e-3),
            else 0."""
            ok = (idv == 2 * m + 1) & (ax > 1e-3)
            if bare:
                return torch.where(ok, g, 0.0)
            inv_d = torch.where(ok, 1.0 / torch.where(ok, ax, 1.0), 0.0)
            return torch.where(ok, g, 0.0) * inv_d

        # d2 near field (pallas_sweep.py:1864-1936)
        for m in range(nx):
            s = f32(m + 1) * step
            pm = idv == 2 * m
            if bool(pm.any()):
                yield 0, (s, sh_i, sh_j), per_s(torch.where(pm, g, 0.0), s)
            if bool((idv == 2 * m + 1).any()):
                gq = quad_coef(m)
                s0 = f32(m) * step
                qt = float(k["inv_l0"]) * (ax - float(s0))
                for kind, sk in enumerate((s0, s0 + k["half_step"],
                                           s0 + step)):
                    yield 0, (sk, sh_i, sh_j), gq * _envelope(kind, qt)

        # d1 mid field, merged per position q (pallas_sweep.py:1944-2005)
        for q in range(max(nx - 2, 0), n_dense):
            s = f32(q + 1) * step
            hit = (idv >= 2 * q) & (idv <= 2 * q + 5)
            if not bool(hit.any()):
                continue
            coef = per_s(torch.where((idv == 2 * q) & (q >= nx), g, 0.0), s)
            for off in range(3):
                mm = q + off
                if nx + 1 <= mm < n_dense:
                    s0 = f32(mm - 1) * step
                    qt = float(k["inv_l1"]) * (ax - float(s0))
                    coef = coef + quad_coef(mm) * _envelope(2 - off, qt)
            yield 0, (s, sh_i, sh_j), coef

        # mip phases: g / s (shadow: g) on the coarse cell
        # (pallas_sweep.py:2024-2038, 2080-2083)
        for lvl, n_m, s_first, step_l, id_off in _mip_phases(plan):
            kp = 2 ** lvl
            for m in range(n_m):
                pm = idv == id_off + m
                if not bool(pm.any()):
                    continue
                s = _mip_s(s_first, step_l, m, k["dist"])
                ri = int(np.rint(s * sh_i))
                rj = int(np.rint(s * sh_j))
                r = torch.div(rows + ri, kp, rounding_mode="floor") + pads[lvl]
                c = torch.div(cols + rj, kp, rounding_mode="floor") + pads[lvl]
                yield lvl, (r[:, None], c[None, :]), per_s(
                    torch.where(pm, g, 0.0), s)


def spread(plan, lvl, place, coef):
    """The terms of one coefficient field: yields ``(index, term)`` into
    level ``lvl``'s padded array.  A level-0 sample's four bilinear
    corners, each a slice of the level, ``coef * w_i * w_j``
    (``pallas_sweep.py:1841-1844``); a mip sample, the coefficient itself
    at its index tensors."""
    if lvl:
        yield place, coef
        return
    f32 = np.float32
    s, sh_i, sh_j = place
    in0, in1 = plan["inner_shape"]
    off0, off1 = plan["offset"]
    pad0 = plan["pads"][0]
    dif, djf = s * sh_i, s * sh_j
    di, dj = np.floor(dif), np.floor(djf)
    fi, fj = dif - di, djf - dj
    r = off0 + int(di) + pad0
    c = off1 + int(dj) + pad0
    for ci, wi in ((0, f32(1.0) - fi), (1, fi)):
        for cj, wj in ((0, f32(1.0) - fj), (1, fj)):
            yield ((slice(r + ci, r + ci + in0), slice(c + cj, c + cj + in1)),
                   coef * float(wi) * float(wj))


def add_at(acc, index, val):
    """``acc[index] += val`` for a slice index (level 0) or with
    ``index_put_(accumulate=True)`` for index tensors (mip levels)."""
    if isinstance(index[0], slice):
        acc[index] += val
    else:
        acc.index_put_(index, val, accumulate=True)


def _zorg_plain(graw, ids, aux, plan, dmdz, zcot=None):
    """The z_org cotangent: each cell's winner's term at S (a point's s, a
    parabola's D, a mip sample's s), horizon ``-(g * (1 / S))``, shadow
    ``g * (-1 - S * dmdz)``, summed over the rows in order
    (``pallas_sweep.py:1871-1877, 1901-1915, 1974, 2087``), onto ``zcot``
    (a copy of it) when given."""
    k = plan["consts"]
    nx, n_dense = plan["nx"], plan["n_dense"]
    if zcot is None:
        zcot = torch.zeros(tuple(graw.shape[1:]), dtype=torch.float32,
                           device=graw.device)
    else:
        zcot = zcot.clone()
    tables = [(id_off, n_m, torch.from_numpy(np.asarray(_mip_s(
        s_first, step_l, np.arange(n_m), k["dist"]), dtype=np.float32)).to(
            graw.device)) for _, n_m, s_first, step_l, id_off in
        _mip_phases(plan)]
    for az in range(graw.shape[0]):
        g, idv, ax = graw[az], ids[az], aux[az]
        m = idv >> 1
        dense = idv < 2 * n_dense
        point = dense & (idv % 2 == 0)
        # the d1 gate drops the parabola at m == nx
        valid = point | (dense & (idv % 2 == 1) & (m != nx) & (ax > 1e-3))
        s = torch.where(point, (m + 1).to(torch.float32) * float(k["step"]),
                        ax)
        for id_off, n_m, table in tables:
            sel = (idv >= id_off) & (idv < id_off + n_m)
            if bool(sel.any()):
                s = torch.where(sel, table[(idv - id_off).clamp(0, n_m - 1)
                                           .long()], s)
                valid = valid | sel
        if dmdz is None:
            term = -(g * (1.0 / s))
        else:
            term = g * (-1.0 - s * dmdz[az])
        zcot += torch.where(valid, term, 0.0)
    return zcot


def box_layout(boxes, fixed):
    """``(cell_off, acc_off)``: the first cell of each level's box among
    all boxes and the first int64 word of its accumulator, one entry more
    than levels (the totals last), in the layout the kernels and
    :func:`replay_words` share: every box row-major, ``words`` int64 per
    cell."""
    cells = [(r1 - r0) * (c1 - c0) for r0, r1, c0, c1 in boxes]
    words = [n * w for n, (_, w) in zip(cells, fixed)]
    return (np.cumsum([0] + cells).tolist(),
            np.cumsum([0] + words).tolist())


def replay_maxima(graw, ids, aux, plan, shifts=None, shadow=None):
    """(levels,) float32: each level's largest |coefficient| over the
    record (the first pass of the replay)."""
    shifts = _row_shifts(shifts, shadow)
    maxima = torch.zeros(len(plan["pads"]), dtype=torch.float32,
                         device=graw.device)
    for lvl, _, coef in replay_coefficients(graw, ids, aux, plan, shifts,
                                            shadow is not None):
        maxima[lvl] = torch.maximum(maxima[lvl], coef.abs().amax())
    return maxima


def replay_words(z_shape, graw, ids, aux, plan, fixed, maxima, boxes,
                 shifts=None, shadow=None):
    """The record's terms rounded to the fixed-point grid of ``fixed`` and
    ``maxima`` (:func:`level_scales`) and summed as int64 over ``boxes``:
    a flat int64 tensor in :func:`box_layout`'s layout (the second pass).
    ``boxes`` must hold every target of the record."""
    shifts = _row_shifts(shifts, shadow)
    shapes = padded_level_shapes(z_shape, plan["pads"])
    scales = level_scales(maxima.tolist(), fixed)
    dev = graw.device
    accs = [[torch.zeros(shape, dtype=torch.int64, device=dev)
             for _ in range(words)]
            for shape, (_, words) in zip(shapes, fixed)]
    for lvl, place, coef in replay_coefficients(graw, ids, aux, plan, shifts,
                                                shadow is not None):
        for index, term in spread(plan, lvl, place, coef):
            for acc, q in zip(accs[lvl], quantize(term, *scales[lvl])):
                add_at(acc, index, q)
    out = [torch.stack([a[r0:r1, c0:c1] for a in acc], dim=-1).reshape(-1)
           for acc, (r0, r1, c0, c1) in zip(accs, boxes)]
    return torch.cat(out) if out else torch.zeros(0, dtype=torch.int64)


def convert_words(z_shape, plan, words, boxes, fixed, maxima):
    """The level cotangents from the accumulated ``words`` of ``boxes``
    (:func:`box_layout`), each cell rounded once to float32; a level with a
    non-finite coefficient is NaN over its box (the third pass).  Cells
    outside the boxes are 0."""
    shapes = padded_level_shapes(z_shape, plan["pads"])
    scales = level_scales(maxima.tolist(), fixed)
    _, acc_off = box_layout(boxes, fixed)
    cots = []
    for lvl, (shape, (r0, r1, c0, c1), (_, n_w)) in enumerate(
            zip(shapes, boxes, fixed)):
        cot = torch.zeros(shape, dtype=torch.float32, device=words.device)
        box = words[acc_off[lvl]:acc_off[lvl + 1]].view(r1 - r0, c1 - c0,
                                                        n_w)
        cot[r0:r1, c0:c1] = dequantize(box.unbind(-1), *scales[lvl])
        if not math.isfinite(float(maxima[lvl])):
            cot[r0:r1, c0:c1] = math.nan
        cots.append(cot)
    return cots


def backward_replay_plain(z_shape, graw, ids, aux, plan, shifts=None,
                          shadow=None):
    """Winner replay in plain torch: per row and sample, the winners'
    coefficients as (in0, in1) fields (:func:`replay_coefficients`), their
    terms (:func:`spread`) rounded to the level's fixed-point grid and
    added as int64 into shifted slices of level 0 (bilinear corners) or,
    on mip levels, with ``index_put_(accumulate=True)``; a first pass over
    the same fields finds each level's largest |coefficient|, which fixes
    the grid (:func:`level_scales`).  The passes are :func:`replay_maxima`,
    :func:`replay_words`, :func:`convert_words` and the z_org sum, the
    kernels' four.

    ``graw``/``aux`` (A, in0, in1) float32, ``ids`` (A, in0, in1) int32 on
    one device; ``plan`` from :func:`fused_sweep.plan_sweep` (its
    ``consts`` are the float32 scalars the forward used).  The mode, as
    :func:`backward_replay` takes it: ``shifts`` the (A, 2) float32 host
    table of (sh_i, sh_j) of the horizon azimuths, or ``shadow = (sun_table,
    z_org, grid_origin)``, with bare coefficients and the z_org term ``g *
    (-1 - S * dmdz)`` (:func:`shadow_dmdz`).  A level with a non-finite
    coefficient is NaN over its target box.  Returns ``(level_cots,
    zcot)``."""
    global LAST_LEVELS
    rows = _row_shifts(shifts, shadow)
    fixed = fixed_point_levels(plan, rows.shape[0], len(plan["pads"]))
    boxes = _target_boxes(z_shape, plan, rows)
    maxima = replay_maxima(graw, ids, aux, plan, shifts, shadow)
    words = replay_words(z_shape, graw, ids, aux, plan, fixed, maxima, boxes,
                         shifts, shadow)
    cots = convert_words(z_shape, plan, words, boxes, fixed, maxima)
    LAST_LEVELS = (fixed, maxima)
    return cots, zorg_plain(graw, ids, aux, plan, shadow)


def zorg_plain(graw, ids, aux, plan, shadow=None, zcot=None):
    """The z_org cotangent in plain torch (the fourth pass); ``zcot``: the
    running sum to continue (the rows before this record's), else 0."""
    dmdz = None if shadow is None else shadow_dmdz(shadow[1], shadow[0],
                                                   plan, shadow[2])
    return _zorg_plain(graw, ids, aux, plan, dmdz, zcot)


# ---------------------------------------------------------------------------
# Kernels K3 and K4 (csrc/horizon_replay_bwd.cu)
# ---------------------------------------------------------------------------

class _BwdParams(ctypes.Structure):
    """Mirror of ``struct BwdParams`` in csrc/horizon_replay_bwd.cu."""
    _fields_ = (
        [("ids", ctypes.c_void_p), ("g", ctypes.c_void_p),
         ("aux", ctypes.c_void_p), ("shift", ctypes.c_void_p),
         ("sun", ctypes.c_void_p), ("z_org", ctypes.c_void_p),
         ("zcot", ctypes.c_void_p), ("acc", ctypes.c_void_p),
         ("lvl_max", ctypes.c_void_p), ("cot", ctypes.c_void_p * _MAX_LEVELS),
         ("acc_off", ctypes.c_longlong * _MAX_LEVELS)]
        + [(n, ctypes.c_int * _MAX_LEVELS)
           for n in ("lvl_w", "lvl_pad", "box_r0", "box_r1", "box_c0",
                     "box_c1", "cell_off", "lvl_cbits", "lvl_words", "ph_lvl",
                     "ph_n")]
        + [(n, ctypes.c_float * _MAX_LEVELS)
           for n in ("ph_s_first", "ph_step")]
        + [(n, ctypes.c_int)
           for n in ("n_phases", "in0", "in1", "a_num", "off0", "off1", "nx",
                     "n_dense", "n_cells")]
        + [(n, ctypes.c_float)
           for n in ("dx", "dy", "step", "dist", "half_step", "inv_l0",
                     "inv_l1", "x0", "y0")]
        + [("zcot_continue", ctypes.c_int)])


def _kernel_lib():
    """The loaded library of K3 and K4 (built with nvcc on first use)."""
    lib = _build.load("horizon_replay_bwd")
    for fn in (lib.horizon_replay_bwd_launch, lib.shadow_replay_bwd_launch):
        fn.argtypes = [ctypes.POINTER(_BwdParams), ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.replay_bwd_passes_launch.argtypes = [
        ctypes.POINTER(_BwdParams), ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    lib.replay_bwd_passes_launch.restype = ctypes.c_int
    lib.horizon_replay_bwd_error_string.argtypes = [ctypes.c_int]
    lib.horizon_replay_bwd_error_string.restype = ctypes.c_char_p
    lib.horizon_replay_bwd_params_size.argtypes = []
    lib.horizon_replay_bwd_params_size.restype = ctypes.c_int
    size = lib.horizon_replay_bwd_params_size()
    if size != ctypes.sizeof(_BwdParams):
        raise RuntimeError(f"BwdParams is {size} bytes in the kernel but "
                           f"{ctypes.sizeof(_BwdParams)} in _BwdParams")
    return lib


def _target_boxes(z_shape, plan, shifts):
    """Per level, the box ``(r0, r1, c0, c1)`` of padded-level cells that a
    sample of the sweep can touch (empty ``(0, 0, 0, 0)`` for a level no
    phase reads).  Computed from the (A, 2) float32 ``shifts`` the kernels
    read, widened by one cell and clipped to the level."""
    f32 = np.float32
    k = plan["consts"]
    in0, in1 = plan["inner_shape"]
    off0, off1 = plan["offset"]
    nx, n_dense, step = plan["nx"], plan["n_dense"], k["step"]
    sh_i = shifts[:, 0:1].astype(f32)
    sh_j = shifts[:, 1:2].astype(f32)
    shapes = padded_level_shapes(z_shape, plan["pads"])
    boxes = [(0, 0, 0, 0)] * len(shapes)

    def clip(lvl, r0, r1, c0, c1):
        h, w = shapes[lvl]
        return (max(r0, 0), min(r1, h), max(c0, 0), min(c1, w))

    # level 0: every sample distance of the d2 and d1 replay
    m = np.arange(nx, dtype=f32)
    s0 = m * step
    dense = np.concatenate([(m + f32(1)) * step, s0, s0 + k["half_step"],
                            s0 + step,
                            (np.arange(max(nx - 2, 0), n_dense, dtype=f32)
                             + f32(1)) * step]).astype(f32)[None, :]
    if dense.size:
        di = np.floor(dense * sh_i).astype(np.int64)
        dj = np.floor(dense * sh_j).astype(np.int64)
        p0 = plan["pads"][0]
        boxes[0] = clip(0, off0 + p0 + int(di.min()) - 1,
                        off0 + p0 + in0 + int(di.max()) + 2,
                        off1 + p0 + int(dj.min()) - 1,
                        off1 + p0 + in1 + int(dj.max()) + 2)
    for lvl, n_m, s_first, step_l, _ in _mip_phases(plan):
        s = _mip_s(s_first, step_l, np.arange(n_m), k["dist"]).astype(f32)
        ri = np.rint(s[None, :] * sh_i).astype(np.int64)
        rj = np.rint(s[None, :] * sh_j).astype(np.int64)
        kp, pad = 2 ** lvl, plan["pads"][lvl]
        box = ((off0 + int(ri.min())) // kp + pad - 1,
               (off0 + in0 - 1 + int(ri.max())) // kp + pad + 2,
               (off1 + int(rj.min())) // kp + pad - 1,
               (off1 + in1 - 1 + int(rj.max())) // kp + pad + 2)
        old = boxes[lvl]
        if old[1] > old[0]:
            box = (min(box[0], old[0]), max(box[1], old[1]),
                   min(box[2], old[2]), max(box[3], old[3]))
        boxes[lvl] = clip(lvl, *box)
    return boxes


def _table_to(table, dev):
    """A small float32 host table on the card, staged in pinned memory and
    copied without waiting for the stream (a copy from pageable memory
    would make the host wait for the kernels already queued)."""
    return torch.from_numpy(np.ascontiguousarray(table, dtype=np.float32)) \
        .pin_memory().to(dev, non_blocking=True)


def _check_record(graw, ids, aux, a_num, plan, shadow):
    """The record and (shadow) the sun table and z_org as the kernels take
    them."""
    dev = graw.device
    in0, in1 = plan["inner_shape"]
    checks = [(graw, torch.float32, (a_num, in0, in1)),
              (ids, torch.int32, (a_num, in0, in1)),
              (aux, torch.float32, (a_num, in0, in1))]
    if shadow is not None:
        table, z_org, _ = shadow
        checks.append((z_org, torch.float32, (in0, in1)))
        if table.shape != (a_num, 8):
            raise ValueError(f"K4 takes a ({a_num}, 8) sun table, got "
                             f"{table.shape}")
    for t, dt, shape in checks:
        if (t.device != dev or t.dtype != dt or not t.is_contiguous()
                or tuple(t.shape) != shape):
            raise ValueError("the replay kernels take contiguous (A, in0, "
                             "in1) float32 graw/aux, int32 ids and an (in0, "
                             "in1) float32 z_org on one CUDA device")


def _bwd_params(z_shape, plan, fixed, boxes, dev, record=None, rows=None,
                shadow=None):
    """``BwdParams`` of a launch: the levels' layout, ``boxes`` and the
    fixed-point words of ``fixed`` in :func:`box_layout`, and, with
    ``record = (graw, ids, aux)``, the record, its rows of the shift table
    ``rows`` and (K4) the ``shadow`` inputs.  The outputs (``acc``,
    ``lvl_max``, ``cot``, ``zcot``) are left for the caller; the structure
    keeps the tables it stages alive (``prm.keep``)."""
    shapes = padded_level_shapes(z_shape, plan["pads"])
    phases = plan["phases_meta"]
    if len(shapes) > _MAX_LEVELS or len(phases) > _MAX_LEVELS:
        raise ValueError(f"at most {_MAX_LEVELS} pyramid levels")
    prm = _BwdParams()
    prm.keep = []
    if record is not None:
        graw, ids, aux = record
        prm.ids, prm.g = ids.data_ptr(), graw.data_ptr()
        prm.aux = aux.data_ptr()
        prm.keep.append(_table_to(rows, dev))
        prm.shift = prm.keep[-1].data_ptr()
        prm.a_num = rows.shape[0]
        prm.in0, prm.in1 = plan["inner_shape"]
        if shadow is not None:
            table, z_org, grid_origin = shadow
            prm.keep.append(_table_to(table, dev))
            prm.sun, prm.z_org = prm.keep[-1].data_ptr(), z_org.data_ptr()
            prm.x0, prm.y0 = np.float32(grid_origin[0]), np.float32(
                grid_origin[1])
    cell_off, acc_off = box_layout(boxes, fixed)
    for lvl, (shape, box, (c_bits, n_words)) in enumerate(zip(shapes, boxes,
                                                             fixed)):
        prm.lvl_w[lvl] = shape[1]
        prm.lvl_pad[lvl] = plan["pads"][lvl]
        (prm.box_r0[lvl], prm.box_r1[lvl], prm.box_c0[lvl],
         prm.box_c1[lvl]) = box
        prm.cell_off[lvl] = cell_off[lvl]
        prm.acc_off[lvl] = acc_off[lvl]
        prm.lvl_cbits[lvl], prm.lvl_words[lvl] = c_bits, n_words
    prm.n_cells = cell_off[-1]
    prm.n_words = acc_off[-1]
    for p, (lvl, n_m, s_first, step_l) in enumerate(phases):
        prm.ph_lvl[p], prm.ph_n[p] = lvl, n_m
        prm.ph_s_first[p], prm.ph_step[p] = s_first, step_l
    prm.n_phases = len(phases)
    prm.off0, prm.off1 = plan["offset"]
    prm.nx, prm.n_dense = plan["nx"], plan["n_dense"]
    prm.dx, prm.dy = np.float32(plan["dx"]), np.float32(plan["dy"])
    for n in ("step", "dist", "half_step", "inv_l0", "inv_l1"):
        setattr(prm, n, plan["consts"][n])
    return prm


def _set_cots(prm, cots):
    for lvl, t in enumerate(cots):
        prm.cot[lvl] = t.data_ptr()


def _launch(prm, n_levels, shadow, dev, passes=None):
    """Launch the replay's ``passes`` (all four when None) on the current
    stream of ``dev``; raise if the launch fails."""
    lib = _kernel_lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    if passes is None:
        entry = (lib.shadow_replay_bwd_launch if shadow
                 else lib.horizon_replay_bwd_launch)
        err = entry(ctypes.byref(prm), n_levels, dev.index, stream)
    else:
        err = lib.replay_bwd_passes_launch(ctypes.byref(prm), n_levels,
                                           int(shadow), passes, dev.index,
                                           stream)
    if err != 0:
        msg = lib.horizon_replay_bwd_error_string(err).decode()
        raise RuntimeError(f"horizon_replay_bwd kernel launch failed: {msg}")


def _bwd_cuda(z_shape, graw, ids, aux, plan, shifts=None, shadow=None):
    """``(level_cots, zcot)`` from kernel K3 on ``graw``'s card (the mode
    given by ``shifts``); with ``shadow = (sun_table, z_org, grid_origin)``
    from kernel K4, which also reads the (T, 8) table and the (in0, in1)
    ray origins."""
    global KERNEL_LAUNCHES, SHADOW_KERNEL_LAUNCHES, LAST_LEVELS
    dev = graw.device
    in0, in1 = plan["inner_shape"]
    rows = _row_shifts(shifts, shadow)
    _check_record(graw, ids, aux, rows.shape[0], plan, shadow)
    shapes = padded_level_shapes(z_shape, plan["pads"])
    fixed = fixed_point_levels(plan, rows.shape[0], len(shapes))
    boxes = _target_boxes(z_shape, plan, rows)
    prm = _bwd_params(z_shape, plan, fixed, boxes, dev, (graw, ids, aux),
                      rows, shadow)
    cots = [torch.zeros(s, dtype=torch.float32, device=dev) for s in shapes]
    zcot = torch.empty((in0, in1), dtype=torch.float32, device=dev)
    # the fixed-point accumulators of every level's box, one after another,
    # and the bits of each level's largest |coefficient|
    acc = torch.zeros(max(prm.n_words, 1), dtype=torch.int64, device=dev)
    lvl_max = torch.zeros(_MAX_LEVELS, dtype=torch.int32, device=dev)
    prm.acc, prm.lvl_max = acc.data_ptr(), lvl_max.data_ptr()
    prm.zcot = zcot.data_ptr()
    _set_cots(prm, cots)
    _launch(prm, len(shapes), shadow is not None, dev)
    if shadow is None:
        KERNEL_LAUNCHES += 1
    else:
        SHADOW_KERNEL_LAUNCHES += 1
    LAST_LEVELS = (fixed, lvl_max[:len(shapes)].view(torch.float32))
    return cots, zcot


# ---------------------------------------------------------------------------
# Sharded replay (the shard variants of K3 and K4)
# ---------------------------------------------------------------------------

def _count_shard(shadow):
    global SHARD_KERNEL_LAUNCHES, SHADOW_SHARD_KERNEL_LAUNCHES
    if shadow:
        SHADOW_SHARD_KERNEL_LAUNCHES += 1
    else:
        SHARD_KERNEL_LAUNCHES += 1


class ShardReplay:
    """One shard's part of a sharded winner replay (the reference's
    ``backward_replay_fn`` / ``shadow_backward_replay_fn`` with a
    ``shard_off``, ``pallas_sweep.py:2238-2364, 2399-2482``).

    ``graw``, ``ids``, ``aux``: the shard's record (its azimuths or suns,
    its rows); ``plan``: its plan (``fused_sweep.shard_plan``); ``shifts``
    its rows of the shift table, or ``shadow = (sun_table, z_org,
    grid_origin)`` with its rows of ``z_org``; ``fixed``: the whole run's
    :func:`fixed_point_levels`.  The passes run one at a time, so that the
    shards of a run agree the fixed-point grid before any of them scatters:
    :meth:`maxima`, then :meth:`words` with the whole run's maxima (int64
    words of the shard's own target boxes, :attr:`boxes`, in global padded
    coordinates), and :meth:`zorg`.  On a CUDA record each pass is a launch
    of K3 or K4's shard variant (``replay_bwd_passes_launch``, counted in
    :data:`SHARD_KERNEL_LAUNCHES` / :data:`SHADOW_SHARD_KERNEL_LAUNCHES`),
    on a CPU record its plain version."""

    def __init__(self, z_shape, graw, ids, aux, plan, fixed, shifts=None,
                 shadow=None):
        self.z_shape, self.plan, self.fixed = tuple(z_shape), plan, fixed
        self.record = (graw, ids, aux)
        self.shifts, self.shadow = shifts, shadow
        rows = _row_shifts(shifts, shadow)
        self.boxes = _target_boxes(z_shape, plan, rows)
        self.n_levels = len(plan["pads"])
        self.dev = graw.device
        if graw.is_cuda:
            _check_record(graw, ids, aux, rows.shape[0], plan, shadow)
            self.prm = _bwd_params(z_shape, plan, fixed, self.boxes, self.dev,
                                   self.record, rows, shadow)
            self.lvl_max = torch.zeros(_MAX_LEVELS, dtype=torch.int32,
                                       device=self.dev)
            self.prm.lvl_max = self.lvl_max.data_ptr()

    def _run(self, passes):
        _launch(self.prm, self.n_levels, self.shadow is not None, self.dev,
                passes)
        _count_shard(self.shadow is not None)

    def maxima(self):
        """(levels,) float32: each level's largest |coefficient| of this
        shard's record."""
        if self.dev.type != "cuda":
            return replay_maxima(*self.record, self.plan, self.shifts,
                                 self.shadow)
        self.lvl_max.zero_()
        self._run(PASS_MAX)
        return self.lvl_max[:self.n_levels].view(torch.float32).clone()

    def words(self, maxima):
        """The shard's terms on the grid of the whole run's ``maxima``,
        summed as int64 over :attr:`boxes` (:func:`box_layout`)."""
        if self.dev.type != "cuda":
            return replay_words(self.z_shape, *self.record, self.plan,
                                self.fixed, maxima, self.boxes, self.shifts,
                                self.shadow)
        self.lvl_max[:self.n_levels] = maxima.to(self.dev).view(torch.int32)
        acc = torch.zeros(max(self.prm.n_words, 1), dtype=torch.int64,
                          device=self.dev)
        self.prm.acc = acc.data_ptr()
        self._run(PASS_SCATTER)
        return acc[:self.prm.n_words]

    def zorg(self, zcot=None):
        """The z_org cotangent of the shard's rows, summed over its rows of
        the record in order onto ``zcot`` (the sum of the rows before
        them) when given."""
        if self.dev.type != "cuda":
            return zorg_plain(*self.record, self.plan, self.shadow,
                              None if zcot is None else zcot.to(self.dev))
        out = (torch.empty(self.plan["inner_shape"], dtype=torch.float32,
                           device=self.dev) if zcot is None
               else zcot.to(self.dev, copy=True).contiguous())
        self.prm.zcot, self.prm.zcot_continue = out.data_ptr(), int(
            zcot is not None)
        self._run(PASS_ZORG)
        return out


def add_words(dst, dst_boxes, src, src_boxes, fixed):
    """``dst += src`` of two accumulators of :func:`box_layout`, ``src``'s
    boxes inside ``dst``'s: exact (integer addition)."""
    _, d_off = box_layout(dst_boxes, fixed)
    _, s_off = box_layout(src_boxes, fixed)
    src = src.to(dst.device)
    for lvl, (db, sb, (_, n_w)) in enumerate(zip(dst_boxes, src_boxes,
                                                 fixed)):
        if sb[1] <= sb[0] or sb[3] <= sb[2]:
            continue
        if sb[0] < db[0] or sb[1] > db[1] or sb[2] < db[2] or sb[3] > db[3]:
            raise ValueError(f"level {lvl}: box {sb} is not inside {db}")
        d = dst[d_off[lvl]:d_off[lvl + 1]].view(db[1] - db[0], db[3] - db[2],
                                                n_w)
        d[sb[0] - db[0]:sb[1] - db[0], sb[2] - db[2]:sb[3] - db[2]] += \
            src[s_off[lvl]:s_off[lvl + 1]].view(sb[1] - sb[0], sb[3] - sb[2],
                                               n_w)


def convert(z_shape, plan, words, boxes, fixed, maxima, shadow=False):
    """:func:`convert_words` of a sharded replay's summed words: on a CUDA
    tensor the conversion pass of K3 (``shadow``: K4), once."""
    if words.device.type != "cuda":
        return convert_words(z_shape, plan, words, boxes, fixed, maxima)
    dev = words.device
    shapes = padded_level_shapes(z_shape, plan["pads"])
    prm = _bwd_params(z_shape, plan, fixed, boxes, dev)
    cots = [torch.zeros(s, dtype=torch.float32, device=dev) for s in shapes]
    lvl_max = torch.zeros(_MAX_LEVELS, dtype=torch.int32, device=dev)
    lvl_max[:len(shapes)] = maxima.to(dev).view(torch.int32)
    words = words.contiguous()
    prm.acc, prm.lvl_max = words.data_ptr(), lvl_max.data_ptr()
    _set_cots(prm, cots)
    _launch(prm, len(shapes), shadow, dev, PASS_CONVERT)
    _count_shard(shadow)
    return cots


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def backward_replay(z_shape, graw, ids, aux, plan, shifts=None,
                    shadow=None):
    """``(level_cots, zcot)`` of the winners recorded by an argmax forward,
    for the row cotangent ``graw`` (A, in0, in1).  Horizon mode: the
    azimuths' ``shifts`` (:func:`horizon_shifts`), kernel K3.  Shadow mode
    (``shadow_backward_replay_fn``): ``shadow = (sun_table, z_org,
    grid_origin)`` of the K2-argmax forward, kernel K4; ``zcot`` is then
    the cotangent of the ray origins ``z_org``.  The kernel runs for CUDA
    tensors (a failed build or launch raises), :func:`backward_replay_plain`
    for CPU tensors."""
    if graw.device.type == "cuda":
        return _bwd_cuda(z_shape, graw, ids, aux, plan, shifts, shadow)
    if graw.device.type == "cpu":
        return backward_replay_plain(z_shape, graw, ids, aux, plan, shifts,
                                     shadow)
    raise ValueError(f"no replay backward for device {graw.device}")


def z_cotangent(z, plan, level_cots, zcot):
    """Cotangent of the outer heightfield ``z``: the level cotangents
    through the pyramid's VJP, plus ``zcot`` at the inner block (``z_org``
    is the inner block plus a constant; ``pallas_sweep.py:2377-2385``)."""
    dz = _mip.padded_levels_vjp(z, plan["pads"], level_cots)
    (off0, off1), (in0, in1) = plan["offset"], plan["inner_shape"]
    dz[off0:off0 + in0, off1:off1 + in1] += zcot
    return dz


def replay_state_from_jax(raw, ids, aux, azim_num, device):
    """Port tensors ``(raw, ids, aux)`` from the JAX package's argmax
    forward, whose rows may be padded: ``pallas_forward_fn(...,
    emit_argmax=True)`` pads the azimuth rows to ``azim_pad``, the shadow
    record ``_shadow_core(..., emit_argmax=True)`` (metric, ids, D) pads
    its sun rows to ``t_pad`` by repeating the last sun
    (``pallas_sweep.py:2543-2548``).  The first ``azim_num`` rows (azimuths
    or suns) are kept, ids as int32, so the port's backward can run on the
    reference's forward record."""
    out = []
    for a, dt in ((raw, np.float32), (ids, np.int32), (aux, np.float32)):
        a = np.asarray(a)
        if a.ndim != 3 or a.shape[0] < azim_num:
            raise ValueError(f"array of shape {a.shape} holds fewer than "
                             f"{azim_num} azimuth rows")
        out.append(torch.from_numpy(np.array(a[:azim_num], dtype=dt))
                   .to(device))
    return tuple(out)
