# Copyright (c) 2026
# MIT License
"""Fused planar horizon sweep: the counterpart of
:mod:`horayzon_tpu.ops.pallas_sweep` in horizon mode.

:func:`horizon_sweep_fused` has the contract of
``horayzon_tpu.ops.pallas_sweep.horizon_sweep_pallas``: for every inner cell
and each of ``azim_num`` uniform azimuths it returns the horizon elevation
angle [radian], shape ``(in0, in1, azim_num)``, optionally with the
curved-Earth tilt ramp and a mask of the cells to sweep, and it is
differentiable w.r.t. the heightfield and the ramp.  Behind it sits one
sweep with two implementations of identical arithmetic:

* kernel K1, ``csrc/horizon_sweep.cu`` (CUDA C++ for ``sm_90a``, one
  thread per (cell, azimuth)), run for a CUDA tensor;
* :func:`_ratio_plain` (behind :func:`horizon_sweep_plain`), the same loop
  structure in plain torch, vectorised over the inner cells, run for a CPU
  tensor and used on the card as the kernel's reference.

Both follow the reference kernel ``pallas_sweep.py::_kernel`` step by step
(d2 near field, d1 pairs and trailing singles, masked steps past the safe
halo, mip phases) and round like it: scalar shift arithmetic in float32 from
the host trig table, constants rounded from double as JAX rounds Python
floats.  Both have the argmax variant of the gradient path, whose record
(winner ids, stationary denominators) the winner-replay backward of
:mod:`horayzon_tpu_torch.ops.replay` replays.  The kernel also takes the
reference's value-exact early exits (the d1 chunk, mip phase and mip chunk
skips), decided per warp from the 8 x 8 pooled companions of the levels
(:func:`skip_inputs`); they never move a value, so the plain version has
none, and :func:`warp_skip_plain` models them for the tests.

The mask and tilt-ramp variants follow ``_kernel``'s ``has_mask`` and
``horizon_tilt`` modes.  A masked cell starts its running value at +3e38
(the mask-aware init), so its raw ratio is 3e38 and its angle the upper
limit, and the caller applies its fill.  The kernel runs only the 32 x 8
blocks that hold an unmasked cell (:func:`live_blocks`) and does no sweep
for a masked cell; the plain version sweeps every cell from that init.
Unmasked cells get exactly the unmasked sweep's values.  The ramp adds
``(raw + sin(az) * A) + cos(az) * B`` to the raw ratio after the argmax
record is taken.

The gradient has the reference's two backwards (:class:`_HorizonSweepFn`):
the winner replay of :mod:`horayzon_tpu_torch.ops.replay` (K3), and with
``HZT_GRAD_RECOMPUTE=1`` the recompute VJP, autograd through the
plain-torch XLA sweep :func:`hz_xla_equiv` in azimuth chunks
(:func:`recompute_vjp`), after a forward of K1's plain variant.

The loop skeleton (:func:`sweep_plain`), the kernel's parameter block
(:func:`kernel_params`) and its library (:func:`kernel_lib`) also serve the
shadow mode, kernel K2, of :mod:`horayzon_tpu_torch.ops.shadow_sweep`.
"""

import ctypes
import math
import os
import warnings

import numpy as np
import torch

from horayzon_tpu_torch.ops import _build
from horayzon_tpu_torch.ops import mip as _mip
from horayzon_tpu_torch.ops import replay as _replay
from horayzon_tpu_torch.ops import sweep as _sweep
from horayzon_tpu_torch.utils import profiling as _profiling

_NEG_INIT = -3.0e38
#: The running value of a masked cell (the reference's mask-aware init).
_POS_INIT = 3.0e38
#: Cells of one block of the kernel: BLOCK_ROWS rows of BLOCK_COLS columns
#: (kBlockRows, kBlockCols of csrc/horizon_sweep.cu).
BLOCK_ROWS, BLOCK_COLS = 8, 32
#: HZ_MAX_LEVELS of csrc/horizon_sweep.cu (pyramid levels and phases)
_MAX_LEVELS = 32
#: Deepest mip level: the reference's floor-division bias 2^lvl * 16384
#: must fit int32.
_MAX_LEVEL_INDEX = 16
#: Shared memory of the kernel's step table (no opt-in above 48 KB).
_MAX_STEP_BYTES = 48 * 1024
#: The skips' grain (kD1ChunkPairs, kMipChunk of csrc/horizon_sweep.cu):
#: safe d1 pairs per chunk and mip samples per chunk, one sample a lane.
D1_CHUNK_PAIRS = 16
MIP_CHUNK = 32
#: Slack of the d1 bound (kD1Slack, kD1Rel): 2^-18 of the parabola's term
#: magnitudes, 2^-20 of the pooled maximum.
_D1_SLACK = np.float32(2.0 ** -18)
_D1_REL = np.float32(2.0 ** -20)

#: Launches of kernel K1 made by this process (incremented only where the
#: wrapper launches it).
KERNEL_LAUNCHES = 0
#: Launches of K1's argmax variant (the forward of the gradient path).
ARGMAX_KERNEL_LAUNCHES = 0
#: Launches of either of the above with a mask (the compacted block list),
#: and with a tilt ramp.  A launch adds one to the count of its entry
#: (KERNEL_LAUNCHES or ARGMAX_KERNEL_LAUNCHES) and one to each of these
#: whose variant it runs.
MASK_KERNEL_LAUNCHES = 0
TILT_KERNEL_LAUNCHES = 0
#: Launches of K1 or K1-argmax by a shard of a sharded sweep (a plan of
#: :func:`shard_plan`), counted besides the entry's own count.
SHARD_KERNEL_LAUNCHES = 0
#: The counters a launch of K1 (or K2) adds to when :func:`_ratio_cuda`
#: (``shadow_sweep._metric_cuda``) is given ``counters``, or while the
#: profiler records: the kernel's slots (``utils.profiling.COUNTER_FIELDS``).
COUNTER_FIELDS = _profiling.COUNTER_FIELDS


def plan_sweep(outer_shape, *, inner_shape, offset, dist_search, dx, dy,
               hori_acc=0.25, rel_err=None, max_level=10):
    """Static sweep plan: the schedule's phases, pads and the dense-step
    split (the schedule, ``near_ex`` and ``n_safe`` logic of
    ``pallas_sweep.plan_sweep`` and the split of ``_kernel``).

    ``phases_meta``: ``(level, num, s_first, step)`` per phase, the level-0
    phases merged into one dense entry.  Dense steps ``[0, nx)`` take two
    reads, ``[nx, n_dense)`` one; steps from ``ns2`` (two-read) and ``ns1``
    (one-read) on carry in-domain validity.  ``consts``: the sweep's float32
    scalars (:func:`_constants`), shared by the forward and the replay."""
    step = float(min(abs(dx), abs(dy)))
    if rel_err is None:
        rel_err = _sweep.default_rel_err(hori_acc)
    schedule = _sweep.build_schedule(step, float(dist_search), rel_err,
                                     max_level=max_level)
    if schedule.num_levels - 1 > _MAX_LEVEL_INDEX:
        raise ValueError(f"schedule reaches mip level "
                         f"{schedule.num_levels - 1}; at most "
                         f"{_MAX_LEVEL_INDEX} is supported")
    n_dense = sum(ph.num for ph in schedule.phases if ph.level == 0)
    phases_meta = [(0, n_dense, step, step)]
    for p, ph in enumerate(schedule.phases):
        if ph.level == 0:
            continue
        s_vals = schedule.s_values[p]
        step_l = (float(s_vals[1] - s_vals[0]) if ph.num > 1
                  else step * 2 ** ph.level)
        phases_meta.append((ph.level, ph.num, float(s_vals[0]), step_l))
    in0, in1 = inner_shape
    off0, off1 = offset
    h_out, w_out = outer_shape
    # Leading dense steps that provably stay on-grid for every inner cell
    # skip the per-step in-domain masks (cf. sweep.mark_safe_phases).
    halo_cells = min(off0, off1, h_out - off0 - in0, w_out - off1 - in1)
    n_safe = max(0, halo_cells - 2)
    near_ex = (schedule.phases[0].num
               if schedule.phases[0].kind == "d2" else 0)
    nx = min(near_ex, n_dense)           # two-read near field
    ns2 = min(nx, n_safe)                # safe d2 steps
    ns1 = max(nx, min(n_dense, n_safe))  # end of safe d1 steps
    if ns1 < n_dense:
        # d1 pairs keep their global parity across the safe/masked
        # boundary (a pair never straddles it), as in the reference
        ns1 = nx + ((ns1 - nx) // 2) * 2
    plan = dict(phases_meta=tuple(phases_meta), pads=schedule.pads,
                offset=(int(off0), int(off1)), inner_shape=(in0, in1),
                dx=float(dx), dy=float(dy), step=step,
                dist=float(dist_search), near_ex=near_ex, n_safe=n_safe,
                n_dense=n_dense, nx=nx, ns2=ns2, ns1=ns1,
                rel_err=float(rel_err), max_level=int(max_level))
    plan["consts"] = _constants(plan)
    return plan


def shard_plan(plan, row0, rows, lvl_row0=None):
    """The plan of one shard of a sharded sweep: the inner rows ``[row0,
    row0 + rows)`` of the whole run's ``plan``.  The shard's global offsets
    are its ``offset``: the outer row and column of its first cell, so
    every coordinate the sweep forms is the whole run's.
    Everything else is the whole run's, the dense-step split too (its
    ``n_safe`` comes from the whole domain's halo, which holds for every
    shard; the shard's own halo would move the safe split,
    ``horayzon_tpu/parallel/shard.py:116-127``).  ``lvl_row0``: per level,
    the padded row at which the shard's buffer of that level starts (a
    window of the full padded level; 0 for a whole level), each a multiple
    of 8.  ``plan["shard"]`` is ``row0``."""
    in0, in1 = plan["inner_shape"]
    if not (0 <= row0 and rows >= 1 and row0 + rows <= in0):
        raise ValueError(f"shard rows [{row0}, {row0 + rows}) do not lie in "
                         f"the inner rows [0, {in0})")
    n_levels = len(plan["pads"])
    lvl_row0 = tuple(int(o) for o in (lvl_row0 or (0,) * n_levels))
    if len(lvl_row0) != n_levels or any(o < 0 or o % 8 for o in lvl_row0):
        raise ValueError(f"lvl_row0 {lvl_row0}: one non-negative multiple "
                         f"of 8 per level ({n_levels})")
    off0, off1 = plan["offset"]
    return dict(plan, offset=(off0 + row0, off1),
                inner_shape=(int(rows), in1), shard=int(row0),
                lvl_row0=lvl_row0)


def level_reach(plan, trig):
    """Per padded level, the rows ``[lo, hi)`` that a sweep of ``plan``
    over the azimuths of ``trig`` (an (A, 2) float32 table of
    :func:`trig_table`'s layout) reads or bounds, at a distance of the
    step table or a d2 midpoint: each level-0 read's 2 x 2 stencil
    ``floor(s * sh_i)`` rows down, each mip read at ``round(s * sh_i)``,
    formed in float32 as K1 forms them; ``(0, 0)`` for a level no phase
    reads.  The window a shard must hold of each level."""
    f32 = np.float32
    in0, _ = plan["inner_shape"]
    off0 = plan["offset"][0]
    k = plan["consts"]
    tab = step_table(plan)[:, 0]
    sh_i = (np.asarray(trig, dtype=f32)[:, 1] / f32(plan["dy"]))[:, None]
    n_dense = plan["n_dense"]
    dense = np.concatenate([tab[:n_dense], tab[:plan["nx"]] - k["half_step"],
                            [k["s_m1_safe"], k["s_m1_masked"]]]).astype(f32)
    reach = [(0, 0)] * len(plan["pads"])
    if n_dense:
        di = np.floor(dense[None, :] * sh_i).astype(np.int64)
        pad = plan["pads"][0]
        reach[0] = (off0 + pad + int(di.min()),
                    off0 + in0 - 1 + pad + int(di.max()) + 2)
    first = n_dense
    for lvl, n_m, _, _ in plan["phases_meta"][1:]:
        ri = np.rint(tab[None, first:first + n_m] * sh_i).astype(np.int64)
        first += n_m
        pad = plan["pads"][lvl]
        lo = ((off0 + int(ri.min())) >> lvl) + pad
        hi = ((off0 + in0 - 1 + int(ri.max())) >> lvl) + pad + 1
        if reach[lvl][1] > reach[lvl][0]:
            lo, hi = min(lo, reach[lvl][0]), max(hi, reach[lvl][1])
        reach[lvl] = (lo, hi)
    return reach


def trig_table(azim_num):
    """(azim_num, 2) float32 (sin, cos) of the float32 azimuth angles, built
    on the host exactly as ``pallas_forward_fn`` builds its table: mip
    sample indices round(s * sh) must come from bit-identical trig."""
    azim32 = ((2.0 * np.pi) / azim_num
              * np.arange(azim_num)).astype(np.float32)
    return np.stack([np.sin(azim32.astype(np.float64)),
                     np.cos(azim32.astype(np.float64))],
                    axis=-1).astype(np.float32)


def _f32(x):
    """A Python float rounded to float32, as JAX rounds a weakly typed
    Python scalar against a float32 array."""
    return np.float32(x)


def _constants(plan):
    """Float32 scalars of the sweep, each rounded as the reference rounds
    it (products of Python floats are formed in double first)."""
    step = plan["step"]
    nx, ns1, n_dense = plan["nx"], plan["ns1"], plan["n_dense"]
    return dict(
        step=_f32(step), half_step=_f32(0.5 * step),
        two_step=_f32(2.0 * step), dist=_f32(plan["dist"]),
        inv_l0=_f32(1.0 / step), inv_l0_sq=_f32((1.0 / step) * (1.0 / step)),
        inv_l1=_f32(0.5 / step), inv_l1_sq=_f32((0.5 / step) * (0.5 / step)),
        # distances of the h2 re-reads before a trailing single step
        s_m1_safe=_f32((nx + 2 * ((ns1 - nx) // 2) - 1) * step),
        s_m1_masked=_f32((ns1 + 2 * ((n_dense - ns1) // 2) - 1) * step),
        # shadow mode's vertex window 2 (t_lo + 1e-3), 2 (length - 1e-3)
        # for t_lo in (0, step), length in (step, 2 step)
        # (pallas_sweep.py:429-430)
        lo2_0=_f32(2.0 * (0.0 + 1e-3)), lo2_step=_f32(2.0 * (step + 1e-3)),
        hi2_step=_f32(2.0 * (step - 1e-3)),
        hi2_two_step=_f32(2.0 * (2.0 * step - 1e-3)))


def step_table(plan):
    """(n, 2) float32 ``(s, 1/s)`` of every sample of the schedule, in the
    order of the sample ids: the dense steps, then each mip phase's samples.
    Each distance is formed in float32 as the sweep's loop forms it (no
    FMA): ``float32(m + 1) * step`` for a d2 step, a d1 single and the first
    step of a d1 pair, the first step's distance ``+ step`` for the second;
    ``min(s_first + float32(m) * step_l, dist)`` for a mip sample.  ``1/s``
    is the correctly rounded reciprocal that the point candidate
    ``(h - z_org) * (1/s)`` multiplies by.  The kernel stages this table in
    shared memory (csrc/horizon_sweep.cu)."""
    f32 = np.float32
    k = plan["consts"]
    nx, ns1, n_dense = plan["nx"], plan["ns1"], plan["n_dense"]
    s = np.arange(1, n_dense + 1, dtype=np.int64).astype(f32) * k["step"]
    for lo, hi in ((nx, ns1), (ns1, n_dense)):
        if hi > lo:
            second = np.arange(lo + 1, lo + 2 * ((hi - lo) // 2), 2)
            s[second] = s[second - 1] + k["step"]
    parts = [s]
    for _, n_m, s_first, step_l in plan["phases_meta"][1:]:
        m = np.arange(n_m, dtype=np.int64).astype(f32)
        parts.append(np.minimum(f32(s_first) + m * f32(step_l), k["dist"]))
    s = np.concatenate(parts).astype(f32)
    return np.stack([s, f32(1.0) / s], axis=-1)


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

def _check_rows(what, lo, hi, size):
    """Rows (or columns) ``[lo, hi)`` of a read lie inside a padded level of
    ``size``: a slice past the edge would not raise by itself."""
    if lo < 0 or hi > size:
        raise IndexError(f"{what} reads [{lo}, {hi}) outside the padded "
                         f"level of size {size}")


def sweep_plain(z_inner, levels, plan, outer_shape, n_rows, row_mode,
                emit_argmax=False, init=None, chunk_hook=None):
    """The loop skeleton of ``pallas_sweep.py::_kernel`` in plain torch,
    shared by the plain versions of K1 (horizon) and K2 (shadow).

    For each row ``r`` of ``range(n_rows)`` (an azimuth or a sun) the
    shifted slices of the padded levels are read for all inner cells at
    once, in the reference's sections: d2 steps, d1 pairs, the h2 re-read
    and trailing single, masked steps past ``n_safe``, mip phases.  The
    mode enters through ``row_mode(r) -> (sh_i, sh_j, point, quad)``: the
    float32 row and column shifts [cells per metre] and the candidate
    functions ``point(h, s)`` (a sample of height ``h`` at distance ``s``)
    and ``quad(a_c, b_c, h0, s_start, win) -> (valid, cand, g, a)`` (the
    interior candidate of the parabola over window ``win``: 0 a d2 step,
    1 a d1 pair, 2 a d1 single; ``(g, a)`` the argmax pair).  Returns the
    running maxima (n_rows, in0, in1).

    ``emit_argmax``: return ``(out, ids, aux)`` as the argmax variant of
    K1 does: strict ``cand > acc`` updates in the reference's candidate
    order (the same running value as the maximum), the winner ids and the
    winning parabola's stationary denominator D (``pallas_sweep.py:481-496,
    632-638, 1010-1014``).  ``init``: the running value's start, (in0, in1)
    float32 (default -3e38 everywhere; the mask variant passes +3e38 at
    masked cells).

    ``chunk_hook``: for tests of the kernel's skips.  The d1 pairs (safe
    and masked) and the mip phases run in the kernel's chunks, and before
    each chunk (a mip phase too) ``chunk_hook(ev)`` gets a dict ``ev``
    (``kind`` "d1", "mip" or "mip_phase", ``row``, ``sh`` = (sh_i, sh_j),
    ``first`` and ``n``, the chunk's samples as entries of
    :func:`step_table`, ``level``, ``acc`` the running value, ``h1``, and
    for a d1 chunk ``masked`` and ``v1``, the validity carried into it)
    and returns None or an (in0, in1) bool tensor of the cells that skip
    it: they keep their running record, and after a skipped d1 chunk h1
    (and v1) is re-read at the table's distance of its last sample.  After
    the chunk it gets ``ev`` again with ``cand_max``, each cell's largest
    candidate of the chunk."""
    f32 = np.float32
    in0, in1 = plan["inner_shape"]
    off0, off1 = plan["offset"]
    h, w = outer_shape
    pads = plan["pads"]
    k = plan["consts"]
    dev = z_inner.device
    rows = torch.arange(off0, off0 + in0, device=dev)
    cols = torch.arange(off1, off1 + in1, device=dev)
    lvl0, pad0 = levels[0], pads[0]
    # the padded row at which each level's buffer starts (a shard's window)
    lvl_row0 = plan.get("lvl_row0") or (0,) * len(pads)
    step, two_step = k["step"], k["two_step"]
    out = torch.empty((n_rows, in0, in1), dtype=torch.float32, device=dev)
    if emit_argmax:
        ids = torch.empty((n_rows, in0, in1), dtype=torch.int32, device=dev)
        aux = torch.empty((n_rows, in0, in1), dtype=torch.float32,
                          device=dev)

    def inside0(di, dj):
        rv = (rows + di >= 0) & (rows + di + 1 <= h - 1)
        cv = (cols + dj >= 0) & (cols + dj + 1 <= w - 1)
        return rv[:, None] & cv[None, :]

    track = [None]     # the open chunk's largest candidates (chunk_hook)
    steps = None if chunk_hook is None else step_table(plan)

    def update(acc, cand, cid, num=None, den=None):
        """Running max; with argmax also the winner's id and, for a
        parabola candidate, its (g, a) pair."""
        if track[0] is not None:
            track[0] = torch.maximum(track[0], cand)
        if not emit_argmax:
            return torch.maximum(acc, cand)
        v, i, n, d = acc
        upd = cand > v
        return (torch.where(upd, cand, v), torch.where(upd, cid, i),
                n if num is None else torch.where(upd, num, n),
                d if den is None else torch.where(upd, den, d))

    for r_idx in range(n_rows):
        sh_i, sh_j, point, quad = row_mode(r_idx)

        def point_update(acc, he, s, cid):
            return update(acc, point(he, s), cid)

        def quad_update(acc, a_c, b_c, h0, s_start, win, extra, cid):
            valid, cand, g, a = quad(a_c, b_c, h0, s_start, win)
            if extra is not None:
                valid = valid & extra
            return update(acc, torch.where(valid, cand, _NEG_INIT), cid, g,
                          a)

        def read0(s):
            dif = s * sh_i
            djf = s * sh_j
            di = np.floor(dif)
            dj = np.floor(djf)
            fi = dif - di
            fj = djf - dj
            r = off0 + int(di) + pad0 - lvl_row0[0]
            c = off1 + int(dj) + pad0
            _check_rows("a level-0 row", r, r + in0 + 1, lvl0.shape[0])
            _check_rows("a level-0 column", c, c + in1 + 1, lvl0.shape[1])
            win = lvl0[r:r + in0 + 1, c:c + in1 + 1]
            gj = float(f32(1.0) - fj)
            top = gj * win[:-1, :-1] + float(fj) * win[:-1, 1:]
            bot = gj * win[1:, :-1] + float(fj) * win[1:, 1:]
            return (float(f32(1.0) - fi) * top + float(fi) * bot,
                    int(di), int(dj))

        def d2_step(m, acc, h1, masked):
            s_end = f32(m + 1) * step
            s_start = s_end - step
            hm, dim, djm = read0(s_end - k["half_step"])
            he, die, dje = read0(s_end)
            acc = point_update(acc, he, s_end, 2 * m)
            a_c = (2.0 * he + 2.0 * h1 - 4.0 * hm) * float(k["inv_l0_sq"])
            b_c = (4.0 * hm - 3.0 * h1 - he) * float(k["inv_l0"])
            v_end = extra = None
            if masked:
                v_end = inside0(die, dje)
                extra = inside0(dim, djm) & v_end
            acc = quad_update(acc, a_c, b_c, h1, s_start, 0, extra,
                              2 * m + 1)
            return acc, he, v_end

        def d1_pair(m, acc, h1, masked, v1=None):
            s_a = f32(m + 1) * step
            s_b = s_a + step
            h_a, dia, dja = read0(s_a)
            acc = point_update(acc, h_a, s_a, 2 * m)
            h_b, dib, djb = read0(s_b)
            acc = point_update(acc, h_b, s_b, 2 * (m + 1))
            a_c = (2.0 * h_b + 2.0 * h1 - 4.0 * h_a) * float(k["inv_l1_sq"])
            b_c = (4.0 * h_a - 3.0 * h1 - h_b) * float(k["inv_l1"])
            v_b = extra = None
            if masked:
                v_b = inside0(dib, djb)
                extra = v1 & inside0(dia, dja) & v_b
            acc = quad_update(acc, a_c, b_c, h1, s_b - two_step, 1, extra,
                              2 * (m + 1) + 1)
            return acc, h_b, v_b

        def d1_single(m, acc, h2, h1, masked, v2=None, v1=None):
            s_end = f32(m + 1) * step
            he, die, dje = read0(s_end)
            acc = point_update(acc, he, s_end, 2 * m)
            a_c = (2.0 * he + 2.0 * h2 - 4.0 * h1) * float(k["inv_l1_sq"])
            b_c = (4.0 * h1 - 3.0 * h2 - he) * float(k["inv_l1"])
            extra = v2 & v1 & inside0(die, dje) if masked else None
            acc = quad_update(acc, a_c, b_c, h2, s_end - two_step, 2, extra,
                              2 * m + 1)
            return acc, he

        # Dense steps, in the reference's sections (pallas_sweep.py:641-757)
        acc = torch.full_like(z_inner, _NEG_INIT) if init is None else init
        if emit_argmax:
            acc = (acc, torch.full((in0, in1), _replay.ID_NONE,
                                   dtype=torch.int32, device=dev),
                   torch.ones_like(z_inner), torch.ones_like(z_inner))
        h2 = h1 = z_inner
        ones = torch.ones((in0, in1), dtype=torch.bool, device=dev)
        for m in range(plan["ns2"]):
            acc, he, _ = d2_step(m, acc, h1, False)
            h2, h1 = h1, he
        v2 = v1 = ones
        for m in range(plan["ns2"], plan["nx"]):
            acc, he, v_end = d2_step(m, acc, h1, True)
            h2, h1, v2, v1 = h1, he, v1, v_end
        nx, ns1, n_dense = plan["nx"], plan["ns1"], plan["n_dense"]
        def chunk(ev, run, acc, carry=None):
            """``run(acc, carry) -> (acc, carry)`` over one chunk, with the
            hook's skips applied; ``carry`` is None (mip), h1 (a safe d1
            chunk) or (h1, v1) (a masked one)."""
            if chunk_hook is None:
                return run(acc, carry)
            h1, v1 = carry if isinstance(carry, tuple) else (carry, ones)
            ev = dict(ev, row=r_idx, sh=(sh_i, sh_j),
                      acc=acc[0] if emit_argmax else acc, h1=h1, v1=v1)
            skip = chunk_hook(ev)
            outer, track[0] = track[0], torch.full_like(z_inner, _NEG_INIT)
            acc2, carry2 = run(acc, carry)
            chunk_hook(dict(ev, cand_max=track[0]))
            track[0] = (None if outer is None
                        else torch.maximum(outer, track[0]))
            if skip is None:
                return acc2, carry2
            if emit_argmax:
                acc2 = tuple(torch.where(skip, a, b)
                             for a, b in zip(acc, acc2))
            else:
                acc2 = torch.where(skip, acc, acc2)
            if carry is not None:
                he, di, dj = read0(steps[ev["first"] + ev["n"] - 1, 0])
                if isinstance(carry, tuple):
                    carry2 = (torch.where(skip, he, carry2[0]),
                              torch.where(skip, inside0(di, dj), carry2[1]))
                else:
                    carry2 = torch.where(skip, he, carry2)
            return acc2, carry2

        if ns1 > nx:
            n_pairs = (ns1 - nx) // 2
            for q0 in range(0, n_pairs, D1_CHUNK_PAIRS):
                q1 = min(q0 + D1_CHUNK_PAIRS, n_pairs)

                def pairs(acc, h1, q0=q0, q1=q1):
                    for q in range(q0, q1):
                        acc, h1, _ = d1_pair(nx + 2 * q, acc, h1, False)
                    return acc, h1

                acc, h1 = chunk(dict(kind="d1", masked=False,
                                     first=nx + 2 * q0, n=2 * (q1 - q0),
                                     level=0), pairs, acc, h1)
            if n_pairs > 0 and (ns1 - nx) % 2:
                h2 = read0(k["s_m1_safe"])[0]
            if (ns1 - nx) % 2:
                acc, he = d1_single(nx + 2 * n_pairs, acc, h2, h1, False)
                h2, h1 = h1, he
        if n_dense > ns1:
            n_pairs = (n_dense - ns1) // 2
            for q0 in range(0, n_pairs, D1_CHUNK_PAIRS):
                q1 = min(q0 + D1_CHUNK_PAIRS, n_pairs)

                def mpairs(acc, hv, q0=q0, q1=q1):
                    h1, v1 = hv
                    for q in range(q0, q1):
                        acc, h1, v1 = d1_pair(ns1 + 2 * q, acc, h1, True, v1)
                    return acc, (h1, v1)

                acc, (h1, v1) = chunk(dict(kind="d1", masked=True,
                                           first=ns1 + 2 * q0,
                                           n=2 * (q1 - q0), level=0),
                                      mpairs, acc, (h1, v1))
            if n_pairs > 0 and (n_dense - ns1) % 2:
                h2, di, dj = read0(k["s_m1_masked"])
                v2 = inside0(di, dj)
            if (n_dense - ns1) % 2:
                acc, _ = d1_single(ns1 + 2 * n_pairs, acc, h2, h1, True,
                                   v2, v1)

        # Mip phases: nearest reads, index floor((cell + round(s*sh)) / k);
        # ids count on from 2 * n_dense (pallas_sweep.py:776-781)
        id_off = 2 * n_dense
        for lvl, n_m, s_first, step_l in plan["phases_meta"][1:]:
            kp = 2 ** lvl
            bias = kp * 16384
            lvl_t, pad = levels[lvl], pads[lvl] - lvl_row0[lvl]

            def samples(acc, m0, m1, lvl=lvl, kp=kp, bias=bias, lvl_t=lvl_t,
                        pad=pad, s_first=s_first, step_l=step_l,
                        id_off=id_off):
                for m in range(m0, m1):
                    s = np.minimum(f32(s_first) + f32(m) * f32(step_l),
                                   k["dist"])
                    ri = int(np.rint(s * sh_i))
                    rj = int(np.rint(s * sh_j))
                    _check_rows(f"a level-{lvl} row",
                                (off0 + ri + bias) // kp - bias // kp + pad,
                                (off0 + in0 - 1 + ri + bias) // kp
                                - bias // kp + pad + 1, lvl_t.shape[0])
                    cpad = pad + lvl_row0[lvl]
                    _check_rows(f"a level-{lvl} column",
                                (off1 + rj + bias) // kp - bias // kp + cpad,
                                (off1 + in1 - 1 + rj + bias) // kp
                                - bias // kp + cpad + 1, lvl_t.shape[1])
                    r = (torch.div(rows + (ri + bias), kp,
                                   rounding_mode="trunc") - bias // kp + pad)
                    c = (torch.div(cols + (rj + bias), kp,
                                   rounding_mode="trunc") - bias // kp + cpad)
                    hs = lvl_t.index_select(0, r).index_select(1, c)
                    acc = point_update(acc, hs, s, id_off + m)
                return acc

            def phase(acc, _, n_m=n_m, lvl=lvl, samples=samples,
                      t0=id_off - n_dense):
                """The phase in chunks of MIP_CHUNK samples."""
                for m0 in range(0, n_m, MIP_CHUNK):
                    m1 = min(m0 + MIP_CHUNK, n_m)
                    if m1 - m0 == n_m:
                        acc = samples(acc, m0, m1)
                        continue
                    acc = chunk(dict(kind="mip", first=t0 + m0, n=m1 - m0,
                                     level=lvl),
                                lambda a, _, m0=m0, m1=m1:
                                (samples(a, m0, m1), None), acc)[0]
                return acc, None

            acc = chunk(dict(kind="mip_phase", first=id_off - n_dense,
                             n=n_m, level=lvl), phase, acc)[0]
            id_off += n_m
        if emit_argmax:
            acc, ids[r_idx], num, den = acc
            # the deferred divide of the winning parabola's D
            aux[r_idx] = num / torch.where(den.abs() > 1e-30, den, 1e-30)
        out[r_idx] = acc
    if emit_argmax:
        return out, ids, aux
    return out


def _horizon_rows(z_org, trig, plan):
    """``row_mode`` of :func:`sweep_plain` for K1: the elevation-angle
    ratio ``(h - z_org) / s`` and the division-free interior stationary
    value of the parabola (``pallas_sweep.py:455-490``)."""
    f32 = np.float32
    k = plan["consts"]
    eps = f32(1e-3)
    # (length, t_lo) of each window
    wins = ((k["step"], f32(0.0)), (k["two_step"], f32(0.0)),
            (k["two_step"], k["step"]))

    def point(he, s):
        return (he - z_org) * float(f32(1.0) / s)

    def quad(a_c, b_c, h0, s_start, win):
        length, t_lo = wins[win]
        ss = float(s_start)
        u = (a_c * ss - b_c) * ss + (h0 - z_org)
        # square root through float64: torch's float32 CPU sqrt is not
        # always correctly rounded, and r_int cancels large terms, so one
        # ulp of g can move the candidate far more than an ulp
        g = torch.sqrt(torch.clamp_min(a_c * u, 0.0).double()).float()
        g = torch.where(a_c >= 0.0, g, -g)
        r_int = b_c - 2.0 * a_c * ss + 2.0 * g
        lo = (s_start + t_lo) + eps
        hi = (s_start + length) - eps
        valid = (u - a_c * float(lo * lo)) * (u - a_c * float(hi * hi)) < 0.0
        return valid, r_int, g, a_c

    def row(az):
        sh_i = f32(trig[az, 1]) / f32(plan["dy"])   # row cells per metre
        sh_j = f32(trig[az, 0]) / f32(plan["dx"])
        return sh_i, sh_j, point, quad

    return row


def _add_tilt(raw, trig, tilt_ramp):
    """``(raw + ux * A) + uy * B`` per azimuth row, ``(ux, uy)`` the host
    table's (sin, cos) (``pallas_sweep.py:1015-1016``)."""
    ra, rb = tilt_ramp
    tab = torch.from_numpy(trig).to(raw.device)
    ux, uy = tab[:, 0, None, None], tab[:, 1, None, None]
    return (raw + ux * ra) + uy * rb


def _ratio_plain(z_org, z_inner, levels, trig, plan, outer_shape,
                 tilt_ramp=None, mask=None, emit_argmax=False):
    """Raw ratios (A, in0, in1) in plain torch (K1's plain version); with
    ``emit_argmax`` ``(raw, ids, aux)`` (see :func:`sweep_plain`).
    ``tilt_ramp``: ``(A, B)`` (in0, in1) float32; ``mask``: (in0, in1)
    uint8, nonzero where a cell is swept; both on ``z_org``'s device, as
    :func:`sweep_args` makes them."""
    init = None
    if mask is not None:
        init = torch.where(mask != 0, _NEG_INIT, _POS_INIT).to(torch.float32)
    res = sweep_plain(z_inner, levels, plan, outer_shape, trig.shape[0],
                      _horizon_rows(z_org, trig, plan), emit_argmax, init)
    raw = res[0] if emit_argmax else res
    if tilt_ramp is not None:
        raw = _add_tilt(raw, trig, tilt_ramp)
    if mask is not None:
        # a masked cell keeps its init, as the kernel writes it
        raw = torch.where(mask != 0, raw, _POS_INIT)
    return (raw,) + res[1:] if emit_argmax else raw


def warp_skip_plain(ev, pooled, pool_min0, plan, z_org, m=None,
                    sign_exact=False):
    """The kernel's skip test (``d1_skip``, ``mip_skip`` and, with ``m``,
    K2's ``d1_skip_shadow``, ``mip_skip_shadow`` of csrc/horizon_sweep.cu)
    in plain torch, for every warp of row ``ev["row"]`` at once: the
    ``chunk_hook`` event ``ev`` of :func:`sweep_plain`, the pooled
    companions of :func:`skip_inputs`, the ray origins ``z_org`` and, in
    the shadow mode, the row's ray slopes ``m`` (in0, in1).  ``sign_exact``: K2's sign-exact arm (a lane
    also votes to skip when its bound is at most 0 or its running value is
    positive).  Returns ``(bound, skip)``, (in0, in1): each cell's bound on
    the chunk's candidates, and whether its warp (32 consecutive columns of
    a row, as the kernel's) skips the chunk.  The same float32 operations
    as the kernel's, for the tests of the skips; the library never calls
    it."""
    f32 = np.float32
    in0, in1 = plan["inner_shape"]
    off0, off1 = plan["offset"]
    dev = z_org.device
    tab = step_table(plan)
    first, n, lvl = ev["first"], ev["n"], ev["level"]
    sh_i, sh_j = ev["sh"]
    acc = ev["acc"]
    shadow = m is not None
    rows = torch.arange(off0, off0 + in0, device=dev)
    w0 = torch.arange(0, in1, BLOCK_COLS, device=dev)
    b0 = off1 + w0
    b1 = off1 + torch.clamp(w0 + BLOCK_COLS - 1, max=in1 - 1)
    pad = plan["pads"][lvl]
    pool_l = pooled[lvl]
    n_w = len(w0) * BLOCK_COLS

    def box_max(r, q0, q1, pool=pool_l, minimum=False):
        """Max (or min) of the pooled cells over padded rows r (k, in0) and
        columns [q0, q1] (k, warps), for k samples: (k, in0, warps)."""
        p0, p1 = q0 >> 3, q1 >> 3
        width = int((p1 - p0).max()) + 1
        idx = torch.minimum(p0[..., None] + torch.arange(width, device=dev),
                            p1[..., None])
        vals = pool[(r >> 3)[:, :, None, None], idx[:, None, :, :]]
        return vals.amin(dim=-1) if minimum else vals.amax(dim=-1)

    def warp_min(x):
        """(in0, warps) minimum over each warp's cells (a lane past in1
        runs on the last cell, which its warp already holds)."""
        full = torch.full((in0, n_w), _POS_INIT, device=dev)
        full[:, :in1] = x
        return full.view(in0, -1, BLOCK_COLS).amin(dim=2)

    def lanes(x):
        return x.repeat_interleave(BLOCK_COLS, dim=1)[:, :in1]

    def col(v):
        return torch.from_numpy(np.ascontiguousarray(v)).to(dev)[:, None]

    z_min = warp_min(z_org)
    s = tab[first:first + n, 0]
    if ev["kind"] == "d1":
        # the 2 x 2 stencils of every sample: rows r and r + 1
        di, dj = col(np.floor(s * sh_i).astype(np.int64)), col(
            np.floor(s * sh_j).astype(np.int64))
        r = rows[None, :] + di + pad
        r = torch.cat([r, r + 1])
        q0 = (b0[None, :] + dj + pad).repeat(2, 1)
        q1 = (b1[None, :] + dj + 1 + pad).repeat(2, 1)
        d = box_max(r, q0, q1).amax(dim=0)
        lo = box_max(r, q0, q1, pool_min0, True).amin(dim=0)
    else:
        ri, rj = col(np.rint(s * sh_i).astype(np.int64)), col(
            np.rint(s * sh_j).astype(np.int64))
        d_k = box_max(((rows[None, :] + ri) >> lvl) + pad,
                      ((b0[None, :] + rj) >> lvl) + pad,
                      ((b1[None, :] + rj) >> lvl) + pad)
        d = d_k.amax(dim=0)
        lo = torch.full_like(d, _POS_INIT)
        s_k = torch.from_numpy(s).to(dev)[:, None, None]
        if shadow:
            b_k = ((d_k - z_min) - s_k * warp_min(m)).amax(dim=0)
        else:
            inv_k = torch.from_numpy(tab[first:first + n, 1]).to(dev)
            b_k = ((d_k - z_min) * inv_k[:, None, None]).amax(dim=0)
    d, lo = lanes(d), lanes(lo)
    e_lo, e_hi = tab[first - 1 if ev["kind"] == "d1" else first],\
        tab[first + n - 1]
    if ev["kind"] == "d1" and shadow:
        # the lane's h1 is the first parabola's left sample, unless that
        # parabola is invalid (a masked chunk with v1 false)
        own = ev["v1"] if ev["masked"] else torch.ones_like(d, dtype=bool)
        d = torch.where(own, torch.maximum(d, ev["h1"]), d)
        lol = torch.where(own, torch.minimum(lo, ev["h1"]), lo)
        dp = d + d.abs() * float(_D1_REL)
        lw = torch.minimum(lol, dp)
        gap = dp - lw
        hp = dp + 0.125 * gap
        sm_lo = float(e_lo[0]) * m
        sm_hi = float(e_hi[0]) * m
        slack = ((((gap + dp.abs()) + lw.abs()) + z_org.abs())
                 + torch.maximum(sm_lo.abs(), sm_hi.abs())) * float(_D1_SLACK)
        bound = ((hp - z_org) - torch.minimum(sm_lo, sm_hi)) + slack
        if first < 1:
            bound = torch.full_like(bound, float("inf"))
    elif ev["kind"] == "d1":
        h1 = ev["h1"]
        d = torch.maximum(d, h1)
        lol = torch.minimum(lo, h1)
        dp = d + d.abs() * float(_D1_REL)
        x = (dp + 0.125 * (dp - lol)) - z_org
        r = float(f32(e_hi[0] * plan["consts"]["inv_l0"]))
        slack = (float(_D1_SLACK) * (((((dp - lol) * r) * r + dp.abs())
                                      + lol.abs()) + z_org.abs())
                 ) * float(e_lo[1])
        bound = x * torch.where(x >= 0.0, float(e_lo[1]),
                                float(e_hi[1])) + slack
        if first < 1:
            bound = torch.full_like(bound, float("inf"))
    elif shadow:
        bound = torch.minimum(
            (d - z_org) - torch.minimum(float(e_lo[0]) * m,
                                        float(e_hi[0]) * m),
            lanes(b_k))
    else:
        x = d - z_org
        bound = torch.minimum(
            x * torch.where(x >= 0.0, float(e_lo[1]), float(e_hi[1])),
            lanes(b_k))
    vote = bound <= acc
    if sign_exact:
        vote = vote | (bound <= 0.0) | (acc > 0.0)
    full = torch.ones((in0, n_w), dtype=torch.bool, device=dev)
    full[:, :in1] = vote
    skip = full.view(in0, -1, BLOCK_COLS).all(dim=2)
    return bound, lanes(skip)


# ---------------------------------------------------------------------------
# Kernels K1 and K2 (csrc/horizon_sweep.cu)
# ---------------------------------------------------------------------------

class _HzParams(ctypes.Structure):
    """Mirror of ``struct HzParams`` in csrc/horizon_sweep.cu."""
    _fields_ = (
        [("z_org", ctypes.c_void_p), ("z_inner", ctypes.c_void_p),
         ("trig", ctypes.c_void_p), ("sun", ctypes.c_void_p),
         ("out", ctypes.c_void_p), ("ids", ctypes.c_void_p),
         ("aux", ctypes.c_void_p), ("lvl", ctypes.c_void_p * _MAX_LEVELS)]
        + [(n, ctypes.c_int * _MAX_LEVELS)
           for n in ("lvl_w", "lvl_pad", "ph_lvl", "ph_n")]
        + [(n, ctypes.c_float * _MAX_LEVELS)
           for n in ("ph_s_first", "ph_step")]
        + [(n, ctypes.c_int)
           for n in ("n_phases", "in0", "in1", "a_num", "off0", "off1", "h",
                     "w", "ns2", "nx", "ns1", "n_dense")]
        + [(n, ctypes.c_float)
           for n in ("dx", "dy", "step", "dist", "half_step", "two_step",
                     "inv_l0", "inv_l0_sq", "inv_l1", "inv_l1_sq",
                     "s_m1_safe", "s_m1_masked", "x0", "y0", "lo2_0",
                     "lo2_step", "hi2_step", "hi2_two_step")]
        + [("ramp_a", ctypes.c_void_p), ("ramp_b", ctypes.c_void_p),
           ("mask", ctypes.c_void_p), ("blocks", ctypes.c_void_p),
           ("n_blocks", ctypes.c_int),
           # appended for the redesign: the step table, the pooled
           # companions (the skips), the level-0 floor, the counters
           ("steps", ctypes.c_void_p),
           ("pool", ctypes.c_void_p * _MAX_LEVELS),
           ("pool_w", ctypes.c_int * _MAX_LEVELS),
           ("pool_min0", ctypes.c_void_p), ("counters", ctypes.c_void_p),
           ("n_steps", ctypes.c_int),
           # K2's sign-exact arm of the skips
           ("sign_exact", ctypes.c_int),
           # the shard variants: each level buffer's first padded row
           ("lvl_row0", ctypes.c_int * _MAX_LEVELS)])


def kernel_lib():
    """The loaded library of K1 and K2 (built with nvcc on first use)."""
    lib = _build.load("horizon_sweep")
    for fn in (lib.horizon_sweep_launch, lib.horizon_sweep_argmax_launch,
               lib.shadow_sweep_launch, lib.shadow_sweep_argmax_launch):
        fn.argtypes = [ctypes.POINTER(_HzParams), ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.horizon_sweep_error_string.argtypes = [ctypes.c_int]
    lib.horizon_sweep_error_string.restype = ctypes.c_char_p
    lib.horizon_sweep_params_size.argtypes = []
    lib.horizon_sweep_params_size.restype = ctypes.c_int
    size = lib.horizon_sweep_params_size()
    if size != ctypes.sizeof(_HzParams):
        raise RuntimeError(f"HzParams is {size} bytes in the kernel but "
                           f"{ctypes.sizeof(_HzParams)} in _HzParams")
    return lib


def kernel_params(z_org, z_inner, levels, plan, outer_shape, n_rows, out):
    """``HzParams`` of one launch of K1 or K2 over ``n_rows`` azimuths or
    suns writing ``out``, with every field the two modes share; the tensors
    are checked as the kernel takes them.  The variant pointers (ramp, mask,
    block list), the pooled companions and the counters start null, as
    ctypes zero-fills a structure.  The step table (:func:`step_table`) goes
    to the card through pinned memory without waiting for the stream; the
    structure keeps it alive (``prm.keep``) until the launch is queued."""
    dev = z_org.device
    for t in (z_org, z_inner, *levels, out):
        if (t.device != dev or t.dtype != torch.float32
                or not t.is_contiguous()):
            raise ValueError("the sweep kernel takes contiguous float32 "
                             "tensors on one CUDA device")
    in0, in1 = plan["inner_shape"]
    if z_org.shape != (in0, in1) or z_inner.shape != (in0, in1):
        raise ValueError("z_org/z_inner do not have the inner shape")
    if tuple(out.shape) != (n_rows, in0, in1):
        raise ValueError("out does not have the output shape")
    phases = plan["phases_meta"]
    if len(levels) > _MAX_LEVELS or len(phases) > _MAX_LEVELS:
        raise ValueError(f"at most {_MAX_LEVELS} pyramid levels")
    if max(t.numel() for t in (z_org, *levels)) >= 2 ** 31:
        raise ValueError("the sweep kernel addresses a level and the inner "
                         "domain with 32-bit offsets: each must hold fewer "
                         "than 2^31 cells")
    steps = step_table(plan)
    if steps.nbytes > _MAX_STEP_BYTES:
        raise ValueError(f"{steps.shape[0]} samples per (cell, row): the "
                         f"step table exceeds {_MAX_STEP_BYTES} bytes of "
                         f"shared memory")
    prm = _HzParams()
    prm.keep = [_replay._table_to(steps, dev)]
    prm.steps, prm.n_steps = prm.keep[0].data_ptr(), steps.shape[0]
    prm.z_org, prm.z_inner = z_org.data_ptr(), z_inner.data_ptr()
    prm.out = out.data_ptr()
    lvl_row0 = plan.get("lvl_row0") or (0,) * len(levels)
    for lvl, t in enumerate(levels):
        prm.lvl[lvl] = t.data_ptr()
        prm.lvl_w[lvl] = t.shape[1]
        prm.lvl_pad[lvl] = plan["pads"][lvl]
        prm.lvl_row0[lvl] = lvl_row0[lvl]
    for p, (lvl, n_m, s_first, step_l) in enumerate(phases):
        prm.ph_lvl[p], prm.ph_n[p] = lvl, n_m
        prm.ph_s_first[p], prm.ph_step[p] = s_first, step_l
    prm.n_phases = len(phases)
    prm.in0, prm.in1, prm.a_num = in0, in1, n_rows
    prm.off0, prm.off1 = plan["offset"]
    prm.h, prm.w = outer_shape
    for n in ("ns2", "nx", "ns1", "n_dense"):
        setattr(prm, n, plan[n])
    prm.dx, prm.dy = _f32(plan["dx"]), _f32(plan["dy"])
    for n, v in plan["consts"].items():
        setattr(prm, n, v)
    return prm


def launch(lib, entry, prm, dev):
    """Launch ``entry`` of the sweep library on the current stream of
    ``dev``; raise if the launch fails."""
    err = entry(ctypes.byref(prm), dev.index,
                torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        msg = lib.horizon_sweep_error_string(err).decode()
        raise RuntimeError(f"horizon_sweep kernel launch failed: {msg}")


def live_grid(mask):
    """(block rows, block columns) bool: the kernel's 32 x 8 blocks that
    hold a nonzero cell of ``mask`` (in0, in1), on ``mask``'s device."""
    in0, in1 = mask.shape
    nb0 = -(-in0 // BLOCK_ROWS)
    nb1 = -(-in1 // BLOCK_COLS)
    full = torch.zeros((nb0 * BLOCK_ROWS, nb1 * BLOCK_COLS), dtype=torch.bool,
                       device=mask.device)
    full[:in0, :in1] = mask != 0
    return full.view(nb0, BLOCK_ROWS, nb1, BLOCK_COLS).any(dim=3).any(dim=1)


def live_blocks(mask):
    """(n, 2) int32 (block row, block column) of the blocks of
    :func:`live_grid`, row-major: the counterpart of
    ``pallas_sweep.tile_schedule`` at the kernel's block."""
    return torch.nonzero(live_grid(mask)).to(torch.int32).contiguous()


def _check_inner(t, what, dtype, plan, dev):
    in0, in1 = plan["inner_shape"]
    if (t.device != dev or t.dtype != dtype or not t.is_contiguous()
            or tuple(t.shape) != (in0, in1)):
        raise ValueError(f"{what} must be a contiguous {dtype} tensor of "
                         f"the inner shape {(in0, in1)} on {dev}")


def check_counters(counters, dev):
    """``counters`` is what a launch may add its sample counts to."""
    if (counters.device != dev or counters.dtype != torch.int64
            or tuple(counters.shape) != (len(COUNTER_FIELDS),)):
        raise ValueError(f"counters must be a ({len(COUNTER_FIELDS)},) "
                         f"int64 tensor on {dev}")


def skip_inputs(levels, plan):
    """What the skips of K1 and K2 read beside the levels: the 8 x 8
    max-pooled companion of each padded level
    (:func:`horayzon_tpu_torch.ops.mip.pool8`) and the 8 x 8 min-pooled
    floor of level 0's in-domain cells
    (:func:`horayzon_tpu_torch.ops.mip.pool8_floor`; a d1 chunk that may
    skip reads only in-domain stencils: K1's safe pairs, and K2's valid
    parabolas), on the levels' device.  The ``pooled`` of
    ``shadow_sweep.shadow_metric_fused``."""
    return _mip.pool8(levels), _mip.pool8_floor(levels[0], plan["pads"][0])


def _ratio_cuda(z_org, z_inner, levels, trig, plan, outer_shape,
                tilt_ramp=None, mask=None, emit_argmax=False, counters=None,
                pooled=None):
    """Raw ratios (A, in0, in1) from kernel K1 on ``z_org``'s card;
    ``emit_argmax``: ``(raw, ids, aux)`` from K1's argmax variant, as
    :func:`_ratio_plain` returns them.  With ``mask`` the outputs are first
    filled with a masked cell's values (raw 3e38, id ID_NONE, D 1), and
    only the live blocks are launched; with no live block nothing is.
    ``counters``: a (4,) int64 tensor on the card to which the launch adds
    the (cell, azimuth) samples of swept cells it took and skipped in the
    safe d1 pairs and in the mip phases (:data:`COUNTER_FIELDS`); when None
    and the profiler records, ``utils.profiling``'s counters of "k1".
    ``pooled``: :func:`skip_inputs` of the levels (built here when None);
    a shard whose levels are windows (``plan["lvl_row0"]``) passes the
    window's rows of the full levels' companions."""
    global KERNEL_LAUNCHES, ARGMAX_KERNEL_LAUNCHES, SHARD_KERNEL_LAUNCHES
    global MASK_KERNEL_LAUNCHES, TILT_KERNEL_LAUNCHES
    dev = z_org.device
    in0, in1 = plan["inner_shape"]
    shape = (trig.shape[0], in0, in1)

    def output(fill, dtype):
        if mask is None:
            return torch.empty(shape, dtype=dtype, device=dev)
        return torch.full(shape, fill, dtype=dtype, device=dev)

    out = output(_POS_INIT, torch.float32)
    prm = kernel_params(z_org, z_inner, levels, plan, outer_shape,
                        trig.shape[0], out)
    if pooled is None:
        if any(plan.get("lvl_row0") or ()):
            raise ValueError("levels cut as windows need the pooled "
                             "companions of the full levels")
        pooled = skip_inputs(levels, plan)
    pooled, pool_min0 = pooled
    trig_t = _replay._table_to(trig, dev)
    prm.keep += [trig_t, pool_min0, *pooled]
    prm.trig, prm.pool_min0 = trig_t.data_ptr(), pool_min0.data_ptr()
    for lvl, t in enumerate(pooled):
        prm.pool[lvl], prm.pool_w[lvl] = t.data_ptr(), t.shape[1]
    if counters is None:
        counters = _profiling.launch_counters("k1", dev)
    if counters is not None:
        check_counters(counters, dev)
        prm.counters = counters.data_ptr()
    if emit_argmax:
        ids = output(_replay.ID_NONE, torch.int32)
        aux = output(1.0, torch.float32)
        prm.ids, prm.aux = ids.data_ptr(), aux.data_ptr()
    result = (out, ids, aux) if emit_argmax else out
    if tilt_ramp is not None:
        for t, what in zip(tilt_ramp, ("tilt_ramp[0]", "tilt_ramp[1]")):
            _check_inner(t, what, torch.float32, plan, dev)
        prm.ramp_a, prm.ramp_b = (t.data_ptr() for t in tilt_ramp)
    if mask is not None:
        _check_inner(mask, "mask", torch.uint8, plan, dev)
        blocks = live_blocks(mask)
        if blocks.shape[0] == 0:
            return result
        prm.mask, prm.blocks = mask.data_ptr(), blocks.data_ptr()
        prm.n_blocks = blocks.shape[0]
    lib = kernel_lib()
    launch(lib, lib.horizon_sweep_argmax_launch if emit_argmax
           else lib.horizon_sweep_launch, prm, dev)
    if emit_argmax:
        ARGMAX_KERNEL_LAUNCHES += 1
    else:
        KERNEL_LAUNCHES += 1
    SHARD_KERNEL_LAUNCHES += "shard" in plan
    MASK_KERNEL_LAUNCHES += mask is not None
    TILT_KERNEL_LAUNCHES += tilt_ramp is not None
    return result


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def check_block(z, offset, inner_shape):
    """``z`` is 2-D and holds the inner block ``inner_shape`` at
    ``offset``."""
    if z.ndim != 2:
        raise ValueError(f"z_outer must be 2-D, got shape {tuple(z.shape)}")
    (off0, off1), (in0, in1) = offset, inner_shape
    if (min(off0, off1) < 0 or min(in0, in1) < 1
            or off0 + in0 > z.shape[0] or off1 + in1 > z.shape[1]):
        raise ValueError(f"inner block {tuple(inner_shape)} at offset "
                         f"{tuple(offset)} does not lie inside z_outer "
                         f"{tuple(z.shape)}")


def check_pyramid(pyramid, z, pads):
    """``pyramid`` as the padded levels of ``z`` for ``pads``: float32,
    contiguous, on ``z``'s device."""
    shapes = _mip.level_shapes(tuple(z.shape), len(pads))
    if len(pyramid) != len(pads):
        raise ValueError(f"pyramid has {len(pyramid)} levels, the schedule "
                         f"needs {len(pads)}")
    levels = []
    for lvl, (t, (hl, wl), p) in enumerate(zip(pyramid, shapes, pads)):
        if not isinstance(t, torch.Tensor) or t.device != z.device:
            raise ValueError(f"pyramid level {lvl} is not a tensor on "
                             f"{z.device}")
        if tuple(t.shape) != (hl + 2 * p, wl + 2 * p):
            raise ValueError(f"pyramid level {lvl} has shape "
                             f"{tuple(t.shape)}, expected "
                             f"{(hl + 2 * p, wl + 2 * p)}")
        levels.append(t.detach().to(torch.float32).contiguous())
    return levels


def _inner_tensor(a, what, dtype, inner_shape, dev):
    """``a`` (a tensor or an array) as a contiguous ``dtype`` tensor of the
    inner shape on ``dev``, detached."""
    t = (torch.from_numpy(np.ascontiguousarray(a)) if isinstance(a, np.ndarray)
         else torch.as_tensor(a))
    if tuple(t.shape) != tuple(inner_shape):
        raise ValueError(f"{what} has shape {tuple(t.shape)}, expected the "
                         f"inner shape {tuple(inner_shape)}")
    return t.detach().to(device=dev, dtype=dtype).contiguous()


def sweep_args(z_outer, *, dx, dy, offset, inner_shape, azim_num,
               dist_search, hori_acc=0.25, ray_org_elev=0.01, rel_err=None,
               max_level=10, pyramid=None, tilt_ramp=None, mask=None):
    """The sweep's inputs ``(z_org, z_inner, levels, trig, plan,
    outer_shape, tilt_ramp, mask)`` for :func:`_ratio_cuda` /
    :func:`_ratio_plain`, from the arguments of :func:`horizon_sweep_fused`
    (validated as it validates them).  ``z_outer`` must be a float32
    tensor; ``tilt_ramp`` comes back as two float32 tensors and ``mask`` as
    a uint8 tensor on its device, each of the inner shape (or None)."""
    z = z_outer
    check_block(z, offset, inner_shape)
    if int(azim_num) < 1:
        raise ValueError("azim_num must be at least 1")
    (off0, off1), (in0, in1) = offset, inner_shape
    plan = plan_sweep(tuple(z.shape), inner_shape=(in0, in1),
                      offset=(off0, off1), dist_search=dist_search, dx=dx,
                      dy=dy, hori_acc=hori_acc, rel_err=rel_err,
                      max_level=max_level)
    if tilt_ramp is not None:
        if len(tilt_ramp) != 2:
            raise ValueError("tilt_ramp must be a pair (A, B)")
        tilt_ramp = tuple(_inner_tensor(r, f"tilt_ramp[{n}]", torch.float32,
                                        (in0, in1), z.device)
                          for n, r in enumerate(tilt_ramp))
    if mask is not None:
        dtype = getattr(mask, "dtype", None)
        if dtype not in (np.uint8, np.bool_, torch.uint8, torch.bool):
            raise TypeError(f"mask must be uint8 or bool, got {dtype}")
        mask = _inner_tensor(mask, "mask", torch.uint8, (in0, in1), z.device)
    if pyramid is None:
        levels = _mip.padded_levels(z, plan["pads"])
    else:
        levels = check_pyramid(pyramid, z, plan["pads"])
    z_inner = z[off0:off0 + in0, off1:off1 + in1].contiguous()
    z_org = z_inner + float(_f32(ray_org_elev))
    return (z_org, z_inner, levels, trig_table(int(azim_num)), plan,
            tuple(z.shape), tilt_ramp, mask)


def _all_masked(args):
    """The mask of :func:`sweep_args`'s ``args`` has no cell to sweep."""
    return args[7] is not None and not bool(args[7].any())


def _low_lim_fill(args, elev_ang_low_lim):
    """The all-masked result: the lower limit everywhere
    (``pallas_sweep.py:1228-1229``), (in0, in1, A)."""
    in0, in1 = args[4]["inner_shape"]
    return torch.full((in0, in1, args[3].shape[0]),
                      math.radians(elev_ang_low_lim), dtype=torch.float32,
                      device=args[0].device)


def _angles(ratio, elev_ang_low_lim, elev_ang_up_lim):
    """Clipped arctan of (A, in0, in1) ratios, in place (the ratio is the
    largest buffer of the call), as (in0, in1, A)."""
    ratio.atan_().clamp_(math.radians(elev_ang_low_lim),
                         math.radians(elev_ang_up_lim))
    return ratio.permute(1, 2, 0).contiguous()


def raw_cotangent(raw, g, lims):
    """Cotangent of the raw ratios (A, in0, in1) from that of the clipped
    arctan ``g`` (in0, in1, A): zero where the angle is clipped, else
    ``g / (1 + raw^2)`` (``_hz_bwd_replay``, ``pallas_sweep.py:2662-2667``).
    ``lims``: the elevation limits [degree]."""
    lo, hi = (math.radians(v) for v in lims)
    th = torch.atan(raw)
    inside = (th >= lo) & (th <= hi)
    return (torch.where(inside, g.permute(2, 0, 1), 0.0)
            / (1.0 + raw * raw)).contiguous()


def ramp_cotangent(graw, trig):
    """Cotangent of the tilt ramp (A, B) from that of the raw ratios
    (A, in0, in1): ``(sum_a graw sin, sum_a graw cos)`` over the float32
    table (``_hz_bwd_replay``, ``pallas_sweep.py:2672-2680``)."""
    tab = torch.from_numpy(trig).to(graw.device)
    return (torch.einsum("aij,a->ij", graw, tab[:, 0]),
            torch.einsum("aij,a->ij", graw, tab[:, 1]))


# ---------------------------------------------------------------------------
# The recompute VJP (HZT_GRAD_RECOMPUTE=1)
# ---------------------------------------------------------------------------

#: Bytes that autograd keeps per (window cell, azimuth) for one padded
#: sample of :func:`horayzon_tpu_torch.ops.sweep.horizon_core`, by kind of
#: phase: a d2 step (two bilinear reads, their in-domain masks, the
#: parabola), a d1 step (one read, the parabola of every other step) and a
#: mip step (one nearest read).  Upper bounds of what ``torch.autograd.graph.
#: saved_tensors_hooks`` counts (``tests/test_torch_recompute.py``); the
#: int64 gather indices are most of them.
RECOMPUTE_STEP_BYTES = {"d2": 80, "d1": 48, "mip": 12}
#: The share of the free device memory a recompute chunk's graph may take
#: (the rest holds the backward's own temporaries: one level-sized
#: cotangent per gather, the chunk's cotangents).
RECOMPUTE_MEM_SHARE = 0.6
#: The memory a recompute chunk's graph may take on the CPU.
RECOMPUTE_CPU_BYTES = 4 * 2 ** 30
#: Azimuths per chunk of the last recompute backward (None before one).
LAST_RECOMPUTE_CHUNK = None


def _grad_mode():
    """The backward of the gradient entries, read when their forward runs:
    ``"recompute"`` where ``HZT_GRAD_RECOMPUTE`` is ``"1"``, else
    ``"replay"`` (``pallas_sweep.py:1645-1648``)."""
    return ("recompute" if os.environ.get("HZT_GRAD_RECOMPUTE") == "1"
            else "replay")


def recompute_schedule(plan, outer_shape):
    """The schedule of the recompute VJP: the plan's, its safe phases
    marked on the whole domain's halo (``pallas_sweep.py:1604-1610``;
    ``horayzon_tpu/parallel/shard.py:163-172`` for every shard)."""
    schedule = _sweep.build_schedule(plan["step"], plan["dist"],
                                     plan["rel_err"],
                                     max_level=plan["max_level"])
    (off0, off1), (in0, in1) = plan["offset"], plan["inner_shape"]
    h_out, w_out = outer_shape
    halo = min(off0, off1, h_out - off0 - in0, w_out - off1 - in1)
    return _sweep.mark_safe_phases(schedule, halo)


def equiv_azimuths(azim_num):
    """(A,) float64 azimuths ``2 pi k / A`` rounded to float32, as K1's
    table rounds them (``pallas_sweep.py:1615-1616``)."""
    return ((2.0 * np.pi) / azim_num
            * np.arange(azim_num)).astype(np.float32).astype(np.float64)


def equiv_raw(levels, z_org, z_inner, tables, trig, schedule, outer_shape,
              a_chunk=None):
    """Raw ratios (rows, in1, C) of the XLA sweep that the recompute VJP
    differentiates (``ops.sweep.horizon_core``, planar, no distances, no
    arctan) over the padded ``levels`` of an ``outer_shape`` grid:
    ``tables`` the shift tables (``ops.sweep.horizon_shift_tables``) of
    the C azimuths of ``trig`` (a (C, 2) float32 :func:`trig_table`),
    ``z_org`` / ``z_inner`` the (rows, in1) ray origins and heights."""
    trig_d = {"sin": trig[:, 0], "cos": trig[:, 1], "ux": trig[:, 0],
              "uy": trig[:, 1]}
    raw, _ = _sweep.horizon_core(
        tuple(levels), z_org, z_inner, None, tables, trig_d,
        sched_meta=schedule.meta(), pads=schedule.pads,
        inner_shape=tuple(z_org.shape), planar=True, track_dist=False,
        outer_shape=tuple(outer_shape), apply_arctan=False, a_chunk=a_chunk)
    return raw


def equiv_angles(raw, trig, tilt_ramp, lims):
    """``clip(arctan((raw + sin A) + cos B))`` of (rows, in1, C) raw
    ratios, the ramp's terms added before the arctan and the clip
    splitting ties as ``jnp.clip`` does (``pallas_sweep.py:1632-1637``).
    ``lims``: the elevation limits [degree]."""
    if tilt_ramp is not None:
        tab = torch.from_numpy(trig).to(raw.device)
        raw = ((raw + tab[:, 0] * tilt_ramp[0][..., None])
               + tab[:, 1] * tilt_ramp[1][..., None])
    lo, hi = (math.radians(v) for v in lims)
    return _sweep.tie_clip(torch.atan(raw), lo, hi)


def hz_xla_equiv(plan, trig, z, tilt_ramp=None, *, ray_org_elev=0.01,
                 lims=(-15.0, 89.98)):
    """The function whose VJP is the recompute gradient
    (``_hz_xla_equiv``, ``pallas_sweep.py:1600-1637``): the XLA sweep of
    ``z`` with K1's schedule knobs (:func:`recompute_schedule`), K1's
    float32 azimuths and trig table ``trig``, ``z_org = z_inner +
    float32(ray_org_elev)``, the ramp and the clip of
    :func:`equiv_angles`.  Differentiable by autograd w.r.t. ``z`` and the
    ramp; no mask (the reference's recompute takes none).  Returns
    (in0, in1, A) float32 [radian]."""
    schedule = recompute_schedule(plan, tuple(z.shape))
    (off0, off1), (in0, in1) = plan["offset"], plan["inner_shape"]
    tables = _sweep.horizon_shift_tables(
        schedule, equiv_azimuths(trig.shape[0]), plan["dx"], plan["dy"],
        plan["offset"])
    z_inner = z[off0:off0 + in0, off1:off1 + in1]
    z_org = z_inner + float(_f32(ray_org_elev))
    raw = equiv_raw(_mip.padded_levels(z, plan["pads"]), z_org, z_inner,
                    tables, trig, schedule, tuple(z.shape))
    return equiv_angles(raw, trig, tilt_ramp, lims)


def recompute_bytes(schedule, shape):
    """Bytes of the recompute graph of one azimuth over a (rows, in1)
    block: :data:`RECOMPUTE_STEP_BYTES` over the schedule's padded samples
    and the (rows + 1, in1 + 1) windows."""
    rows, in1 = shape
    per_cell = sum(-(-num // _sweep.UNROLL) * _sweep.UNROLL
                   * RECOMPUTE_STEP_BYTES[kind]
                   for kind, _level, _pad, num, _safe in schedule.meta())
    return per_cell * (rows + 1) * (in1 + 1)


def recompute_chunk(schedule, shape, a_num, levels, device):
    """Azimuths per chunk of the recompute backward over a (rows, in1)
    block: as many as keep the graph of one chunk (:func:`recompute_bytes`
    per azimuth) within :data:`RECOMPUTE_MEM_SHARE` of the memory free on
    the card (cached blocks included) less two copies of the levels (their
    cotangents), or :data:`RECOMPUTE_CPU_BYTES` on the CPU; balanced over
    the chunks.  Raises ``MemoryError`` when one azimuth does not fit."""
    rows, in1 = shape
    per_az = recompute_bytes(schedule, shape)
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        free += (torch.cuda.memory_reserved(device)
                 - torch.cuda.memory_allocated(device))
        budget = RECOMPUTE_MEM_SHARE * free - 2 * sum(
            lv.numel() * lv.element_size() for lv in levels)
    else:
        budget = RECOMPUTE_CPU_BYTES
    per_chunk = int(budget // per_az)
    if per_chunk < 1:
        raise MemoryError(
            f"the recompute backward needs {per_az / 2 ** 30:.1f} GiB for "
            f"one azimuth of a {rows} x {in1} block and has "
            f"{max(budget, 0) / 2 ** 30:.1f} GiB on {device}")
    n_chunks = -(-a_num // per_chunk)
    return -(-a_num // n_chunks)


def equiv_vjp(levels, x, tilt_ramp, g, tables, trig, schedule, outer_shape,
              *, ray_org_elev, lims, from_org, a_chunk):
    """The VJP of one block's recompute angles (:func:`equiv_raw` then
    :func:`equiv_angles`) applied to ``g`` (rows, in1, C), recomputed and
    differentiated ``a_chunk`` azimuths at a time, the cotangents summed
    over the chunks in order.  ``levels``: the padded levels on the
    block's device; ``x``: the block's (rows, in1) heights, or with
    ``from_org`` its ray origins (a shard's heights are ``z_org -
    ray_org_elev``, ``horayzon_tpu/parallel/shard.py:211``); ``tables``,
    ``trig``: the C azimuths'.  Returns ``(level_cots, x_cot, ramp_cots)``:
    one cotangent per level (None for a level no chunk reads), that of
    ``x``, and that of the ramp (None without one)."""
    global LAST_RECOMPUTE_CHUNK
    LAST_RECOMPUTE_CHUNK = a_chunk
    elev = float(_f32(ray_org_elev))
    lv = [t.detach().requires_grad_(True) for t in levels]
    xl = x.detach().requires_grad_(True)
    rl = () if tilt_ramp is None else tuple(
        r.detach().requires_grad_(True) for r in tilt_ramp)
    leaves = lv + [xl] + list(rl)
    total = [None] * len(leaves)
    a_num = trig.shape[0]
    for a0 in range(0, a_num, a_chunk):
        sl = slice(a0, min(a0 + a_chunk, a_num))
        with torch.enable_grad():
            z_org, z_inner = (xl, xl - elev) if from_org else (xl + elev, xl)
            raw = equiv_raw(lv, z_org, z_inner,
                            [{k: v[sl] for k, v in t.items()} for t in tables],
                            trig[sl], schedule, outer_shape,
                            a_chunk=sl.stop - sl.start)
            out = equiv_angles(raw, trig[sl], rl or None, lims)
            del raw
            grads = torch.autograd.grad(out, leaves, g[..., sl],
                                        allow_unused=True)
        del out
        for i, gr in enumerate(grads):
            if gr is not None:
                total[i] = gr if total[i] is None else total[i].add_(gr)
    n = len(lv)
    x_cot = total[n] if total[n] is not None else torch.zeros_like(x)
    ramp_cots = None
    if rl:
        ramp_cots = tuple(c if c is not None else torch.zeros_like(r)
                          for c, r in zip(total[n + 1:], rl))
    return total[:n], x_cot, ramp_cots


def recompute_vjp(z, tilt_ramp, g, plan, trig, *, ray_org_elev, lims):
    """``(dz, ramp_cots)``: the VJP of :func:`hz_xla_equiv` at ``(z,
    tilt_ramp)`` applied to ``g`` (in0, in1, A) (``_hz_bwd``'s recompute,
    ``pallas_sweep.py:1677-1689``), azimuth chunks of
    :func:`recompute_chunk` through :func:`equiv_vjp`; the level
    cotangents reach ``z`` through the pyramid's VJP."""
    schedule = recompute_schedule(plan, tuple(z.shape))
    (off0, off1), (in0, in1) = plan["offset"], plan["inner_shape"]
    zd = z.detach()
    levels = _mip.padded_levels(zd, plan["pads"])
    tables = _sweep.horizon_shift_tables(
        schedule, equiv_azimuths(trig.shape[0]), plan["dx"], plan["dy"],
        plan["offset"])
    a_chunk = recompute_chunk(schedule, (in0, in1), trig.shape[0], levels,
                              z.device)
    level_cots, x_cot, ramp_cots = equiv_vjp(
        levels, zd[off0:off0 + in0, off1:off1 + in1], tilt_ramp, g, tables,
        trig, schedule, tuple(z.shape), ray_org_elev=ray_org_elev,
        lims=lims, from_org=False, a_chunk=a_chunk)
    level_cots = [c if c is not None else torch.zeros_like(lv)
                  for c, lv in zip(level_cots, levels)]
    return _replay.z_cotangent(zd, plan, level_cots, x_cot), ramp_cots


class _HorizonSweepFn(torch.autograd.Function):
    """The sweep with its two backwards, chosen as the reference chooses
    them when the forward runs (:func:`_grad_mode`, ``_pallas_hz``,
    ``pallas_sweep.py:1598-1692``).

    The winner replay (default; ``_hz_fwd`` / ``_hz_bwd_replay``,
    ``pallas_sweep.py:1651-1692, 2659-2703``; with ``levels`` the multires
    ``_mr_hz``, ``horayzon_tpu/ops/multires.py:334-395``).  Forward: K1's
    argmax variant (CUDA) or the plain argmax sweep (CPU), with the tilt
    ramp and the mask when given, saving raw, ids and aux.  Backward: the
    cotangent chained through clip and arctan; K3 (CUDA) or the plain
    replay (CPU) (masked cells hold ID_NONE and a clipped angle, so they
    add nothing); for the ramp :func:`ramp_cotangent`.

    The recompute (``HZT_GRAD_RECOMPUTE=1``, where the pyramid is ``z``'s
    own; ``_hz_fwd`` / ``_hz_bwd``'s first branch).  Forward: K1 (CUDA) or
    the plain sweep (CPU), with the ramp and the mask, saving ``z`` and
    the ramp alone.  Backward: :func:`recompute_vjp`, the VJP of the XLA
    sweep :func:`hz_xla_equiv`, in azimuth chunks; no K3.  As in the
    reference it ignores the mask: a masked cell that receives a
    cotangent passes on the unmasked sweep's gradient there.

    An all-masked call gives the lower limit everywhere and zero
    gradients in both modes, as the reference's constant result does.

    Without ``levels`` the pyramid is ``z``'s own and the replay's level
    cotangents go through its VJP to ``z``.  With ``levels`` (the padded
    pyramid as further inputs, e.g. a combined fine + coarse one) they are
    returned as the levels' own cotangents, for autograd to carry to
    whatever the caller built the levels from, and ``z`` gets the ray
    origins' cotangent at the inner block alone; the reference's
    ``_mr_hz`` reads no variable, so this is always the replay."""

    @staticmethod
    def forward(ctx, z, ramp_a, ramp_b, kw, *levels):
        ramp = None if ramp_a is None else (ramp_a, ramp_b)
        args = sweep_args(z, tilt_ramp=ramp, pyramid=levels or None,
                          **kw["sweep"])
        ctx.lims, ctx.has_ramp = kw["lims"], ramp is not None
        ctx.own_pyramid = not levels
        ctx.recompute = ctx.own_pyramid and _grad_mode() == "recompute"
        ctx.empty = _all_masked(args)
        if ctx.empty:
            ctx.save_for_backward(z)
            ctx.inner_shape = args[4]["inner_shape"]
            return _low_lim_fill(args, kw["lims"][0])
        ratio_fn = _ratio_cuda if z.is_cuda else _ratio_plain
        ctx.plan, ctx.trig = args[4], args[3]
        if ctx.recompute:
            ctx.save_for_backward(z, *(args[6] or ()))
            ctx.ray_org_elev = kw["sweep"]["ray_org_elev"]
            return _angles(ratio_fn(*args), *kw["lims"])
        raw, ids, aux = ratio_fn(*args, emit_argmax=True)
        ctx.save_for_backward(z, raw, ids, aux)
        return _angles(raw.clone(), *kw["lims"])

    @staticmethod
    def backward(ctx, g):
        need_z, need_a, need_b = ctx.needs_input_grad[:3]
        need_lv = ctx.needs_input_grad[4:]
        if ctx.empty:
            (z,) = ctx.saved_tensors
            zero = z.new_zeros(ctx.inner_shape)
            return (torch.zeros_like(z) if need_z else None,
                    zero if need_a else None, zero if need_b else None,
                    None) + (None,) * len(need_lv)
        if ctx.recompute:
            z, *ramp = ctx.saved_tensors
            dz, dr = recompute_vjp(z, tuple(ramp) or None, g, ctx.plan,
                                   ctx.trig, ray_org_elev=ctx.ray_org_elev,
                                   lims=ctx.lims)
            dra, drb = (None, None) if dr is None else dr
            return (dz if need_z else None, dra if need_a else None,
                    drb if need_b else None, None)
        z, raw, ids, aux = ctx.saved_tensors
        graw = raw_cotangent(raw, g, ctx.lims)
        dz = dra = drb = None
        dlv = (None,) * len(need_lv)
        if need_z or any(need_lv):
            level_cots, zcot = _replay.backward_replay(
                tuple(z.shape), graw, ids, aux, ctx.plan,
                _replay.horizon_shifts(ctx.trig, ctx.plan))
            if ctx.own_pyramid:
                dz = _replay.z_cotangent(z, ctx.plan, level_cots, zcot)
            else:
                dlv = tuple(c if n else None
                            for c, n in zip(level_cots, need_lv))
                if need_z:
                    (off0, off1), (in0, in1) = (ctx.plan["offset"],
                                                ctx.plan["inner_shape"])
                    dz = torch.zeros_like(z)
                    dz[off0:off0 + in0, off1:off1 + in1] = zcot
        if ctx.has_ramp and (need_a or need_b):
            dra, drb = ramp_cotangent(graw, ctx.trig)
        return (dz, dra, drb, None) + dlv


def horizon_sweep_fused(z_outer, *, dx, dy, offset, inner_shape, azim_num,
                        dist_search, hori_acc=0.25, elev_ang_low_lim=-15.0,
                        elev_ang_up_lim=89.98, ray_org_elev=0.01,
                        rel_err=None, max_level=10, pyramid=None,
                        tilt_ramp=None, mask=None):
    """Planar gridded horizon via the fused sweep.

    Same contract as ``horayzon_tpu.ops.pallas_sweep.horizon_sweep_pallas``:
    uniform azimuths ``2*pi*k/azim_num``, ``z_outer`` the (H, W) outer
    heightfield, ``offset``/``inner_shape`` the inner block, ``dist_search``
    in metres.  ``tilt_ramp``: optional pair (A, B) of (in0, in1) arrays or
    tensors adding ``sin(az)*A + cos(az)*B`` to the ratio before the arctan
    (the curved-Earth correction, A = n_x/n_z, B = n_y/n_z of the cell's
    normal).  ``mask``: optional (in0, in1) uint8 or bool, nonzero where a
    cell is swept; masked cells hold the upper elevation limit (callers
    apply their fill), and a mask with no such cell gives the lower limit
    everywhere without a launch.

    A CUDA ``z_outer`` runs kernel K1 (built with nvcc on first use; a
    failed build or launch raises); a CPU ``z_outer`` runs
    :func:`horizon_sweep_plain`.  ``pyramid``: optional padded levels in
    the layout of :func:`horayzon_tpu_torch.ops.mip.padded_levels`, on
    ``z_outer``'s device.

    Differentiable w.r.t. ``z_outer``, the ramp and the levels of a given
    ``pyramid``: when any of them requires grad (and grad mode is on), the
    sweep runs as :class:`_HorizonSweepFn`, the argmax forward with the
    winner-replay backward (K1's argmax variant and K3 on the card, their
    plain versions on the CPU); the gradient is the one ``jax.grad`` takes
    through ``horizon_sweep_pallas``.  A given ``pyramid`` is an input of
    its own there: each level receives the replay's cotangent, which
    autograd carries on to whatever the levels were built from (both grids
    of :func:`horayzon_tpu_torch.ops.multires.combined_pyramid`), and
    ``z_outer`` receives only the ray origins' share.  Levels that do not
    require grad beside a ``z_outer`` that does therefore give an
    incomplete gradient of ``z_outer``: the call warns.  With
    ``HZT_GRAD_RECOMPUTE=1`` in the environment when the forward runs (and
    no ``pyramid``), the backward is the reference's recompute VJP
    instead: K1 forward, then autograd through the XLA sweep
    (:func:`recompute_vjp`), with no K3.

    Returns (in0, in1, azim_num) float32 [radian] on ``z_outer``'s device.
    """
    z = torch.as_tensor(z_outer)
    if z.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no horizon sweep for device {z.device}")
    sweep_kw = dict(dx=dx, dy=dy, offset=offset, inner_shape=inner_shape,
                    azim_num=azim_num, dist_search=dist_search,
                    hori_acc=hori_acc, ray_org_elev=ray_org_elev,
                    rel_err=rel_err, max_level=max_level, mask=mask)
    lims = (elev_ang_low_lim, elev_ang_up_lim)
    ramp = (None, None) if tilt_ramp is None else tuple(tilt_ramp)
    if len(ramp) != 2:
        raise ValueError("tilt_ramp must be a pair (A, B)")
    levels = () if pyramid is None else tuple(pyramid)
    if torch.is_grad_enabled() and (z.requires_grad or any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in ramp + levels)):
        if z.requires_grad and levels and not any(
                isinstance(t, torch.Tensor) and t.requires_grad
                for t in levels):
            warnings.warn(
                "z_outer requires grad but no level of the given pyramid "
                "does: z_outer receives the ray origins' share of the "
                "gradient alone.  Build the levels under autograd from "
                "z_outer (mip.padded_levels, multires.multires_levels or "
                "multires.horizon_sweep_multires_fused), or leave pyramid "
                "out.", stacklevel=2)
        ramp = tuple(None if r is None else torch.as_tensor(r).to(
            device=z.device, dtype=torch.float32) for r in ramp)
        return _HorizonSweepFn.apply(z.to(torch.float32).contiguous(),
                                     *ramp, dict(sweep=sweep_kw, lims=lims),
                                     *levels)
    ratio_fn = _ratio_cuda if z.device.type == "cuda" else _ratio_plain
    return _run(ratio_fn, z, lims, dict(sweep_kw, pyramid=pyramid,
                                        tilt_ramp=tilt_ramp))


def _run(ratio_fn, z_outer, lims, sweep_kw):
    with _profiling.span("hzt.sweep.prepare"):
        z = torch.as_tensor(z_outer).detach().to(torch.float32).contiguous()
        args = sweep_args(z, **sweep_kw)
        empty = _all_masked(args)
    if empty:
        with _profiling.span("hzt.sweep.angles"):
            return _low_lim_fill(args, lims[0])
    with _profiling.span("hzt.sweep.k1"):
        ratio = ratio_fn(*args)
    with _profiling.span("hzt.sweep.angles"):
        return _angles(ratio, *lims)


def horizon_sweep_plain(z_outer, *, dx, dy, offset, inner_shape, azim_num,
                        dist_search, hori_acc=0.25, elev_ang_low_lim=-15.0,
                        elev_ang_up_lim=89.98, ray_org_elev=0.01,
                        rel_err=None, max_level=10, pyramid=None,
                        tilt_ramp=None, mask=None):
    """:func:`horizon_sweep_fused` in plain torch on any device, forward
    only: the CPU path, and the reference kernel K1 is held against on the
    card."""
    return _run(_ratio_plain, z_outer, (elev_ang_low_lim, elev_ang_up_lim),
                dict(dx=dx, dy=dy, offset=offset, inner_shape=inner_shape,
                     azim_num=azim_num, dist_search=dist_search,
                     hori_acc=hori_acc, ray_org_elev=ray_org_elev,
                     rel_err=rel_err, max_level=max_level, pyramid=pyramid,
                     tilt_ramp=tilt_ramp, mask=mask))
