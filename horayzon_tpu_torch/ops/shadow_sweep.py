# Copyright (c) 2026
# MIT License
"""Fused planar shadow sweep: the counterpart of
``horayzon_tpu.ops.pallas_sweep.shadow_metric_pallas`` and of its
differentiable form ``shadow_metric_pallas_diff``.

For every inner cell and each sun of a track, :func:`shadow_metric_fused`
returns the occlusion metric: the maximum along the cell's ray toward the
sun of the clearance ``h(s) - (z_org + s * m)``, where ``m`` is the cell's
ray slope; a positive metric means the terrain hides the sun.  The rays run
to the diagonal of the outer grid (tfar is infinite in the reference,
``shadow_comp.cpp:454-467``).  Behind it sits one sweep with two
implementations of identical arithmetic:

* kernel K2, the shadow mode of ``csrc/horizon_sweep.cu`` (CUDA C++ for
  ``sm_90a``, one thread per (cell, sun)), run for a CUDA tensor;
* :func:`_metric_plain`, the loop skeleton that K1's plain version uses
  (:func:`horayzon_tpu_torch.ops.fused_sweep.sweep_plain`) with the shadow
  mode's per-cell set-up and updates, run for a CPU tensor and used on the
  card as the kernel's reference.

Both follow ``pallas_sweep.py::_kernel(mode="shadow")``: the ray slope from
the sun table (:352-380), the clearance of a point sample (:487-489) and
the vertex value of a concave parabola segment (:426-437), rounded as the
reference rounds them.  K2 also takes the reference's shadow-mode skips,
decided per warp from the pooled companions of the levels
(``fused_sweep.skip_inputs``, as K1's): with ``exact_metric=True`` the
value-exact ones, which move no value, so K2 returns the exact metric; with
``exact_metric=False`` also the sign-exact arm, for callers that only
threshold the metric at 0 (``Terrain``): its metric keeps the exact one's
sign and never exceeds it.  The plain version takes no skips and returns
the exact metric; :func:`metric_model` runs it with the skips the kernel
takes, for the tests and the smoke run.

The mask variant, K2-mask (``shadow_metric_pallas(mask=...)``, which
drops whole tiles through ``tile_schedule(..., mask)``,
``pallas_sweep.py:2730-2791``): the same launch over the compacted list of
the kernel's 32 x 8 blocks that hold a nonzero mask cell
(``fused_sweep.live_blocks``, K1-mask's nullable ``blocks``), with no
per-cell mask: shadow mode has no mask-aware init, so every cell of a
launched block computes what the dense launch computes, its warps taking
the same skips, and the wrapper pre-fills the blocks it does not launch
with the reference's ``-3e38``.  The plain version sweeps every cell and
writes the same fill there.

The gradient path (:class:`_ShadowSweepFn`, taken when ``z_outer`` or
``z_org_r`` requires grad) runs the argmax variant, K2-argmax on the card
(winner ids and the vertex denominator D = s0 + t*, with the value-exact
skips), and the shadow winner-replay backward, kernel K4 of
``csrc/horizon_replay_bwd.cu`` (``replay.backward_replay`` in the shadow
mode); on the CPU their plain versions.
"""

import math

import numpy as np
import torch

from horayzon_tpu_torch.ops import fused_sweep as _fused
from horayzon_tpu_torch.ops import mip as _mip
from horayzon_tpu_torch.ops import replay as _replay
from horayzon_tpu_torch.ops.replay import lattice_xy, sqrt_rn
from horayzon_tpu_torch.utils import profiling as _profiling

#: Launches of kernel K2 made by this process (incremented only where the
#: wrapper launches it).
KERNEL_LAUNCHES = 0
#: Launches of K2's argmax variant (the forward of the gradient path).
ARGMAX_KERNEL_LAUNCHES = 0
#: Launches of K2 over the live blocks of a mask (K2-mask), counted
#: besides :data:`KERNEL_LAUNCHES`.
MASK_KERNEL_LAUNCHES = 0
#: Launches of K2 or K2-argmax by a shard of a sharded metric (a plan of
#: ``fused_sweep.shard_plan``), counted besides the entry's own count.
SHARD_KERNEL_LAUNCHES = 0

_F32 = np.float32
#: float32(-1e-12): the concavity threshold of the vertex candidate
_NEG_TINY = float(_F32(-1.0e-12))
#: What a cell of a block that K2-mask does not launch holds (the
#: reference's all-masked result, ``pallas_sweep.py:39, 2766-2767``)
_NEG_INIT = float(_F32(-3.0e38))


def shadow_sun_table(sun_positions, center, dx, dy):
    """Host-side per-sun table (copy of
    ``pallas_sweep.shadow_sun_table``, ``pallas_sweep.py:2706-2727``).

    Rows: sun_x, sun_y, sun_z, kx_u, ky_u, ui, uj, 0: the unit horizontal
    direction toward the sun from the domain centre ``center`` and the
    marching shifts in grid cells per metre, formed in float64 and rounded
    to float32 once.  Returns (table (T, 8) float32, near_vertical (T,)
    bool)."""
    sp = np.atleast_2d(np.asarray(sun_positions, dtype=np.float64))
    kx = sp[:, 0] - center[0]
    ky = sp[:, 1] - center[1]
    k_norm = np.hypot(kx, ky)
    near_vertical = k_norm < 1.0e-6
    kx_u = np.where(near_vertical, 1.0, kx / np.maximum(k_norm, 1e-6))
    ky_u = np.where(near_vertical, 0.0, ky / np.maximum(k_norm, 1e-6))
    table = np.zeros((sp.shape[0], 8), dtype=np.float32)
    table[:, 0:3] = sp
    table[:, 3] = kx_u
    table[:, 4] = ky_u
    table[:, 5] = ky_u / dy   # ui: row cells per metre
    table[:, 6] = kx_u / dx   # uj
    return table, near_vertical


def plan_shadow(outer_shape, *, inner_shape, offset, dx, dy, hori_acc=0.25,
                rel_err=None):
    """The sweep plan of the shadow metric: :func:`fused_sweep.plan_sweep`
    with the search distance set to the diagonal of the outer grid, as
    ``horayzon_tpu/shadow.py:359-365`` builds its schedule."""
    h, w = outer_shape
    diag = math.hypot(w * abs(dx), h * abs(dy))
    return _fused.plan_sweep(outer_shape, inner_shape=inner_shape,
                             offset=offset, dist_search=diag, dx=dx, dy=dy,
                             hori_acc=hori_acc, rel_err=rel_err)


def ray_slopes(z_org, table, plan, grid_origin):
    """``slope(t)``: the (in0, in1) float32 ray slopes ``m`` of the cells
    toward sun ``t`` of ``table``, as K2 forms them
    (``pallas_sweep.py:352-374``)."""
    xr, yr = lattice_xy(plan, grid_origin, z_org.device)

    def slope(t):
        sun_x, sun_y, sun_z, kx_u, ky_u = table[t, :5]
        sxr = float(sun_x) - xr                  # (in1,)
        syr = float(sun_y) - yr                  # (in0,)
        szr = float(sun_z) - z_org
        mag = sqrt_rn((sxr * sxr)[None, :] + (syr * syr)[:, None]
                       + szr * szr)
        adv = ((sxr * float(kx_u))[None, :]
               + (syr * float(ky_u))[:, None]) / mag
        return (szr / mag) / torch.clamp_min(adv, float(_F32(1.0e-4)))

    return slope


def _shadow_rows(z_org, table, plan, grid_origin):
    """``row_mode`` of :func:`fused_sweep.sweep_plain` for K2: per sun the
    shifts of the table's columns 5-6, the ray-slope field ``m`` and the
    clearance candidates (``pallas_sweep.py:352-380, 426-453, 487-489``)."""
    k = plan["consts"]
    slope = ray_slopes(z_org, table, plan, grid_origin)
    # (lo2, hi2) of each window: d2 step, d1 pair, d1 single
    wins = ((k["lo2_0"], k["hi2_step"]), (k["lo2_0"], k["hi2_two_step"]),
            (k["lo2_step"], k["hi2_two_step"]))

    def row(t):
        sh_i, sh_j = table[t, 5:7]
        m = slope(t)

        def point(he, s):
            return (he - z_org) - m * float(s)

        def quad(a_c, b_c, h0, s_start, win):
            lo2, hi2 = wins[win]
            concave = a_c < _NEG_TINY
            a_s = torch.where(concave, a_c, _NEG_TINY)
            d = b_c - m
            lo2a = a_c * float(lo2)
            hi2a = a_c * float(hi2)
            valid = concave & ((d + lo2a) * (d + hi2a) < 0.0)
            cand = ((h0 - z_org) - m * float(s_start)) \
                - ((d * 0.25) * d) / a_s
            # the argmax pair of D = s_start - d / (2 a)
            return valid, cand, (2.0 * a_s) * float(s_start) - d, 2.0 * a_s

        return sh_i, sh_j, point, quad

    return row


def live_cells(mask):
    """(in0, in1) bool: the cells of the kernel's 32 x 8 blocks that hold a
    nonzero cell of ``mask`` (the cells K2-mask computes)."""
    in0, in1 = mask.shape
    return _fused.live_grid(mask).repeat_interleave(
        _fused.BLOCK_ROWS, 0).repeat_interleave(_fused.BLOCK_COLS,
                                                1)[:in0, :in1]


def _metric_plain(z_org, z_inner, levels, table, plan, outer_shape,
                  grid_origin, emit_argmax=False, mask=None):
    """The exact metric (T, in0, in1) in plain torch (K2's plain version);
    with ``emit_argmax`` ``(metric, ids, aux)`` as K2-argmax returns them
    (ids in the horizon layout, aux the D of a parabola winner).  ``mask``
    (K2-mask's plain version): cells outside the live blocks of
    :func:`live_cells` hold ``-3e38``."""
    res = _fused.sweep_plain(z_inner, levels, plan, outer_shape,
                             table.shape[0],
                             _shadow_rows(z_org, table, plan, grid_origin),
                             emit_argmax)
    if mask is None:
        return res
    return torch.where(live_cells(mask), res, _NEG_INIT)


def _check_pooled(pooled, levels):
    """``pooled`` as ``fused_sweep.skip_inputs`` builds it for ``levels``."""
    if len(pooled) != 2 or len(pooled[0]) != len(levels):
        raise ValueError("pooled must be (the pooled levels, the level-0 "
                         "floor) of skip_inputs, one pooled level per level")
    for t, lv in zip((*pooled[0], pooled[1]), (*levels, levels[0])):
        want = (-(-lv.shape[0] // 8), -(-lv.shape[1] // 8))
        if (not isinstance(t, torch.Tensor) or t.device != lv.device
                or t.dtype != torch.float32 or not t.is_contiguous()
                or tuple(t.shape) != want):
            raise ValueError(f"a pooled companion is not a contiguous "
                             f"float32 tensor of shape {want} on "
                             f"{lv.device}")


def _metric_cuda(z_org, z_inner, levels, table, plan, outer_shape,
                 grid_origin, emit_argmax=False, exact_metric=True,
                 pooled=None, counters=None, mask=None):
    """The metric (T, in0, in1) from kernel K2 on ``z_org``'s card;
    ``emit_argmax``: ``(metric, ids, aux)`` from K2-argmax, as
    :func:`_metric_plain` returns them.  The kernel takes the value-exact
    skips and, with ``exact_metric=False``, the sign-exact arm.
    ``pooled``: ``fused_sweep.skip_inputs`` of ``levels`` (built here
    when None).  ``counters``: a (4,) int64 tensor on the card to which the launch adds
    the (cell, sun) samples it took and skipped in the d1 pairs and the mip
    phases (``fused_sweep.COUNTER_FIELDS``); when None and the profiler
    records, ``utils.profiling``'s counters of "k2".  ``mask`` (in0, in1) uint8
    (K2-mask, no argmax): the output is first filled with ``-3e38`` and
    only the live blocks (``fused_sweep.live_blocks``) are launched; with
    no live block nothing is."""
    global KERNEL_LAUNCHES, ARGMAX_KERNEL_LAUNCHES, MASK_KERNEL_LAUNCHES
    global SHARD_KERNEL_LAUNCHES
    if emit_argmax and not exact_metric:
        raise ValueError("emit_argmax requires exact_metric=True")
    if emit_argmax and mask is not None:
        raise ValueError("the argmax variant takes no mask")
    dev = z_org.device
    in0, in1 = plan["inner_shape"]
    shape = (table.shape[0], in0, in1)
    if mask is None:
        out = torch.empty(shape, dtype=torch.float32, device=dev)
    else:
        out = torch.full(shape, _NEG_INIT, dtype=torch.float32, device=dev)
    prm = _fused.kernel_params(z_org, z_inner, levels, plan, outer_shape,
                               table.shape[0], out)
    if pooled is None:
        pooled = _fused.skip_inputs(levels, plan)
    _check_pooled(pooled, levels)
    table_t = _replay._table_to(table, dev)
    prm.keep += [table_t, pooled[1], *pooled[0]]
    prm.sun = table_t.data_ptr()
    prm.pool_min0 = pooled[1].data_ptr()
    for lvl, t in enumerate(pooled[0]):
        prm.pool[lvl], prm.pool_w[lvl] = t.data_ptr(), t.shape[1]
    prm.sign_exact = 0 if exact_metric else 1
    prm.x0, prm.y0 = _F32(grid_origin[0]), _F32(grid_origin[1])
    if counters is None:
        counters = _profiling.launch_counters("k2", dev)
    if counters is not None:
        _fused.check_counters(counters, dev)
        prm.counters = counters.data_ptr()
    if emit_argmax:
        ids = torch.empty(shape, dtype=torch.int32, device=dev)
        aux = torch.empty(shape, dtype=torch.float32, device=dev)
        prm.ids, prm.aux = ids.data_ptr(), aux.data_ptr()
    if mask is not None:
        # the block list only: prm.mask stays null, so a launched block
        # sweeps every cell as the dense launch does
        _fused._check_inner(mask, "mask", torch.uint8, plan, dev)
        blocks = _fused.live_blocks(mask)
        if blocks.shape[0] == 0:
            return out
        prm.keep.append(blocks)
        prm.blocks, prm.n_blocks = blocks.data_ptr(), blocks.shape[0]
    lib = _fused.kernel_lib()
    _fused.launch(lib, lib.shadow_sweep_argmax_launch if emit_argmax
                  else lib.shadow_sweep_launch, prm, dev)
    SHARD_KERNEL_LAUNCHES += "shard" in plan
    if emit_argmax:
        ARGMAX_KERNEL_LAUNCHES += 1
        return out, ids, aux
    KERNEL_LAUNCHES += 1
    MASK_KERNEL_LAUNCHES += mask is not None
    return out


def metric_model(z_org, z_inner, levels, table, plan, outer_shape,
                 grid_origin, emit_argmax=False, exact_metric=True,
                 pooled=None):
    """K2 (``exact_metric=False``: its sign-exact arm too) in plain torch
    on the inputs of :func:`_metric_cuda`: the plain sweep run in the
    kernel's chunks, skipping where the plain model of the kernel's
    per-warp test (``fused_sweep.warp_skip_plain``) skips.  Returns
    ``(result, counts)``: the result as :func:`_metric_cuda` returns it,
    and a dict of the samples of (cell, sun) taken and skipped, under
    ``fused_sweep.COUNTER_FIELDS`` (what the kernel's counters hold) and
    ``masked_d1_taken`` / ``masked_d1_skipped`` (the masked pairs' share
    of the d1 counts).  For the tests and the smoke run; the library never
    calls it."""
    if emit_argmax and not exact_metric:
        raise ValueError("emit_argmax requires exact_metric=True")
    if pooled is None:
        pooled = _fused.skip_inputs(levels, plan)
    slope = ray_slopes(z_org, table, plan, grid_origin)
    names = _fused.COUNTER_FIELDS + ("masked_d1_taken", "masked_d1_skipped")
    counts = dict.fromkeys(names, 0)
    state = {}

    def hook(ev):
        if "cand_max" in ev:
            return None
        if state.get("row") != ev["row"]:
            state.update(row=ev["row"], m=slope(ev["row"]))
        _, skip = _fused.warp_skip_plain(ev, pooled[0], pooled[1], plan,
                                         z_org, m=state["m"],
                                         sign_exact=not exact_metric)
        n, kind = ev["n"], ev["kind"]
        took, skipped = n * int((~skip).sum()), n * int(skip.sum())
        if kind == "d1":
            counts["d1_taken"] += took
            counts["d1_skipped"] += skipped
            if ev["masked"]:
                counts["masked_d1_taken"] += took
                counts["masked_d1_skipped"] += skipped
        elif kind == "mip_phase":
            # a phase that runs is counted by its chunks, unless it is one
            state["phase_skip"] = skip
            counts["mip_skipped"] += skipped
            if n <= _fused.MIP_CHUNK:
                counts["mip_taken"] += took
        else:
            live = ~state["phase_skip"]
            counts["mip_taken"] += n * int((live & ~skip).sum())
            counts["mip_skipped"] += n * int((live & skip).sum())
        return skip

    res = _fused.sweep_plain(z_inner, levels, plan, outer_shape,
                             table.shape[0],
                             _shadow_rows(z_org, table, plan, grid_origin),
                             emit_argmax, chunk_hook=hook)
    return res, counts


def metric_args(z_outer, z_org_r, z_inner_r, sun_table, *, offset,
                inner_shape, dx, dy, hori_acc=0.25, rel_err=None,
                pyramid=None, pooled=None):
    """The inputs ``(z_org, z_inner, levels, table, plan, outer_shape)`` of
    :func:`_metric_cuda` / :func:`_metric_plain` from the arguments of
    :func:`shadow_metric_fused`, validated as it validates them (``pooled``
    only with the ``pyramid`` it was built from; a mask by
    :func:`mask_arg`)."""
    z = torch.as_tensor(z_outer)
    if z.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no shadow sweep for device {z.device}")
    z = z.detach().to(torch.float32).contiguous()
    _fused.check_block(z, offset, inner_shape)
    in0, in1 = inner_shape
    fields = []
    for name, f in (("z_org_r", z_org_r), ("z_inner_r", z_inner_r)):
        f = torch.as_tensor(f).detach().to(device=z.device,
                                           dtype=torch.float32).contiguous()
        if tuple(f.shape) != (in0, in1):
            raise ValueError(f"{name} has shape {tuple(f.shape)}, expected "
                             f"the inner shape {(in0, in1)}")
        fields.append(f)
    table = np.asarray(sun_table, dtype=np.float32)
    if table.ndim != 2 or table.shape[1] != 8 or table.shape[0] < 1:
        raise ValueError(f"sun_table must be (T, 8) with T >= 1, got shape "
                         f"{table.shape}")
    plan = plan_shadow(tuple(z.shape), inner_shape=(in0, in1),
                       offset=tuple(offset), dx=dx, dy=dy,
                       hori_acc=hori_acc, rel_err=rel_err)
    if pyramid is None:
        if pooled is not None:
            raise ValueError("pooled needs the pyramid it was built from")
        levels = _mip.padded_levels(z, plan["pads"])
    else:
        levels = _fused.check_pyramid(pyramid, z, plan["pads"])
    if pooled is not None:
        _check_pooled(pooled, levels)
    return (fields[0], fields[1], levels, table, plan, tuple(z.shape))


def mask_arg(mask, inner_shape, device):
    """A K2-mask ``mask``: (in0, in1) uint8 or bool, as a contiguous uint8
    tensor on ``device``."""
    dtype = getattr(mask, "dtype", None)
    if dtype not in (torch.uint8, torch.bool, np.uint8, np.bool_):
        raise TypeError(f"mask must be uint8 or bool, got {dtype}")
    mask = torch.as_tensor(mask).to(device=device, dtype=torch.uint8)
    if tuple(mask.shape) != tuple(inner_shape):
        raise ValueError(f"mask has shape {tuple(mask.shape)}, expected the "
                         f"inner shape {tuple(inner_shape)}")
    return mask.contiguous()


class _ShadowSweepFn(torch.autograd.Function):
    """The shadow metric with its winner-replay backward (``_shadow_diff``
    with ``_shadow_diff_fwd`` / ``_shadow_diff_bwd``,
    ``pallas_sweep.py:2591-2626``).  Forward: K2-argmax (CUDA) or the plain
    argmax sweep (CPU), saving ids and D.  Backward: K4 (CUDA) or the plain
    replay (CPU); the level cotangents go to ``z_outer`` through the
    pyramid's VJP, the ray-origin cotangent to ``z_org_r`` as it is.
    ``z_inner_r`` and the sun table get no gradient, as the reference
    returns zeros for them (``pallas_sweep.py:2525-2531, 2622-2623``)."""

    @staticmethod
    def forward(ctx, z_outer, z_org_r, z_inner_r, kw):
        args = metric_args(z_outer, z_org_r, z_inner_r, **kw["metric"])
        if args[0].is_cuda:
            met, ids, aux = _metric_cuda(
                *args, grid_origin=kw["grid_origin"], emit_argmax=True,
                pooled=kw["metric"]["pooled"])
        else:
            met, ids, aux = _metric_plain(
                *args, grid_origin=kw["grid_origin"], emit_argmax=True)
        z_org, _, _, table, plan, _ = args
        ctx.save_for_backward(z_outer, z_org, ids, aux)
        ctx.table, ctx.plan, ctx.grid_origin = table, plan, kw["grid_origin"]
        return met

    @staticmethod
    def backward(ctx, g):
        z, z_org, ids, aux = ctx.saved_tensors
        level_cots, dz_org = _replay.backward_replay(
            tuple(z.shape), g.to(torch.float32).contiguous(), ids, aux,
            ctx.plan, shadow=(ctx.table, z_org, ctx.grid_origin))
        dz = None
        if ctx.needs_input_grad[0]:
            dz = _mip.padded_levels_vjp(z, ctx.plan["pads"], level_cots)
        return dz, (dz_org if ctx.needs_input_grad[1] else None), None, None


def shadow_metric_fused(z_outer, z_org_r, z_inner_r, sun_table, *, offset,
                        inner_shape, dx, dy, grid_origin, hori_acc=0.25,
                        rel_err=None, pyramid=None, pooled=None,
                        exact_metric=True, mask=None):
    """Batched shadow occlusion metric via the fused sweep.

    The contract of ``horayzon_tpu.ops.pallas_sweep.shadow_metric_pallas``:
    ``z_outer`` the (H, W) outer heightfield, ``z_org_r`` /
    ``z_inner_r`` the (in0, in1) ray-origin and terrain heights of the
    inner block at ``offset``, ``sun_table`` the (T, 8) table of
    :func:`shadow_sun_table`, ``grid_origin`` the (x, y) of outer cell
    (0, 0); ``dx``, ``dy`` signed spacings [metre].  The rays run to the
    outer grid's diagonal (:func:`plan_shadow`).  There is no tile: the
    inner block is swept as it is.

    A CUDA ``z_outer`` runs kernel K2 (built with nvcc on first use; a
    failed build or launch raises) with the value-exact skips;
    ``exact_metric=False`` adds their sign-exact arm, for callers that only
    threshold the metric at 0: the metric then has the exact one's sign
    and is at most the exact one, but not its value.  A CPU ``z_outer``
    runs the plain torch version, which returns the exact metric either
    way.  ``pyramid``: optional padded levels in the layout of
    :func:`horayzon_tpu_torch.ops.mip.padded_levels` on ``z_outer``'s
    device, and ``pooled`` their ``fused_sweep.skip_inputs`` (a
    ``Terrain`` builds both once).

    Differentiable w.r.t. ``z_outer`` and ``z_org_r``: when either requires
    grad (and grad mode is on) the metric runs as :class:`_ShadowSweepFn`
    (K2-argmax and K4 on the card, their plain versions on the CPU); the
    gradients are those ``jax.grad`` takes through
    ``shadow_metric_pallas_diff``.  That path needs ``exact_metric=True``
    (the sign-exact arm may drop the winner) and takes no mask, as the
    reference's: otherwise it raises ``ValueError``.  When ``z_outer``
    requires grad the pyramid is built from it, and no ``pyramid`` may be
    passed.

    ``mask``: optional (in0, in1) uint8 or bool, nonzero where a cell is
    wanted (K2-mask): the 32 x 8 blocks of the kernel that hold no such
    cell are not swept and hold ``-3e38``, as the reference's dropped
    tiles do at its tile; every other cell, masked or not, holds the
    value of the unmasked call.  A mask with no nonzero cell returns only
    the fill.

    Returns (T, in0, in1) float32 on ``z_outer``'s device; > 0 means the
    cell is terrain-occluded."""
    kw = dict(sun_table=sun_table, offset=offset, inner_shape=inner_shape,
              dx=dx, dy=dy, hori_acc=hori_acc, rel_err=rel_err,
              pyramid=pyramid, pooled=pooled)
    diff = [isinstance(t, torch.Tensor) and t.requires_grad
            for t in (z_outer, z_org_r)]
    if any(diff) and torch.is_grad_enabled():
        if not exact_metric:
            raise ValueError("emit_argmax requires exact_metric=True")
        if mask is not None:
            raise ValueError("the gradient path takes no mask")
        if diff[0] and pyramid is not None:
            raise NotImplementedError("the gradient path builds its pyramid "
                                      "from z_outer; pass no pyramid")
        z = torch.as_tensor(z_outer).to(torch.float32).contiguous()
        z_org = torch.as_tensor(z_org_r).to(device=z.device,
                                            dtype=torch.float32).contiguous()
        return _ShadowSweepFn.apply(z, z_org, z_inner_r,
                                    dict(metric=kw, grid_origin=grid_origin))
    with _profiling.span("hzt.shadow.args"):
        args = metric_args(z_outer, z_org_r, z_inner_r, **kw)
        if mask is not None:
            mask = mask_arg(mask, args[4]["inner_shape"], args[0].device)
    with _profiling.span("hzt.shadow.k2"):
        if args[0].is_cuda:
            return _metric_cuda(*args, grid_origin=grid_origin,
                                exact_metric=exact_metric, pooled=pooled,
                                mask=mask)
        return _metric_plain(*args, grid_origin=grid_origin, mask=mask)


def shadow_metric_plain(z_outer, z_org_r, z_inner_r, sun_table, *, offset,
                        inner_shape, dx, dy, grid_origin, hori_acc=0.25,
                        rel_err=None, pyramid=None, mask=None):
    """:func:`shadow_metric_fused` in plain torch on any device: the CPU
    path, and the reference kernel K2 (and with ``mask`` K2-mask) is held
    against on the card."""
    args = metric_args(z_outer, z_org_r, z_inner_r, sun_table,
                       offset=offset, inner_shape=inner_shape, dx=dx, dy=dy,
                       hori_acc=hori_acc, rel_err=rel_err, pyramid=pyramid)
    if mask is not None:
        mask = mask_arg(mask, args[4]["inner_shape"], args[0].device)
    return _metric_plain(*args, grid_origin=grid_origin, mask=mask)
