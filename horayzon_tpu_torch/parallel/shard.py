# Copyright (c) 2026
# MIT License
"""Sharded horizon and shadow sweeps over a (tile, azim) mesh of slots
(counterpart of :mod:`horayzon_tpu.parallel.shard`).

The reference runs each engine under ``shard_map``: inner rows sharded
along the mesh's ``tile`` axis, azimuths along ``azim``, the heightfield
replicated (every shard's rays march ``dist_search`` past its rows), the
outputs laid out by rows and azimuths and the heightfield's cotangent
psummed.  Here each slot of :class:`.mesh.Mesh` runs the port's kernel on
its shard in turn on its device, with the shard's global offsets
(``fused_sweep.shard_plan``): K1 / K1-argmax (with the tilt ramp) for the
horizon, K2 / K2-argmax for the shadow metric, and K3 / K4's shard variant
(``replay.ShardReplay``) for the gradients; a CPU slot runs their plain
versions.  The shards' outputs are assembled to the whole run's rows and
azimuths on every process (``distributed.assemble_rows``).

Every shard computes exactly what the single launch computes for its
cells: the dense-step split is the whole run's, the trig rows and cell
coordinates are global, and the kernels' skips are value-exact.  So the
assembled forward, raw values, winner ids and D, is bit-equal to the
single launch on every mesh.  The gradients are too: the shards agree one
fixed-point grid first (the whole run's ``replay.fixed_point_levels`` and
the maximum over the shards of each level's largest coefficient), each
scatters its winners' terms into int64 words of its own target boxes, the
words are summed exactly into the whole run's boxes (and over processes,
``distributed.all_reduce``) and converted once; the z_org cotangent of a
tile is summed over its azimuth shards in order, each continuing the
previous one's running sum.

With ``HZT_GRAD_RECOMPUTE=1`` (read when the forward runs) the fused
horizon sweep's gradient is the reference's sharded recompute VJP
instead: K1's non-argmax ``shard_off`` variant per slot forward, nothing
recorded, and backward the VJP of :func:`psh_xla_equiv` (the plain-torch
XLA sweep per slot, ``_psh_xla_equiv``), recomputed in azimuth chunks per
slot; the shards' cotangents sum in slot order.  It equals the
single-device recompute gradient up to the order of float sums (a
shard's heights are ``z_org - ray_org_elev``, rounded as the reference
rounds them), not bit for bit.  The multires entry keeps the replay, as
the reference's ``_mr_hz_sharded`` does.
"""

import math

import numpy as np
import torch

from horayzon_tpu_torch.ops import fused_sweep as _fused
from horayzon_tpu_torch.ops import mip as _mip
from horayzon_tpu_torch.ops import multires as _mr
from horayzon_tpu_torch.ops import replay as _replay
from horayzon_tpu_torch.ops import shadow_sweep as _ss
from horayzon_tpu_torch.ops import sweep as _sweep
from horayzon_tpu_torch.parallel import distributed as _dist
from horayzon_tpu_torch.parallel.mesh import AXIS_AZIM, AXIS_TILE


def _split(mesh, inner_shape, a_num=None):
    """Rows per tile and azimuths per azim shard, with the reference's
    divisibility checks (``shard.py:67-73``)."""
    n_tile, n_azim = mesh.shape[AXIS_TILE], mesh.shape[AXIS_AZIM]
    in0 = inner_shape[0]
    if in0 % n_tile != 0:
        raise ValueError(f"inner rows {in0} not divisible by tile axis "
                         f"{n_tile}")
    if a_num is None:
        return in0 // n_tile, None
    if a_num % n_azim != 0:
        raise ValueError(f"azimuth count {a_num} not divisible by azim "
                         f"axis {n_azim}")
    return in0 // n_tile, a_num // n_azim


def _assemble(mesh, pieces, row_dim, az_dim=None):
    """The whole run's tensor from ``pieces[(t, a)]``, this process's slots'
    outputs: azimuth shards concatenated along ``az_dim`` (or the first
    azim slot's alone when None), tiles along ``row_dim``, then the
    processes' blocks; on :attr:`Mesh.device`."""
    dev = mesh.device
    n_azim = mesh.shape[AXIS_AZIM]
    tiles = []
    for t in mesh.local_tiles():
        if az_dim is None:
            tiles.append(pieces[(t, 0)].to(dev))
        else:
            tiles.append(torch.cat([pieces[(t, a)].to(dev)
                                    for a in range(n_azim)], dim=az_dim))
    return _dist.assemble_rows(torch.cat(tiles, dim=row_dim), mesh, row_dim)


class _OnDevice:
    """Copies of tensors on the slots' devices, made once per device (or
    per key)."""

    def __init__(self):
        self._cache = {}

    def get(self, key, make):
        if key not in self._cache:
            self._cache[key] = make()
        return self._cache[key]


def _rows(t, r0, rows, dev):
    return t[r0:r0 + rows].to(dev).contiguous()


# ---------------------------------------------------------------------------
# Sharded replay (shared by the horizon and the shadow gradients)
# ---------------------------------------------------------------------------

def _sharded_replay(mesh, z_shape, plan, graw, records, table, rows, az_loc,
                    shadow=None):
    """``(level_cots, zcot)`` of the sharded winner replay of an argmax
    run, bit-equal to the single replay of the whole record.  ``graw``:
    the whole run's (A, in0, in1) cotangent; ``records``: per local slot
    ``(t, a, ids, aux)``, its record of rows ``[t rows, (t + 1) rows)`` and
    azimuths (suns) ``[a az_loc, (a + 1) az_loc)``; ``table``: the whole
    run's (A, 2) shift table, or (T, 8) sun table with ``shadow = (z_org,
    grid_origin)`` (z_org the whole run's ray origins)."""
    fixed = _replay.fixed_point_levels(plan, table.shape[0],
                                       len(plan["pads"]))
    slots = []
    for t, a, ids, aux in records:
        r0, sl = t * rows, slice(a * az_loc, (a + 1) * az_loc)
        if shadow is None:
            mode = dict(shifts=table[sl])
        else:
            mode = dict(shadow=(table, _rows(shadow[0], r0, rows, ids.device),
                                shadow[1]))
        slots.append((t, _replay.ShardReplay(
            z_shape, graw[sl, r0:r0 + rows].to(ids.device).contiguous(), ids,
            aux, _fused.shard_plan(plan, r0, rows), fixed, **mode)))
    rows_tab = table if shadow is None else table[:, 5:7]
    boxes = _replay._target_boxes(z_shape, plan,
                                  np.ascontiguousarray(rows_tab, np.float32))
    dev = mesh.device
    # 1. the grid: each level's largest |coefficient| over every shard (the
    # bits of a non-negative float order as the float; NaN above inf)
    maxima = torch.zeros(len(plan["pads"]), dtype=torch.float32, device=dev)
    for _, rep in slots:
        maxima = torch.maximum(maxima, rep.maxima().to(dev))
    _dist.all_reduce(maxima.view(torch.int32), mesh, "max")
    # 2. every shard's words on that grid, summed exactly into the run's
    # boxes and over the processes; 3. converted once
    _, acc_off = _replay.box_layout(boxes, fixed)
    words = torch.zeros(acc_off[-1], dtype=torch.int64, device=dev)
    for _, rep in slots:
        _replay.add_words(words, boxes, rep.words(maxima), rep.boxes, fixed)
    _dist.all_reduce(words, mesh, "sum")
    cots = _replay.convert(z_shape, plan, words, boxes, fixed, maxima,
                           shadow=shadow is not None)
    # 4. z_org: each tile's azimuth shards in order, each continuing the
    # running sum of the ones before
    zcots = {}
    for t, rep in slots:
        zcots[(t, 0)] = rep.zorg(zcots.get((t, 0)))
    return cots, _assemble(mesh, zcots, row_dim=0)


# ---------------------------------------------------------------------------
# The fused horizon sweep (K1 / K1-argmax / K1-tilt and K3)
# ---------------------------------------------------------------------------

def _windows(plan, trig, mesh, rows, levels, n_fine):
    """Per tile, the padded row at which its window of each level starts
    and ends: levels below ``n_fine`` are cut to the rows a shard of the
    tile reads or bounds over every azimuth (``fused_sweep.level_reach``),
    the start rounded down to a multiple of 8; the others are whole."""
    out = {}
    for t in mesh.local_tiles():
        reach = _fused.level_reach(_fused.shard_plan(plan, t * rows, rows),
                                   trig)
        win = []
        for lvl, (lo, hi) in enumerate(reach):
            h = levels[lvl].shape[0]
            if lvl < n_fine and hi > lo:
                win.append((max(0, lo) // 8 * 8, min(hi, h)))
            else:
                win.append((0, h))
        out[t] = tuple(win)
    return out


class _HzForward:
    """One sharded K1 run: the whole run's inputs (``fused_sweep.
    sweep_args``) cut per slot, with each tile's level windows
    (:func:`_windows`) when ``n_fine`` is given."""

    def __init__(self, mesh, args, n_fine=None):
        (self.z_org, self.z_inner, self.levels, self.trig, self.plan,
         self.outer_shape, self.ramp, _) = args
        self.mesh = mesh
        self.rows, self.az_loc = _split(mesh, self.plan["inner_shape"],
                                        self.trig.shape[0])
        self.windows = None
        if n_fine is not None:
            self.windows = _windows(self.plan, self.trig, mesh, self.rows,
                                    self.levels, n_fine)
        self.pooled = None
        if any(d.type == "cuda" for _, _, d in mesh.local_slots()):
            self.pooled = _fused.skip_inputs(self.levels, self.plan)
        self.cache = _OnDevice()

    def slot_plan(self, t):
        lr = None
        if self.windows is not None:
            lr = tuple(o for o, _ in self.windows[t])
        return _fused.shard_plan(self.plan, t * self.rows, self.rows,
                                 lvl_row0=lr)

    def slot_levels(self, t, dev):
        """The levels a slot of tile ``t`` holds on ``dev`` and their pooled
        companions: windows (separate allocations) where cut, else the
        whole levels."""
        if self.windows is None:
            key = (None, dev)
            win = [(0, lv.shape[0]) for lv in self.levels]
        else:
            key = (t, dev)
            win = self.windows[t]

        def cut(x, o, e):
            # a window is a copy of its rows; a whole level is shared
            whole = o == 0 and e == x.shape[0]
            return x.to(dev) if whole else x[o:e].to(dev, copy=True)

        def make():
            lv = [cut(x, o, e) for x, (o, e) in zip(self.levels, win)]
            if self.pooled is None or dev.type != "cuda":
                return lv, None
            pool, pmin = self.pooled
            pl = [cut(p, o // 8, -(-e // 8)) for p, (o, e) in zip(pool, win)]
            o, e = win[0]
            return lv, (pl, cut(pmin, o // 8, -(-e // 8)))
        return self.cache.get(key, make)

    def run(self, emit_argmax):
        """``(raw, records)``: the assembled (A, in0, in1) raw ratios and per
        local slot ``(t, a, ids, aux)`` (with ``emit_argmax``)."""
        pieces, records = {}, []
        rows, az_loc = self.rows, self.az_loc
        for t, a, dev in self.mesh.local_slots():
            r0, az0 = t * rows, a * az_loc
            plan = self.slot_plan(t)
            levels, pooled = self.slot_levels(t, dev)
            z_org = _rows(self.z_org, r0, rows, dev)
            z_inner = _rows(self.z_inner, r0, rows, dev)
            ramp = None if self.ramp is None else tuple(
                _rows(r, r0, rows, dev) for r in self.ramp)
            trig = self.trig[az0:az0 + az_loc]
            if dev.type == "cuda":
                res = _fused._ratio_cuda(z_org, z_inner, levels, trig, plan,
                                         self.outer_shape, tilt_ramp=ramp,
                                         emit_argmax=emit_argmax,
                                         pooled=pooled)
            else:
                res = _fused._ratio_plain(z_org, z_inner, levels, trig, plan,
                                          self.outer_shape, tilt_ramp=ramp,
                                          emit_argmax=emit_argmax)
            if emit_argmax:
                res, ids, aux = res
                records.append((t, a, ids, aux))
            pieces[(t, a)] = res
        return _assemble(self.mesh, pieces, row_dim=1, az_dim=0), records


# ---------------------------------------------------------------------------
# The sharded recompute VJP (HZT_GRAD_RECOMPUTE=1)
# ---------------------------------------------------------------------------

class _EquivSlots:
    """The per-slot set-up of the sharded recompute (``_psh_xla_equiv``,
    ``horayzon_tpu/parallel/shard.py:158-237``): the schedule marked on the
    whole domain's halo, and per slot its shift tables and trig rows.  The
    reference adds a shard's first row to the whole run's table entries
    (``m_i0``/``e_i0``, ``i0``, and ``base_i``/``r_i`` re-split by
    ``2**level``) and takes the shard's azimuth rows; a table built at the
    shard's global offset for its azimuths holds the same integers, which
    is what :meth:`tables` builds.  A shard's heights are ``z_org -
    ray_org_elev`` (:211), not the inner block itself."""

    def __init__(self, mesh, plan, trig, outer_shape):
        self.plan, self.trig = plan, trig
        self.rows, self.az_loc = _split(mesh, plan["inner_shape"],
                                        trig.shape[0])
        self.schedule = _fused.recompute_schedule(plan, outer_shape)
        self.azim = _fused.equiv_azimuths(trig.shape[0])

    def tables(self, t, a):
        """``(tables, trig)`` of slot ``(t, a)``."""
        sl = slice(a * self.az_loc, (a + 1) * self.az_loc)
        off0, off1 = self.plan["offset"]
        tables = _sweep.horizon_shift_tables(
            self.schedule, self.azim[sl], self.plan["dx"], self.plan["dy"],
            (off0 + t * self.rows, off1))
        return tables, self.trig[sl]


def psh_xla_equiv(mesh, plan, trig, z, tilt_ramp=None, *, ray_org_elev=0.01,
                  lims=(-15.0, 89.98)):
    """The function whose VJP is the sharded recompute gradient
    (``_psh_xla_equiv``, ``horayzon_tpu/parallel/shard.py:158-237``): per
    slot the XLA sweep of its rows and azimuths (:class:`_EquivSlots`),
    its ramp rows' terms, then ``fused_sweep.equiv_angles``; assembled by
    rows and azimuths.  Differentiable by autograd w.r.t. ``z`` (on the
    mesh's first device) and the ramp; the shards' cotangents of the
    replicated ``z`` sum in slot order.  Returns (in0, in1, A) float32
    [radian]."""
    slots = _EquivSlots(mesh, plan, trig, tuple(z.shape))
    (off0, off1), (in0, in1) = plan["offset"], plan["inner_shape"]
    rows = slots.rows
    z_org = z[off0:off0 + in0, off1:off1 + in1] + float(
        np.float32(ray_org_elev))
    levels = _mip.padded_levels(z, plan["pads"])
    cache = _OnDevice()
    pieces = {}
    for t, a, dev in mesh.local_slots():
        tables, trig_s = slots.tables(t, a)
        zo = z_org[t * rows:(t + 1) * rows].to(dev)
        raw = _fused.equiv_raw(
            cache.get(dev, lambda: [lv.to(dev) for lv in levels]), zo,
            zo - float(np.float32(ray_org_elev)), tables, trig_s,
            slots.schedule, tuple(z.shape))
        ramp = None if tilt_ramp is None else tuple(
            r[t * rows:(t + 1) * rows].to(dev) for r in tilt_ramp)
        pieces[(t, a)] = _fused.equiv_angles(raw, trig_s, ramp, lims)
    return _assemble(mesh, pieces, row_dim=0, az_dim=2)


def _sharded_recompute(mesh, z, tilt_ramp, g, plan, trig, ray_org_elev,
                       lims):
    """``(dz, ramp_cots)``: the VJP of :func:`psh_xla_equiv` at ``(z,
    tilt_ramp)`` applied to ``g`` (``_psh_bwd``'s recompute,
    ``horayzon_tpu/parallel/shard.py:262-266``), per slot in azimuth chunks
    (``fused_sweep.equiv_vjp``).  The level cotangents sum over the slots
    in order (and over the processes), then reach ``z`` through the
    pyramid's VJP; a tile's ray-origin and ramp cotangents sum over its
    azimuth slots in order and assemble by rows."""
    slots = _EquivSlots(mesh, plan, trig, tuple(z.shape))
    (off0, off1), (in0, in1) = plan["offset"], plan["inner_shape"]
    rows, dev0 = slots.rows, mesh.device
    zd = z.detach()
    z_org = zd[off0:off0 + in0, off1:off1 + in1] + float(
        np.float32(ray_org_elev))
    levels = _mip.padded_levels(zd, plan["pads"])
    level_cots = [torch.zeros_like(lv) for lv in levels]
    x_cots, ramp_cots = {}, {}
    cache = _OnDevice()
    for t, a, dev in mesh.local_slots():
        r0, sl = t * rows, slice(a * slots.az_loc, (a + 1) * slots.az_loc)
        lv = cache.get(dev, lambda: [x.to(dev) for x in levels])
        tables, trig_s = slots.tables(t, a)
        ramp = None if tilt_ramp is None else tuple(
            _rows(r, r0, rows, dev) for r in tilt_ramp)
        a_chunk = _fused.recompute_chunk(slots.schedule, (rows, in1),
                                         slots.az_loc, lv, dev)
        lc, xc, rc = _fused.equiv_vjp(
            lv, _rows(z_org, r0, rows, dev), ramp,
            g[r0:r0 + rows, :, sl].to(dev), tables, trig_s, slots.schedule,
            tuple(z.shape), ray_org_elev=ray_org_elev, lims=lims,
            from_org=True, a_chunk=a_chunk)
        for acc, c in zip(level_cots, lc):
            if c is not None:
                acc.add_(c.to(dev0))
        prev = x_cots.get((t, 0))
        x_cots[(t, 0)] = xc if prev is None else prev + xc.to(prev.device)
        if rc is not None:
            prev = ramp_cots.get((t, 0))
            ramp_cots[(t, 0)] = rc if prev is None else tuple(
                p + c.to(p.device) for p, c in zip(prev, rc))
    for acc in level_cots:
        _dist.all_reduce(acc, mesh, "sum")
    dz = _replay.z_cotangent(zd, plan, level_cots,
                             _assemble(mesh, x_cots, row_dim=0))
    dr = None
    if tilt_ramp is not None:
        dr = tuple(_assemble(mesh, {k: v[i] for k, v in ramp_cots.items()},
                             row_dim=0) for i in range(2))
    return dz, dr


class _ShardedHorizonFn(torch.autograd.Function):
    """The sharded sweep with its two backwards, chosen as the reference
    chooses them when the forward runs (``fused_sweep._grad_mode``;
    ``_pallas_hz_sharded``, ``horayzon_tpu/parallel/shard.py:239-269``).

    The sharded winner replay (default; ``_psh_fwd`` / ``_psh_bwd_replay``,
    ``shard.py:250-338``, and for multires ``_mr_hz_sharded``, :444-537).
    Forward: K1-argmax per slot; the assembled angles, with the raw ratios
    and the slots' records saved.  Backward: the cotangent chained through
    clip and arctan on the whole run's raw ratios, the ramp's cotangent as
    the single sweep forms it, and :func:`_sharded_replay`.  The level
    cotangents go to ``z`` through the pyramid's VJP, or (``levels`` given)
    to the levels, as ``fused_sweep._HorizonSweepFn`` routes them.

    The sharded recompute (``HZT_GRAD_RECOMPUTE=1``, where the pyramid is
    ``z``'s own; ``_psh_fwd`` / ``_psh_bwd``'s first branch): K1 per slot
    (its ``shard_off`` non-argmax variant), no record kept; backward
    :func:`_sharded_recompute`, no K3."""

    @staticmethod
    def forward(ctx, z, ramp_a, ramp_b, kw, *levels):
        ramp = None if ramp_a is None else (ramp_a, ramp_b)
        args = _fused.sweep_args(z, tilt_ramp=ramp, pyramid=levels or None,
                                 **kw["sweep"])
        fwd = _HzForward(kw["mesh"], args, kw["n_fine"])
        ctx.lims, ctx.has_ramp = kw["lims"], ramp is not None
        ctx.own_pyramid = not levels
        ctx.recompute = (ctx.own_pyramid
                         and _fused._grad_mode() == "recompute")
        if ctx.recompute:
            raw, _ = fwd.run(emit_argmax=False)
            ctx.save_for_backward(z, *(args[6] or ()))
            ctx.mesh, ctx.plan, ctx.trig = fwd.mesh, fwd.plan, fwd.trig
            ctx.ray_org_elev = kw["sweep"]["ray_org_elev"]
            return _fused._angles(raw, *kw["lims"])
        raw, records = fwd.run(emit_argmax=True)
        fwd.cache = fwd.pooled = None      # the replay reads no level
        ctx.save_for_backward(z, raw)
        ctx.fwd, ctx.records = fwd, records
        return _fused._angles(raw.clone(), *kw["lims"])

    @staticmethod
    def backward(ctx, g):
        need_z, need_a, need_b = ctx.needs_input_grad[:3]
        need_lv = ctx.needs_input_grad[4:]
        if ctx.recompute:
            z, *ramp = ctx.saved_tensors
            dz, dr = _sharded_recompute(ctx.mesh, z, tuple(ramp) or None, g,
                                        ctx.plan, ctx.trig,
                                        ctx.ray_org_elev, ctx.lims)
            dra, drb = (None, None) if dr is None else dr
            return (dz if need_z else None, dra if need_a else None,
                    drb if need_b else None, None)
        z, raw = ctx.saved_tensors
        fwd = ctx.fwd
        graw = _fused.raw_cotangent(raw, g, ctx.lims)
        dz = dra = drb = None
        dlv = (None,) * len(need_lv)
        if need_z or any(need_lv):
            level_cots, zcot = _sharded_replay(
                fwd.mesh, tuple(z.shape), fwd.plan, graw, ctx.records,
                _replay.horizon_shifts(fwd.trig, fwd.plan), fwd.rows,
                fwd.az_loc)
            if ctx.own_pyramid:
                dz = _replay.z_cotangent(z, fwd.plan, level_cots, zcot)
            else:
                dlv = tuple(c if n else None
                            for c, n in zip(level_cots, need_lv))
                if need_z:
                    (off0, off1), (in0, in1) = (fwd.plan["offset"],
                                                fwd.plan["inner_shape"])
                    dz = torch.zeros_like(z)
                    dz[off0:off0 + in0, off1:off1 + in1] = zcot
        if ctx.has_ramp and (need_a or need_b):
            dra, drb = _fused.ramp_cotangent(graw, fwd.trig)
        ctx.records = None
        return (dz, dra, drb, None) + dlv


def _horizon(mesh, z, sweep_kw, lims, ramp, levels=(), n_fine=None):
    """The sharded sweep of ``z`` (on the mesh's first device): the
    differentiable Function when anything requires grad, else K1 per
    slot."""
    dev = mesh.device
    z = torch.as_tensor(z).to(device=dev, dtype=torch.float32)
    ramp = (None, None) if ramp is None else tuple(ramp)
    if len(ramp) != 2:
        raise ValueError("tilt_ramp must be a pair (A, B)")
    ramp = tuple(None if r is None else torch.as_tensor(r).to(
        device=dev, dtype=torch.float32) for r in ramp)
    _split(mesh, sweep_kw["inner_shape"], int(sweep_kw["azim_num"]))
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in (z,) + ramp + tuple(levels)):
        kw = dict(sweep=sweep_kw, lims=lims, mesh=mesh, n_fine=n_fine)
        return _ShardedHorizonFn.apply(z.contiguous(), *ramp, kw, *levels)
    with torch.no_grad():
        args = _fused.sweep_args(
            z.detach().contiguous(), pyramid=levels or None,
            tilt_ramp=None if ramp[0] is None else ramp, **sweep_kw)
        raw, _ = _HzForward(mesh, args, n_fine).run(emit_argmax=False)
        return _fused._angles(raw, *lims)


def horizon_sweep_fused_sharded(mesh, z_outer, *, dx, dy, offset,
                                inner_shape, azim_num, dist_search,
                                hori_acc=0.25, elev_ang_low_lim=-15.0,
                                elev_ang_up_lim=89.98, ray_org_elev=0.01,
                                rel_err=None, max_level=10, tilt_ramp=None):
    """Multi-device fused horizon sweep (``horizon_sweep_pallas_sharded``,
    ``horayzon_tpu/parallel/shard.py:36-104``, without its tiling
    arguments).

    The contract of ``fused_sweep.horizon_sweep_fused``: inner rows sharded
    along the mesh's tile axis and azimuths along its azim axis, each slot
    running K1 (a CPU slot its plain version) over its shard with global
    offsets, the outer heightfield replicated; ``tilt_ramp`` sharded by
    rows.  The result is bit-equal to ``horizon_sweep_fused`` on every
    mesh.  Differentiable w.r.t. ``z_outer`` and ``tilt_ramp``
    (K1-argmax and K3's shard variant, bit-equal to the single-device
    gradient; with ``HZT_GRAD_RECOMPUTE=1`` the sharded recompute VJP,
    :func:`_sharded_recompute`).  Requires ``inner_shape[0]`` divisible by
    the tile axis and ``azim_num`` by the azim axis.  Returns (in0, in1,
    azim_num) float32 [radian] on the mesh's first device, on every
    process."""
    sweep_kw = dict(dx=dx, dy=dy, offset=offset, inner_shape=inner_shape,
                    azim_num=azim_num, dist_search=dist_search,
                    hori_acc=hori_acc, ray_org_elev=ray_org_elev,
                    rel_err=rel_err, max_level=max_level)
    return _horizon(mesh, z_outer, sweep_kw,
                    (elev_ang_low_lim, elev_ang_up_lim), tilt_ramp)


def horizon_sweep_multires_fused_sharded(
        mesh, z_fine, z_coarse, *, ratio_log2, coarse_offset, dx, dy,
        offset, inner_shape, azim_num, dist_search, hori_acc=0.25,
        elev_ang_low_lim=-15.0, elev_ang_up_lim=89.98, ray_org_elev=0.01,
        rel_err=None, max_level=10):
    """Memory-scalable multi-device multires horizon
    (``horizon_sweep_multires_pallas_sharded``, ``shard.py:540-664``).

    The combined fine + coarse pyramid of
    ``multires.horizon_sweep_multires_fused``, of which each tile's slots
    hold only their *window* of every fine-derived level (levels below
    ``ratio_log2``): the rows K1 reads or bounds for the tile's cells over
    every azimuth (``fused_sweep.level_reach``), cut as separate
    allocations from a row that is a multiple of 8; the coarse levels are
    replicated.  A read outside a window is an error of the plain version
    and out of the window's buffer for the kernel.  Bit-equal to
    ``horizon_sweep_multires_fused``; differentiable w.r.t. ``z_fine`` and
    ``z_coarse`` (the replay's level cotangents go through the pyramid's
    build to both grids, as on one device).  Planar.  Returns (in0, in1,
    azim_num) float32 [radian] on the mesh's first device."""
    dev = mesh.device
    z_fine = torch.as_tensor(z_fine).to(device=dev, dtype=torch.float32)
    z_coarse = torch.as_tensor(z_coarse).to(device=dev, dtype=torch.float32)
    geo = dict(dx=dx, dy=dy, offset=offset, inner_shape=inner_shape,
               dist_search=dist_search, hori_acc=hori_acc, rel_err=rel_err,
               max_level=max_level)
    levels = _mr.multires_levels(z_fine, z_coarse, ratio_log2=ratio_log2,
                                 coarse_offset=coarse_offset, **geo)
    sweep_kw = dict(geo, azim_num=azim_num, ray_org_elev=ray_org_elev)
    return _horizon(mesh, z_fine, sweep_kw,
                    (elev_ang_low_lim, elev_ang_up_lim), None,
                    tuple(levels), n_fine=int(ratio_log2))


# ---------------------------------------------------------------------------
# The fused shadow metric (K2 / K2-argmax and K4)
# ---------------------------------------------------------------------------

def _shadow_run(mesh, args, grid_origin, emit_argmax):
    """``(metric, records)`` of a sharded K2 run over ``shadow_sweep.
    metric_args``' ``args``: the tile's rows on its first azim slot (the
    reference replicates the sun batch over the azim axis: its other slots
    would repeat the same work); per such slot ``(t, 0, ids, aux)`` with
    ``emit_argmax``."""
    z_org, z_inner, levels, table, plan, outer_shape = args
    rows, _ = _split(mesh, plan["inner_shape"])
    cache = _OnDevice()
    pooled = None
    if any(d.type == "cuda" for _, _, d in mesh.local_slots()):
        pooled = _fused.skip_inputs(levels, plan)
    pieces, records = {}, []
    for t, a, dev in mesh.local_slots():
        if a:
            continue
        r0 = t * rows
        sp = _fused.shard_plan(plan, r0, rows)
        lv = cache.get(dev, lambda: [t_.to(dev) for t_ in levels])
        zo = _rows(z_org, r0, rows, dev)
        zi = _rows(z_inner, r0, rows, dev)
        if dev.type == "cuda":
            pl = cache.get(("pooled", dev), lambda: (
                [p.to(dev) for p in pooled[0]], pooled[1].to(dev)))
            res = _ss._metric_cuda(zo, zi, lv, table, sp, outer_shape,
                                   grid_origin, emit_argmax=emit_argmax,
                                   pooled=pl)
        else:
            res = _ss._metric_plain(zo, zi, lv, table, sp, outer_shape,
                                    grid_origin, emit_argmax=emit_argmax)
        if emit_argmax:
            res, ids, aux = res
            records.append((t, 0, ids, aux))
        pieces[(t, 0)] = res
    return _assemble(mesh, pieces, row_dim=1), records


class _ShardedShadowFn(torch.autograd.Function):
    """The sharded metric with its sharded shadow replay (the reference's
    ``_sh_sharded``, ``_shsh_fwd`` / ``_shsh_bwd``, ``shard.py:760-816``):
    K2-argmax per tile, then :func:`_sharded_replay` in the shadow mode
    (K4's shard variant); the level cotangents go to ``z_outer`` through the
    pyramid's VJP, the ray origins' cotangent, assembled by rows, to
    ``z_org_r``."""

    @staticmethod
    def forward(ctx, z_outer, z_org_r, z_inner_r, kw):
        args = _ss.metric_args(z_outer, z_org_r, z_inner_r, **kw["metric"])
        met, records = _shadow_run(kw["mesh"], args, kw["grid_origin"], True)
        ctx.save_for_backward(z_outer, args[0])
        ctx.records, ctx.kw = records, kw
        ctx.table, ctx.plan = args[3], args[4]
        return met

    @staticmethod
    def backward(ctx, g):
        z, z_org = ctx.saved_tensors
        kw = ctx.kw
        mesh, n_sun = kw["mesh"], ctx.table.shape[0]
        level_cots, dz_org = _sharded_replay(
            mesh, tuple(z.shape), ctx.plan, g.to(torch.float32), ctx.records,
            ctx.table, ctx.plan["inner_shape"][0] // mesh.shape[AXIS_TILE],
            n_sun, shadow=(z_org, kw["grid_origin"]))
        ctx.records = None
        dz = None
        if ctx.needs_input_grad[0]:
            dz = _mip.padded_levels_vjp(z, ctx.plan["pads"], level_cots)
        return dz, (dz_org if ctx.needs_input_grad[1] else None), None, None


def shadow_metric_fused_sharded(mesh, z_outer, z_org_r, z_inner_r,
                                sun_table, *, offset, inner_shape, dx, dy,
                                grid_origin, hori_acc=0.25, rel_err=None):
    """Multi-device fused shadow metric (``shadow_metric_pallas_sharded``,
    ``shard.py:667-816``, without its tiling arguments; the schedule from
    ``hori_acc`` / ``rel_err`` as ``shadow_sweep.shadow_metric_fused``
    plans it).

    Rows sharded over the mesh's tile axis, the whole sun batch per tile
    (the azim axis, if present, carries no work of its own: the reference
    replicates the batch over it).  Each tile's first slot runs K2 with its
    value-exact skips (a CPU slot the plain version); the result is
    bit-equal to ``shadow_metric_fused(exact_metric=True)``.
    Differentiable w.r.t. ``z_outer`` and ``z_org_r`` (K2-argmax and K4's
    shard variant, bit-equal to the single-device gradient).  Returns
    (T, in0, in1) float32 on the mesh's first device."""
    dev = mesh.device
    _split(mesh, inner_shape)
    z = torch.as_tensor(z_outer).to(device=dev, dtype=torch.float32)
    z_org = torch.as_tensor(z_org_r).to(device=dev, dtype=torch.float32)
    kw = dict(metric=dict(sun_table=sun_table, offset=offset,
                          inner_shape=inner_shape, dx=dx, dy=dy,
                          hori_acc=hori_acc, rel_err=rel_err),
              grid_origin=grid_origin, mesh=mesh)
    if torch.is_grad_enabled() and (z.requires_grad or z_org.requires_grad):
        return _ShardedShadowFn.apply(z.contiguous(), z_org.contiguous(),
                                      z_inner_r, kw)
    with torch.no_grad():
        args = _ss.metric_args(z, z_org, z_inner_r, **kw["metric"])
        return _shadow_run(mesh, args, grid_origin, False)[0]


# ---------------------------------------------------------------------------
# The XLA engines (plain torch per shard, as the reference runs them)
# ---------------------------------------------------------------------------

def horizon_sweep_sharded(mesh, z_outer, *, dx, dy, offset, inner_shape,
                          azim, dist_search, hori_acc=0.25,
                          elev_ang_low_lim=-15.0, elev_ang_up_lim=89.98,
                          ray_org_elev=0.01, geom=None, u_xy=None,
                          rel_err=None):
    """Multi-device XLA-engine horizon sweep (``shard.py:819-926``): per
    slot ``ops.sweep.horizon_core`` over the shard's rows and azimuths,
    with the reference's sharded set-up (its schedule unmarked, each
    shard's shift tables from its global first row, its terrain heights
    ``z_org - ray_org_elev`` (times ``mz``)).  Plain torch on the slots'
    devices; it launches no kernel.  ``geom``: the general geometry's
    (in0, in1) basis fields (sharded by rows), ``u_xy`` its (A, 2)
    marching directions.  Returns (in0, in1, A) float32 [radian]."""
    a_num = len(azim)
    rows, az_loc = _split(mesh, inner_shape, a_num)
    dev = mesh.device
    z = torch.as_tensor(z_outer).to(device=dev, dtype=torch.float32)
    step = min(abs(dx), abs(dy))
    if rel_err is None:
        rel_err = _sweep.default_rel_err(hori_acc)
    schedule = _sweep.build_schedule(step, dist_search * 1.0, rel_err)
    azim = np.asarray(azim, dtype=np.float64)
    if u_xy is None:
        u_xy = np.stack([np.sin(azim), np.cos(azim)], axis=-1)
    u_xy = np.asarray(u_xy, dtype=np.float64)
    (off0, off1), (in0, in1) = offset, inner_shape
    elev = _sweep._f(ray_org_elev)
    planar = geom is None
    geom_t = None if planar else _sweep.geom_fields(geom, dev)
    z_inner = z[off0:off0 + in0, off1:off1 + in1]
    z_org = z_inner + (elev if planar else elev * geom_t["mz"])
    cache = _OnDevice()
    pieces = {}
    with torch.no_grad():
        for t, a, sdev in mesh.local_slots():
            r0, sl = t * rows, slice(a * az_loc, (a + 1) * az_loc)
            tables = _sweep.horizon_shift_tables(schedule, azim[sl], dx, dy,
                                                 (off0 + r0, off1),
                                                 u_xy=u_xy[sl])
            zo = _rows(z_org, r0, rows, sdev)
            g_s = None if planar else {k: _rows(v, r0, rows, sdev)
                                       for k, v in geom_t.items()}
            zi = zo - (elev if planar else elev * g_s["mz"])
            hori, _ = _sweep.horizon_core(
                cache.get(sdev, lambda: z.to(sdev)), zo, zi, g_s, tables,
                _sweep.sweep_trig(azim[sl], u_xy[sl]),
                sched_meta=schedule.meta(), pads=schedule.pads,
                inner_shape=(rows, in1), planar=planar, track_dist=False)
            pieces[(t, a)] = hori
    hori = _assemble(mesh, pieces, row_dim=0, az_dim=2)
    return _sweep.tie_clip(hori, math.radians(elev_ang_low_lim),
                           math.radians(elev_ang_up_lim))


def shadow_metric_sharded(mesh, z_outer, z_org, z_inner, m_slope, u_cells,
                          schedule, offset, inner_shape):
    """Multi-device XLA-engine shadow metric for one sun
    (``shard.py:929-967``): rows sharded over the tile axis, per tile
    ``ops.sweep.shadow_metric_core`` over the shard's rows with its global
    first row (the azim axis, if present, carries no work of its own).
    ``schedule``: an ``ops.sweep.Schedule``.  Plain torch; returns
    (in0, in1) float32."""
    rows, _ = _split(mesh, inner_shape)
    dev = mesh.device
    z = torch.as_tensor(z_outer).to(device=dev, dtype=torch.float32)
    fields = [torch.as_tensor(f).to(device=dev, dtype=torch.float32)
              for f in (z_org, z_inner, m_slope)]
    pyramid = _mip.padded_levels(z, schedule.pads)
    s_phases = _sweep.shadow_s_phases(schedule)
    u_cells = np.asarray(u_cells, dtype=np.float32)
    off0, off1 = offset
    cache = _OnDevice()
    pieces = {}
    with torch.no_grad():
        for t, a, sdev in mesh.local_slots():
            if a:
                continue
            r0 = t * rows
            pieces[(t, 0)] = _sweep.shadow_metric_core(
                cache.get(sdev, lambda: [lv.to(sdev) for lv in pyramid]),
                *(_rows(f, r0, rows, sdev) for f in fields), u_cells,
                s_phases, sched_meta=schedule.meta(),
                offset=(off0 + r0, off1), inner_shape=(rows, inner_shape[1]),
                outer_shape=tuple(z.shape))
    return _assemble(mesh, pieces, row_dim=0)
