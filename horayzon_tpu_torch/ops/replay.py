# Copyright (c) 2026
# MIT License
"""Winner-replay backward of the fused horizon sweep: the counterpart of
``horayzon_tpu.ops.pallas_sweep.backward_replay_fn`` (horizon mode, no
tilt ramp).

The argmax forward (``fused_sweep``, ``emit_argmax=True``) records per
(azimuth, inner cell) the id of the candidate that won the running maximum
and, for a parabola winner, its stationary denominator D.  The backward
replays only those winners: envelope-theorem partials, closed-form in D, so
no height is re-read.  :func:`backward_replay` returns one cotangent array
per padded pyramid level (the layout of :func:`mip.padded_levels`) and the
(in0, in1) cotangent of ``z_org``; :func:`z_cotangent` routes them to the
outer heightfield.  Two implementations of identical formulas:

* kernel K3, ``csrc/horizon_replay_bwd.cu`` (CUDA C++ for ``sm_90a``, a
  deterministic gather), run for CUDA tensors;
* :func:`backward_replay_plain`, a scatter in plain torch vectorised over
  the inner cells, run for CPU tensors and used on the card as K3's
  reference.

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


def _mip_s(s_first, step_l, m, dist):
    f32 = np.float32
    return np.minimum(f32(s_first) + f32(m) * f32(step_l), dist)


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

def backward_replay_plain(z_shape, graw, ids, aux, plan, trig):
    """Winner replay in plain torch: per azimuth and sample, the winners'
    coefficients as (in0, in1) fields, added into shifted slices of the
    level-0 cotangent (bilinear corners) or, on mip levels, with
    ``index_put_(accumulate=True)``.

    ``graw``/``aux`` (A, in0, in1) float32, ``ids`` (A, in0, in1) int32 on
    one device; ``plan`` from :func:`fused_sweep.plan_sweep` (its
    ``consts`` are the float32 scalars the forward used); ``trig`` the
    (A, 2) host table of :func:`fused_sweep.trig_table`.  Returns
    ``(level_cots, zcot)``."""
    f32 = np.float32
    k = plan["consts"]
    in0, in1 = plan["inner_shape"]
    off0, off1 = plan["offset"]
    nx, n_dense = plan["nx"], plan["n_dense"]
    pads = plan["pads"]
    dev = graw.device
    cots = [torch.zeros(s, dtype=torch.float32, device=dev)
            for s in padded_level_shapes(z_shape, pads)]
    zcot = torch.zeros((in0, in1), dtype=torch.float32, device=dev)
    rows = torch.arange(off0, off0 + in0, device=dev)
    cols = torch.arange(off1, off1 + in1, device=dev)
    step, pad0 = k["step"], pads[0]

    for az in range(trig.shape[0]):
        sh_i = f32(trig[az, 1]) / f32(plan["dy"])
        sh_j = f32(trig[az, 0]) / f32(plan["dx"])
        g, idv, ax = graw[az], ids[az], aux[az]
        zc = torch.zeros_like(zcot)

        def scatter0(coef, s):
            """Adjoint of the bilinear level-0 read at distance s."""
            dif, djf = s * sh_i, s * sh_j
            di, dj = np.floor(dif), np.floor(djf)
            fi, fj = dif - di, djf - dj
            r = off0 + int(di) + pad0
            c = off1 + int(dj) + pad0
            for ci, wi in ((0, f32(1.0) - fi), (1, fi)):
                for cj, wj in ((0, f32(1.0) - fj), (1, fj)):
                    cots[0][r + ci:r + ci + in0, c + cj:c + cj + in1] += (
                        coef * float(wi) * float(wj))

        def quad_coef(m):
            """g / D of the parabola winners 2m+1 (D > 1e-3), else 0."""
            ok = (idv == 2 * m + 1) & (ax > 1e-3)
            inv_d = torch.where(ok, 1.0 / torch.where(ok, ax, 1.0), 0.0)
            return torch.where(ok, g, 0.0) * inv_d

        def envelope(kind, qt):
            qt2 = qt * qt
            if kind == 0:
                return 2.0 * qt2 - 3.0 * qt + 1.0
            if kind == 1:
                return 4.0 * qt - 4.0 * qt2
            return 2.0 * qt2 - qt

        # d2 near field (pallas_sweep.py:1864-1936)
        for m in range(nx):
            s = f32(m + 1) * step
            pm = idv == 2 * m
            if bool(pm.any()):
                coef = torch.where(pm, g, 0.0) * float(f32(1.0) / s)
                scatter0(coef, s)
                zc += -coef
            if bool((idv == 2 * m + 1).any()):
                gq = quad_coef(m)
                zc += -gq
                s0 = f32(m) * step
                qt = float(k["inv_l0"]) * (ax - float(s0))
                for kind, sk in enumerate((s0, s0 + k["half_step"],
                                           s0 + step)):
                    scatter0(gq * envelope(kind, qt), sk)

        # d1 mid field, merged per position q (pallas_sweep.py:1944-2005)
        for q in range(max(nx - 2, 0), n_dense):
            s = f32(q + 1) * step
            hit = (idv >= 2 * q) & (idv <= 2 * q + 5)
            if not bool(hit.any()):
                continue
            coef = (torch.where((idv == 2 * q) & (q >= nx), g, 0.0)
                    * float(f32(1.0) / s))
            zc += -coef
            for off in range(3):
                mm = q + off
                if not nx + 1 <= mm < n_dense:
                    continue
                gq = quad_coef(mm)
                s0 = f32(mm - 1) * step
                qt = float(k["inv_l1"]) * (ax - float(s0))
                coef = coef + gq * envelope(2 - off, qt)
                if off == 0:
                    zc += -gq
            scatter0(coef, s)

        # mip phases: g / s on the coarse cell (pallas_sweep.py:2024-2038)
        for lvl, n_m, s_first, step_l, id_off in _mip_phases(plan):
            kp = 2 ** lvl
            for m in range(n_m):
                pm = idv == id_off + m
                if not bool(pm.any()):
                    continue
                s = _mip_s(s_first, step_l, m, k["dist"])
                coef = torch.where(pm, g, 0.0) * float(f32(1.0) / s)
                zc += -coef
                ri = int(np.rint(s * sh_i))
                rj = int(np.rint(s * sh_j))
                r = torch.div(rows + ri, kp, rounding_mode="floor") + pads[lvl]
                c = torch.div(cols + rj, kp, rounding_mode="floor") + pads[lvl]
                cots[lvl].index_put_((r[:, None], c[None, :]), coef,
                                     accumulate=True)
        zcot += zc
    return cots, zcot


# ---------------------------------------------------------------------------
# Kernel K3 (csrc/horizon_replay_bwd.cu)
# ---------------------------------------------------------------------------

class _BwdParams(ctypes.Structure):
    """Mirror of ``struct BwdParams`` in csrc/horizon_replay_bwd.cu."""
    _fields_ = (
        [("ids", ctypes.c_void_p), ("g", ctypes.c_void_p),
         ("aux", ctypes.c_void_p), ("trig", ctypes.c_void_p),
         ("zcot", ctypes.c_void_p), ("cot", ctypes.c_void_p * _MAX_LEVELS)]
        + [(n, ctypes.c_int * _MAX_LEVELS)
           for n in ("lvl_w", "lvl_pad", "box_r0", "box_r1", "box_c0",
                     "box_c1", "ph_lvl", "ph_n")]
        + [(n, ctypes.c_float * _MAX_LEVELS)
           for n in ("ph_s_first", "ph_step")]
        + [(n, ctypes.c_int)
           for n in ("n_phases", "in0", "in1", "a_num", "off0", "off1", "nx",
                     "n_dense")]
        + [(n, ctypes.c_float)
           for n in ("dx", "dy", "step", "dist", "half_step", "inv_l0",
                     "inv_l1")])


def _kernel_lib():
    """The loaded K3 library (built with nvcc on first use)."""
    lib = _build.load("horizon_replay_bwd")
    lib.horizon_replay_bwd_launch.argtypes = [
        ctypes.POINTER(_BwdParams), ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    lib.horizon_replay_bwd_launch.restype = ctypes.c_int
    lib.horizon_replay_bwd_error_string.argtypes = [ctypes.c_int]
    lib.horizon_replay_bwd_error_string.restype = ctypes.c_char_p
    lib.horizon_replay_bwd_params_size.argtypes = []
    lib.horizon_replay_bwd_params_size.restype = ctypes.c_int
    size = lib.horizon_replay_bwd_params_size()
    if size != ctypes.sizeof(_BwdParams):
        raise RuntimeError(f"BwdParams is {size} bytes in the kernel but "
                           f"{ctypes.sizeof(_BwdParams)} in _BwdParams")
    return lib


def _target_boxes(z_shape, plan, trig):
    """Per level, the box ``(r0, r1, c0, c1)`` of padded-level cells that a
    sample of the sweep can touch (empty ``(0, 0, 0, 0)`` for a level no
    phase reads).  Computed from the same float32 shifts as the kernels,
    widened by one cell and clipped to the level."""
    f32 = np.float32
    k = plan["consts"]
    in0, in1 = plan["inner_shape"]
    off0, off1 = plan["offset"]
    nx, n_dense, step = plan["nx"], plan["n_dense"], k["step"]
    sh_i = (trig[:, 1].astype(f32) / f32(plan["dy"]))[:, None]
    sh_j = (trig[:, 0].astype(f32) / f32(plan["dx"]))[:, None]
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


def _bwd_cuda(z_shape, graw, ids, aux, plan, trig):
    """``(level_cots, zcot)`` from kernel K3 on ``graw``'s card."""
    global KERNEL_LAUNCHES
    dev = graw.device
    in0, in1 = plan["inner_shape"]
    a_num = trig.shape[0]
    for t, dt in ((graw, torch.float32), (ids, torch.int32),
                  (aux, torch.float32)):
        if (t.device != dev or t.dtype != dt or not t.is_contiguous()
                or tuple(t.shape) != (a_num, in0, in1)):
            raise ValueError("K3 takes contiguous (A, in0, in1) float32 "
                             "graw/aux and int32 ids on one CUDA device")
    phases = plan["phases_meta"]
    shapes = padded_level_shapes(z_shape, plan["pads"])
    if len(shapes) > _MAX_LEVELS or len(phases) > _MAX_LEVELS:
        raise ValueError(f"at most {_MAX_LEVELS} pyramid levels")
    cots = [torch.zeros(s, dtype=torch.float32, device=dev) for s in shapes]
    zcot = torch.empty((in0, in1), dtype=torch.float32, device=dev)
    trig_t = torch.from_numpy(trig).to(dev)
    prm = _BwdParams()
    prm.ids, prm.g, prm.aux = ids.data_ptr(), graw.data_ptr(), aux.data_ptr()
    prm.trig, prm.zcot = trig_t.data_ptr(), zcot.data_ptr()
    boxes = _target_boxes(z_shape, plan, trig)
    for lvl, (t, box) in enumerate(zip(cots, boxes)):
        prm.cot[lvl] = t.data_ptr()
        prm.lvl_w[lvl] = t.shape[1]
        prm.lvl_pad[lvl] = plan["pads"][lvl]
        (prm.box_r0[lvl], prm.box_r1[lvl], prm.box_c0[lvl],
         prm.box_c1[lvl]) = box
    for p, (lvl, n_m, s_first, step_l) in enumerate(phases):
        prm.ph_lvl[p], prm.ph_n[p] = lvl, n_m
        prm.ph_s_first[p], prm.ph_step[p] = s_first, step_l
    prm.n_phases = len(phases)
    prm.in0, prm.in1, prm.a_num = in0, in1, a_num
    prm.off0, prm.off1 = plan["offset"]
    prm.nx, prm.n_dense = plan["nx"], plan["n_dense"]
    prm.dx, prm.dy = np.float32(plan["dx"]), np.float32(plan["dy"])
    for n in ("step", "dist", "half_step", "inv_l0", "inv_l1"):
        setattr(prm, n, plan["consts"][n])
    lib = _kernel_lib()
    err = lib.horizon_replay_bwd_launch(
        ctypes.byref(prm), len(shapes), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        msg = lib.horizon_replay_bwd_error_string(err).decode()
        raise RuntimeError(f"horizon_replay_bwd kernel launch failed: {msg}")
    KERNEL_LAUNCHES += 1
    return cots, zcot


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def backward_replay(z_shape, graw, ids, aux, plan, trig):
    """``(level_cots, zcot)`` of the winners recorded by the argmax forward:
    kernel K3 for CUDA tensors (a failed build or launch raises),
    :func:`backward_replay_plain` for CPU tensors."""
    if graw.device.type == "cuda":
        return _bwd_cuda(z_shape, graw, ids, aux, plan, trig)
    if graw.device.type == "cpu":
        return backward_replay_plain(z_shape, graw, ids, aux, plan, trig)
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
    forward (``pallas_forward_fn(..., emit_argmax=True)``), whose rows may
    be padded to ``azim_pad``: the padding is cropped, ids become int32.
    The port's backward can then run on the reference's forward record."""
    out = []
    for a, dt in ((raw, np.float32), (ids, np.int32), (aux, np.float32)):
        a = np.asarray(a)
        if a.ndim != 3 or a.shape[0] < azim_num:
            raise ValueError(f"array of shape {a.shape} holds fewer than "
                             f"{azim_num} azimuth rows")
        out.append(torch.from_numpy(np.array(a[:azim_num], dtype=dt))
                   .to(device))
    return tuple(out)
