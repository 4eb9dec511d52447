# Copyright (c) 2026
# MIT License
"""The reference's XLA sweep engine in plain torch, and its schedule.

Counterpart of :mod:`horayzon_tpu.ops.sweep`.  The distance-sample
schedule (``Phase``, ``Schedule``, ``build_schedule``, ``default_rel_err``,
``mark_safe_phases``) and the shift tables (:func:`horizon_shift_tables`)
are NumPy copies, not imports, because importing ``horayzon_tpu`` loads
JAX; ``tests/test_torch_schedule.py`` holds them equal to the originals,
so the port and the reference march the same samples.

The engine itself, :func:`horizon_core` / :func:`horizon_sweep` (planar
and general per-cell-basis geometry, optional ``track_dist``, one level
tuple for multires) and :func:`shadow_metric_core` /
:func:`shadow_metric`, is what the reference runs in XLA outside any
Pallas kernel: off a TPU, for the ``"sweep"`` engines and for non-default
vectors.  Here it is plain torch on the tensors' device, and that is its
port, not a fallback; the fused kernels live in :mod:`.fused_sweep` and
:mod:`.shadow_sweep`.  Every float32 operation is done in the order the
JAX source writes it (``ratio_at``'s ``num / max(den, eps)`` with its
+-3e38 branches, the planar path's division-free interior value
``2 a t + b``, the d1 *paired* interior updates), and every division is a
tensor over a tensor (torch divides a CUDA tensor by a Python scalar as a
product with its reciprocal).  The scalars that are the same for every
azimuth (distances, their reciprocals, segment lengths, the d1 flags) are
formed on the host in float32, as XLA forms them.

``lax.scan`` over samples becomes a Python loop over the same padded
sample sequence (:func:`_pad_unroll`'s duplicates included: they change
the parabola history exactly as in the reference).  The reference scans
one azimuth at a time; :func:`horizon_core` runs a chunk of azimuths at
once (:func:`azimuth_chunk`: as many as keep one (chunk, in0 + 1,
in1 + 1) float32 temporary within :data:`MAX_CHUNK_ELEMS`), which changes
no element's arithmetic: each azimuth's shifted window is gathered from
the padded level and blended with that azimuth's weights.  A window
start is clamped into the level as ``lax.dynamic_slice`` clamps it.  The
shadow core runs one sun at a time, as ``jax.lax.map`` does, and reads
its windows by slicing; it is differentiable by autograd.
"""

import dataclasses
import math

import numpy as np
import torch

from horayzon_tpu_torch.ops import mip as _mip
from horayzon_tpu_torch.ops.replay import sqrt_rn

#: Scan-unroll factor of the reference's XLA sweep: its sample sequences
#: are padded to multiples of it (:func:`_pad_unroll`), and interior
#: dense-phase boundaries of :func:`mark_safe_phases` fall on them.
UNROLL = 8


@dataclasses.dataclass(frozen=True)
class Phase:
    """One constant-mip-level marching phase.

    kind: 'd2' — level-0 near field, two reads per step (midpoint +
          endpoint; per-interval exact parabola);
          'd1' — level-0, one read per step (trailing-window parabola);
          'mip' — coarse-level point samples.
    """
    level: int          # mip level
    pad: int            # padding (in level cells) applied to this level
    num: int            # number of samples
    kind: str = "mip"
    #: True when every sample of the phase provably stays inside the real
    #: heightfield for all inner cells (halo wide enough) — the per-sample
    #: in-domain masks can then be skipped.
    safe: bool = False

    def key(self):
        return (self.kind, self.level, self.pad, self.num, self.safe)


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Distance-sample schedule shared by all azimuths."""
    phases: tuple               # tuple of Phase
    s_values: tuple             # tuple of np.ndarray (one per phase) [metre]
    step: float                 # base step [metre]
    dist: float                 # search distance [metre]

    @property
    def num_levels(self):
        return max(p.level for p in self.phases) + 1

    @property
    def pads(self):
        pads = [0] * self.num_levels
        for p in self.phases:
            pads[p.level] = max(pads[p.level], p.pad)
        return tuple(pads)

    @property
    def num_samples(self):
        return sum(2 * p.num if p.kind == "d2" else p.num
                   for p in self.phases)

    def meta(self):
        """Hashable static description."""
        return tuple(p.key() for p in self.phases)


def build_schedule(step, dist_search, rel_err, max_level=10, near_exact=16):
    """Build the marching schedule.

    Parameters
    ----------
    step : float
        Base sample spacing = finest grid spacing [metre].
    dist_search : float
        Horizon search distance [metre].
    rel_err : float
        Far-field relative-footprint error budget: the dense (exact) phase
        runs to ``step / rel_err``, after which each phase doubles the step
        and the mip level.
    max_level : int
        Maximum mip level to use.
    near_exact : int
        Number of leading dense steps evaluated with two reads per step
        (per-interval exact parabolas) — the strongly angle-sensitive near
        field; the remaining dense steps use one read per step.
    """
    if dist_search <= 0.0:
        raise ValueError("dist_search must be positive")
    rel_err = float(np.clip(rel_err, 1.0e-4, 0.2))
    n_dense = int(math.ceil(1.0 / rel_err))

    phases = []
    s_arrays = []
    # Dense phases at native resolution: sample points step, 2*step, ...
    n0 = min(n_dense, int(math.ceil(dist_search / step)))
    s = np.arange(1, n0 + 1, dtype=np.float64) * step
    s_end = float(s[-1])
    pad0 = int(math.ceil(s_end / step)) + 2
    n2 = min(near_exact, n0)
    phases.append(Phase(level=0, pad=pad0, num=n2, kind="d2"))
    s_arrays.append(s[:n2].astype(np.float32))
    if n0 > n2:
        phases.append(Phase(level=0, pad=pad0, num=n0 - n2, kind="d1"))
        s_arrays.append(s[n2:].astype(np.float32))

    level = 1
    while s_end < dist_search - 1.0e-6:
        lvl = min(level, max_level)
        step_l = step * (2 ** level)
        if lvl == max_level or level >= 60:
            s_cap = dist_search
        else:
            s_cap = min(dist_search, n_dense * step_l)
        s = np.arange(s_end + step_l, s_cap + 0.5 * step_l, step_l,
                      dtype=np.float64)
        if len(s) == 0:
            s = np.array([s_cap], dtype=np.float64)
        s = np.minimum(s, dist_search)
        s_end = float(s[-1])
        pad = int(math.ceil(s_end / (step * 2 ** lvl))) + 2
        phases.append(Phase(level=lvl, pad=pad, num=len(s), kind="mip"))
        s_arrays.append(s.astype(np.float32))
        if lvl == max_level:
            break
        level += 1

    return Schedule(phases=tuple(phases), s_values=tuple(s_arrays),
                    step=float(step), dist=float(dist_search))


def default_rel_err(hori_acc_deg):
    """Far-field error budget matching the reference ``hori_acc`` contract."""
    return math.tan(math.radians(max(hori_acc_deg, 0.02)))


def mark_safe_phases(schedule, halo_cells):
    """Split/flag dense phases whose samples provably stay inside the grid.

    ``halo_cells``: minimum distance (in cells) from any inner cell to the
    outer-grid edge.  Samples with ``s/step + 2 <= halo_cells`` cannot read
    outside the real heightfield for any inner cell, so their in-domain
    masks are skipped (``Phase.safe``).  Dense phases straddling the
    boundary are split in two.
    """
    s_safe = (halo_cells - 2) * schedule.step
    phases = []
    s_arrays = []
    for ph, s in zip(schedule.phases, schedule.s_values):
        if ph.kind not in ("d1", "d2"):
            phases.append(ph)
            s_arrays.append(s)
            continue
        n_safe = int(np.searchsorted(s, s_safe, side="right"))
        # Interior dense-phase boundaries must fall on UNROLL multiples:
        # the scan tables pad trailing samples by duplication, which would
        # otherwise corrupt the parabola history entering the next phase.
        n_safe = (n_safe // UNROLL) * UNROLL
        if n_safe == len(s):
            phases.append(dataclasses.replace(ph, safe=True))
            s_arrays.append(s)
        elif n_safe == 0:
            phases.append(ph)
            s_arrays.append(s)
        else:
            phases.append(dataclasses.replace(ph, num=n_safe, safe=True))
            s_arrays.append(s[:n_safe])
            phases.append(dataclasses.replace(ph, num=len(s) - n_safe))
            s_arrays.append(s[n_safe:])
    return Schedule(phases=tuple(phases), s_values=tuple(s_arrays),
                    step=schedule.step, dist=schedule.dist)


# ---------------------------------------------------------------------------
# The XLA engine (horayzon_tpu/ops/sweep.py:233-928) in plain torch
# ---------------------------------------------------------------------------

_F32 = np.float32
_NEG_INIT = float(_F32(-3.0e38))
_DEN_EPS = float(_F32(1.0e-6))
_TINY = float(_F32(1.0e-12))

#: Memory guard of :func:`horizon_core`'s azimuth chunks: a chunk holds
#: at most this many float32 elements in one (chunk, in0 + 1, in1 + 1)
#: temporary (32 Mi elements = 128 MiB).
MAX_CHUNK_ELEMS = 32 * 2 ** 20


def _f(x):
    """A host float32 value as a Python float (exactly representable)."""
    return float(_F32(x))


def _pad_unroll(arr, unroll):
    """Pad the sample axis (last) to a multiple of ``unroll`` by repeating
    the final sample (duplicate max-updates are no-ops), then fold it into
    (..., M/unroll, unroll)."""
    m = arr.shape[-1]
    m_pad = ((m + unroll - 1) // unroll) * unroll
    if m_pad != m:
        last = arr[..., -1:]
        arr = np.concatenate([arr] + [last] * (m_pad - m), axis=-1)
    return arr.reshape(arr.shape[:-1] + (m_pad // unroll, unroll))


def horizon_shift_tables(schedule, azim, dx, dy, offset, u_xy=None,
                         unroll=UNROLL):
    """Per-(azimuth, sample) shift tables as numpy arrays (copy of
    ``horayzon_tpu.ops.sweep.horizon_shift_tables``).

    ``azim`` (A,) [radian], clockwise from North; ``dx``, ``dy`` the
    signed spacings; ``offset`` the inner domain's start in the outer
    grid; ``u_xy`` optional (A, 2) horizontal marching directions
    (default ``(sin a, cos a)``).  Returns one dict per phase of
    (A, M/unroll, unroll) arrays, the sample axis padded by repeating its
    last sample: level 0 ``i0, j0`` int32, ``fi, fj``, ``s``, ``inv_s``,
    ``s_start`` float32 (d2 phases with ``m_`` / ``e_`` prefixes for the
    midpoint and endpoint reads; d1 phases add the paired interior-update
    flags ``q`` / ``t_lo`` with their parity anchored at the first d1
    step); levels > 0 ``base_i, base_j, r_i, r_j`` int32 (indices formed
    in float32 as the fused kernel forms them), ``s``, ``inv_s``."""
    azim = np.asarray(azim, dtype=np.float64)
    a_num = azim.shape[0]
    off0, off1 = offset
    if u_xy is None:
        u_xy = np.stack([np.sin(azim), np.cos(azim)], axis=-1)
    ux = np.asarray(u_xy[:, 0:1], dtype=np.float64)
    uy = np.asarray(u_xy[:, 1:2], dtype=np.float64)

    d1_m = [np.round(np.asarray(s, np.float64) / schedule.step)
            .astype(np.int64)
            for ph, s in zip(schedule.phases, schedule.s_values)
            if ph.kind == "d1"]
    nx_g = int(d1_m[0][0]) - 1 if d1_m else 0
    m_max_g = int(d1_m[-1][-1]) if d1_m else 0

    def dense_entry(sv, pad, prefix=""):
        di = sv * uy / dy
        dj = sv * ux / dx
        fi0 = np.floor(di)
        fj0 = np.floor(dj)
        return {
            prefix + "i0": (off0 + pad + fi0).astype(np.int32),
            prefix + "j0": (off1 + pad + fj0).astype(np.int32),
            prefix + "fi": (di - fi0).astype(np.float32),
            prefix + "fj": (dj - fj0).astype(np.float32),
        }

    tables = []
    for phase, s in zip(schedule.phases, schedule.s_values):
        s64 = s.astype(np.float64)[None, :]          # (1, M)
        if phase.kind == "d2":
            entry = dense_entry(s64, phase.pad, "e_")
            entry.update(dense_entry(s64 - schedule.step / 2.0,
                                     phase.pad, "m_"))
            entry["s"] = np.broadcast_to(s64, (a_num, len(s))) \
                .astype(np.float32)
            entry["inv_s"] = np.broadcast_to(1.0 / s64, (a_num, len(s))) \
                .astype(np.float32)
            entry["s_start"] = np.broadcast_to(
                s64 - schedule.step, (a_num, len(s))).astype(np.float32)
        elif phase.kind == "d1":
            entry = dense_entry(s64, phase.pad)
            entry["s"] = np.broadcast_to(s64, (a_num, len(s))) \
                .astype(np.float32)
            entry["inv_s"] = np.broadcast_to(1.0 / s64, (a_num, len(s))) \
                .astype(np.float32)
            entry["s_start"] = np.broadcast_to(
                s64 - 2.0 * schedule.step,
                (a_num, len(s))).astype(np.float32)
            m_idx = np.round(s64 / schedule.step).astype(np.int64)
            q = ((m_idx - nx_g) % 2 == 0).astype(np.float32)
            t_lo = np.zeros_like(q)
            if (m_max_g - nx_g) % 2 == 1:
                last = m_idx == m_max_g
                q = np.where(last, np.float32(1.0), q)
                t_lo = np.where(last, np.float32(schedule.step), t_lo)
            entry["q"] = q.astype(np.float32)
            entry["t_lo"] = t_lo.astype(np.float32)
        else:
            k = 2 ** phase.level
            s0 = np.float32(s[0])
            st_l = np.float32(s[1] - s[0]) if len(s) > 1 else np.float32(1)
            m_idx = np.arange(len(s), dtype=np.float32)
            s32 = np.minimum(s0 + m_idx * st_l,
                             np.float32(schedule.dist)).astype(np.float32)
            sh_i = (uy.astype(np.float32)
                    / np.float32(dy)).astype(np.float32)
            sh_j = (ux.astype(np.float32)
                    / np.float32(dx)).astype(np.float32)
            di = np.round((s32[None, :] * sh_i).astype(np.float32))
            dj = np.round((s32[None, :] * sh_j).astype(np.float32))
            ci = off0 + di.astype(np.int64)
            cj = off1 + dj.astype(np.int64)
            entry = {
                "base_i": (ci // k + phase.pad).astype(np.int32),
                "base_j": (cj // k + phase.pad).astype(np.int32),
                "r_i": (ci % k).astype(np.int32),
                "r_j": (cj % k).astype(np.int32),
                "s": np.broadcast_to(s32[None, :], (a_num, len(s)))
                .astype(np.float32),
                "inv_s": np.broadcast_to(1.0 / s32[None, :].astype(
                    np.float64), (a_num, len(s))).astype(np.float32),
            }
        entry = {k2: _pad_unroll(np.ascontiguousarray(
            np.broadcast_to(v, (a_num, v.shape[-1]))), unroll)
            for k2, v in entry.items()}
        tables.append(entry)
    return tables


def tie_clip(x, lo, hi):
    """``x`` clipped to ``[lo, hi]`` as ``jnp.clip`` clips it: the values
    of ``torch.clamp``, but at an exact bound the gradient splits in half,
    as ``jnp.maximum`` / ``jnp.minimum`` split it (``torch.clamp`` passes
    all of it).  ``lo``, ``hi``: Python floats, rounded to ``x``'s dtype."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def _mip_slice_size(n, level):
    return (n + 2 ** level - 2) // (2 ** level) + 1


def _clamp_start(start, size, dim):
    """A ``lax.dynamic_slice`` start: clamped so the slice fits."""
    return np.clip(start, 0, dim - size)


def _segment_quad_coeffs(h0, hm, h1, inv_l):
    """Quadratic h(t) = a t^2 + b t + h0 through three equally spaced
    samples at t = 0, length/2, length (``inv_l`` = float32 1 / length)."""
    a = (2.0 * h1 + 2.0 * h0 - 4.0 * hm) * inv_l * inv_l
    b = (4.0 * hm - 3.0 * h0 - h1) * inv_l
    return a, b


def _segment_interior_t(a, b, h0, z0, s_start, length, t_lo=0.0):
    """Interior stationary point of (h(t) - z0)/(s_start + t) on
    (t_lo, length): the root of a t^2 + 2 a s t + (b s - h0 + z0) = 0.
    ``s_start``, ``length``, ``t_lo`` float32 scalars.  Returns
    ``(clip(t, 0, length), valid)``."""
    big = a.abs() > _TINY
    den = torch.where(big, a, _TINY)
    rad = _f(_F32(s_start) * _F32(s_start)) \
        - (b * s_start - h0 + z0) / den
    pos = rad > 0.0
    t = sqrt_rn(torch.where(pos, rad, 1.0)) + (-s_start)
    valid = big & pos & (t > _f(_F32(t_lo) + _F32(1e-3))) \
        & (t < _f(_F32(length) - _F32(1e-3)))
    return torch.clamp(t, 0.0, length), valid


def azimuth_chunk(a_num, inner_shape):
    """Azimuths per chunk of :func:`horizon_core`: the fewest chunks that
    keep a (chunk, in0 + 1, in1 + 1) temporary within
    :data:`MAX_CHUNK_ELEMS`, balanced in size."""
    in0, in1 = inner_shape
    per = max(1, MAX_CHUNK_ELEMS // ((in0 + 1) * (in1 + 1)))
    n_chunks = -(-a_num // per)
    return -(-a_num // n_chunks)


def _columns(tab, name, sl):
    """Table ``name`` (A, Mu, U) of the azimuths ``sl`` as (M, C): one
    row per padded sample."""
    return tab[name][sl].reshape(sl.stop - sl.start, -1).T


class _ChunkReads:
    """Shifted reads of one azimuth chunk from the padded levels: the
    (chunk, in0, in1) windows, gathered per azimuth at its own start."""

    def __init__(self, pyramid, inner_shape, outer_shape, device):
        self.pyramid = pyramid
        self.inner_shape = inner_shape
        self.outer_shape = outer_shape
        self.dev = device
        in0, in1 = inner_shape
        self.ar0 = torch.arange(in0, device=device)
        self.ar1 = torch.arange(in1, device=device)
        self._base = {}

    def base(self, w):
        """Flat offsets of a (in0 + 1, in1 + 1) window in a level of row
        length ``w``."""
        if w not in self._base:
            in0, in1 = self.inner_shape
            r = torch.arange(in0 + 1, device=self.dev)
            c = torch.arange(in1 + 1, device=self.dev)
            self._base[w] = (r[:, None] * w + c[None, :])[None]
        return self._base[w]

    def _to_dev(self, a, dtype):
        return torch.from_numpy(np.array(a, copy=True, order="C")).to(
            device=self.dev, dtype=dtype)

    def dense_table(self, level, tab, prefix, sl):
        """Device columns of one dense read: per sample (M, C) flat window
        starts (clamped), weights, and the unclamped padded row / column
        of cell (0, 0)'s read for the in-domain mask."""
        hp, wp = self.pyramid[level].shape
        in0, in1 = self.inner_shape
        i0, j0, fi, fj = (_columns(tab, prefix + k, sl)
                          for k in ("i0", "j0", "fi", "fj"))
        ic = _clamp_start(i0.astype(np.int64), in0 + 1, hp)
        jc = _clamp_start(j0.astype(np.int64), in1 + 1, wp)
        return dict(off=self._to_dev(ic * wp + jc, torch.int64),
                    fi=self._to_dev(fi, torch.float32),
                    fj=self._to_dev(fj, torch.float32),
                    pi=self._to_dev(i0, torch.int64),
                    pj=self._to_dev(j0, torch.int64))

    def dense(self, level, t, m):
        """Bilinear read of sample ``m`` (``_read_dense``)."""
        zp = self.pyramid[level]
        c = t["off"].shape[1]
        in0, in1 = self.inner_shape
        idx = t["off"][m].view(c, 1, 1) + self.base(zp.shape[1])
        win = torch.take(zp, idx)
        fi = t["fi"][m].view(c, 1, 1)
        fj = t["fj"][m].view(c, 1, 1)
        top = (1.0 - fj) * win[:, :-1, :-1] + fj * win[:, :-1, 1:]
        bot = (1.0 - fj) * win[:, 1:, :-1] + fj * win[:, 1:, 1:]
        return (1.0 - fi) * top + fi * bot

    def inside(self, t, m, pad):
        """``_inside_mask``: the read's 4-corner stencil lies in the real
        heightfield."""
        c = t["pi"].shape[1]
        h, w = self.outer_shape
        top = self.ar0.view(1, -1, 1) + (t["pi"][m] - pad).view(c, 1, 1)
        left = self.ar1.view(1, 1, -1) + (t["pj"][m] - pad).view(c, 1, 1)
        return ((top >= 0) & (top + 1 <= h - 1)) \
            & ((left >= 0) & (left + 1 <= w - 1))

    def mip_table(self, level, tab, sl):
        """Device columns (M, C) of the mip reads' window starts and
        alignment remainders, clamped as ``lax.dynamic_slice`` clamps
        them."""
        hp, wp = self.pyramid[level].shape
        in0, in1 = self.inner_shape
        k = 2 ** level
        si, sj = _mip_slice_size(in0, level), _mip_slice_size(in1, level)
        bi, bj, ri, rj = (_columns(tab, n, sl).astype(np.int64)
                          for n in ("base_i", "base_j", "r_i", "r_j"))
        return dict(bi=self._to_dev(_clamp_start(bi, si, hp), torch.int64),
                    bj=self._to_dev(_clamp_start(bj, sj, wp), torch.int64),
                    ri=self._to_dev(_clamp_start(ri, in0, si * k),
                                    torch.int64),
                    rj=self._to_dev(_clamp_start(rj, in1, sj * k),
                                    torch.int64))

    def mip(self, level, t, m):
        """Nearest read of mip level ``level`` upsampled to the inner
        resolution (``_read_mip``): cell (a, b) reads window cell
        ((a + r_i) // k, (b + r_j) // k)."""
        zp = self.pyramid[level]
        k = 2 ** level
        c = t["bi"].shape[1]
        rows = t["bi"][m].view(c, 1) \
            + torch.div(self.ar0.view(1, -1) + t["ri"][m].view(c, 1), k,
                        rounding_mode="floor")
        cols = t["bj"][m].view(c, 1) \
            + torch.div(self.ar1.view(1, -1) + t["rj"][m].view(c, 1), k,
                        rounding_mode="floor")
        idx = (rows * zp.shape[1]).view(c, -1, 1) + cols.view(c, 1, -1)
        return torch.take(zp, idx)


def horizon_core(z_outer, z_org, z_inner, geom, tables, trig, *,
                 sched_meta, pads, inner_shape, planar, track_dist,
                 outer_shape=None, apply_arctan=True, a_chunk=None):
    """Horizon sweep core (``horayzon_tpu.ops.sweep.horizon_core_fn``).

    ``z_outer``: (H, W) float32 tensor, or a tuple of padded pyramid
    levels in the layout of :func:`horayzon_tpu_torch.ops.mip.
    padded_levels` (multires; then ``outer_shape`` is the valid fine
    extent).  ``z_org`` / ``z_inner`` (in0, in1) on its device; ``geom``
    None (planar) or a dict of (in0, in1) float32 tensors ``ex, ey, ez,
    nx2, ny2, nz2, mx, my, mz``; ``tables`` :func:`horizon_shift_tables`;
    ``trig`` (A,) float32 NumPy ``sin, cos, ux, uy``.  ``a_chunk``
    azimuths per chunk (default :func:`azimuth_chunk`).  Returns
    ``(hori, dist)``: (in0, in1, A) float32 angles (the raw ratios if not
    ``apply_arctan``) and with ``track_dist`` the distances of the
    winners, else None."""
    if isinstance(z_outer, (tuple, list)):
        pyramid = list(z_outer)
        if outer_shape is None:
            raise ValueError("a pyramid needs its outer_shape")
    else:
        pyramid = _mip.padded_levels(z_outer, pads)
        outer_shape = tuple(z_outer.shape)
    a_num = len(trig["sin"])
    if a_chunk is None:
        a_chunk = azimuth_chunk(a_num, inner_shape)
    reads = _ChunkReads(pyramid, tuple(inner_shape), tuple(outer_shape),
                        z_org.device)
    outs, dists = [], []
    for a0 in range(0, a_num, a_chunk):
        sl = slice(a0, min(a0 + a_chunk, a_num))
        ratio, dist = _core_chunk(reads, z_org, z_inner, geom, tables, trig,
                                  sl, sched_meta, planar, track_dist)
        outs.append(torch.atan(ratio) if apply_arctan else ratio)
        dists.append(dist)
    out = torch.cat(outs).permute(1, 2, 0).contiguous()
    if track_dist:
        return out, torch.cat(dists).permute(1, 2, 0).contiguous()
    return out, None


def _core_chunk(reads, z_org, z_inner, geom, tables, trig, sl, sched_meta,
                planar, track_dist):
    """Running maximum (and winner distance) of one azimuth chunk,
    (C, in0, in1) each: ``azim_body`` of the reference for every azimuth
    of ``sl`` at once."""
    dev = z_org.device
    c = sl.stop - sl.start

    def col(name):
        return torch.from_numpy(np.ascontiguousarray(
            trig[name][sl], dtype=np.float32)).to(dev).view(c, 1, 1)

    if not planar:
        sin_a, cos_a = col("sin"), col("cos")
        ucx = sin_a * geom["ex"] + cos_a * geom["nx2"]
        ucy = sin_a * geom["ey"] + cos_a * geom["ny2"]
        ucz = sin_a * geom["ez"] + cos_a * geom["nz2"]
        gx, gy = col("ux"), col("uy")
        a_n = gx * geom["mx"] + gy * geom["my"]
        a_u = gx * ucx + gy * ucy
        nz = geom["mz"]

    def ratio_at(h, s, inv_s=None):
        """Elevation-angle ratio of sample h at arc s (a float32 scalar
        or a tensor) in the local frame."""
        if planar:
            if inv_s is not None:
                return (h - z_org) * inv_s
            return (h - z_org) / s
        dh = h - z_org
        num = s * a_n + dh * nz
        den = s * a_u + dh * ucz
        return torch.where(den > _DEN_EPS,
                           num / torch.clamp_min(den, _DEN_EPS),
                           torch.where(num > 0.0, -_NEG_INIT, _NEG_INIT))

    ratio = (z_inner * 0.0 + _NEG_INIT).expand(c, -1, -1)
    dist = (z_inner * 0.0).expand(c, -1, -1) if track_dist else None
    valid0 = z_inner == z_inner

    def upd(ratio, dist, r_new, s_new):
        if track_dist:
            dist = torch.where(r_new > ratio, s_new, dist)
        return torch.maximum(ratio, r_new), dist

    def interior_update(ratio, dist, a_c, b_c, h0, t, valid, s_start):
        s_t = t + s_start
        if planar:
            r_int = torch.where(valid, 2.0 * a_c * t + b_c, _NEG_INIT)
        else:
            h_t = a_c * t * t + b_c * t + h0
            r_int = torch.where(valid & (s_t > _DEN_EPS),
                                ratio_at(h_t, torch.clamp_min(s_t,
                                                              _DEN_EPS)),
                                _NEG_INIT)
        return upd(ratio, dist, r_int, s_t)

    h1 = h2 = z_inner
    v1 = v2 = valid0
    for p, (kind, level, pad, _, safe) in enumerate(sched_meta):
        tab = tables[p]

        def scalar(name):
            """A table every azimuth shares, as one row of samples."""
            return tab[name][0].reshape(-1)

        s_col, inv_col = scalar("s"), scalar("inv_s")

        def mask_of(t, m, pad=pad, safe=safe):
            return valid0 if safe else reads.inside(t, m, pad)

        if kind in ("d1", "d2"):
            s_st = scalar("s_start")
            if kind == "d2":
                tm = reads.dense_table(level, tab, "m_", sl)
                te = reads.dense_table(level, tab, "e_", sl)
            else:
                te = reads.dense_table(level, tab, "", sl)
                q_col, tlo_col = scalar("q"), scalar("t_lo")
            for m in range(len(s_col)):
                s_end, s_start = _f(s_col[m]), _f(s_st[m])
                length = _F32(s_col[m]) - _F32(s_st[m])
                inv_l = _f(_F32(1.0) / length)
                he = reads.dense(level, te, m)
                ratio, dist = upd(ratio, dist,
                                  ratio_at(he, s_end, _f(inv_col[m])),
                                  s_end)
                v_end = mask_of(te, m)
                if kind == "d2":
                    hm = reads.dense(level, tm, m)
                    v_mid = mask_of(tm, m)
                    a_c, b_c = _segment_quad_coeffs(h1, hm, he, inv_l)
                    t, valid = _segment_interior_t(a_c, b_c, h1, z_org,
                                                   s_start, _f(length))
                    valid = valid & v1 & v_mid & v_end
                    ratio, dist = interior_update(ratio, dist, a_c, b_c, h1,
                                                  t, valid, s_start)
                elif q_col[m] > 0.5:
                    # the second step of a d1 pair (or the trailing single);
                    # the first step of a pair takes no interior value
                    a_c, b_c = _segment_quad_coeffs(h2, h1, he, inv_l)
                    t, valid = _segment_interior_t(
                        a_c, b_c, h2, z_org, s_start, _f(length),
                        t_lo=_f(tlo_col[m]))
                    valid = valid & v2 & v1 & v_end
                    ratio, dist = interior_update(ratio, dist, a_c, b_c, h2,
                                                  t, valid, s_start)
                h2, v2 = h1, v1
                h1, v1 = he, v_end
        else:
            tl = reads.mip_table(level, tab, sl)
            for m in range(len(s_col)):
                h = reads.mip(level, tl, m)
                ratio, dist = upd(ratio, dist,
                                  ratio_at(h, _f(s_col[m]), _f(inv_col[m])),
                                  _f(s_col[m]))
    return ratio, dist


def sweep_trig(azim, u_xy=None):
    """The (A,) float32 ``sin, cos, ux, uy`` of :func:`horizon_core`, as
    the reference forms them from float64 azimuths."""
    azim = np.asarray(azim, dtype=np.float64)
    if u_xy is None:
        u_xy = np.stack([np.sin(azim), np.cos(azim)], axis=-1)
    return {"sin": np.sin(azim).astype(np.float32),
            "cos": np.cos(azim).astype(np.float32),
            "ux": np.asarray(u_xy[:, 0]).astype(np.float32),
            "uy": np.asarray(u_xy[:, 1]).astype(np.float32)}


def geom_fields(geom, device):
    """The general geometry's basis fields (:func:`horayzon_tpu_torch.
    terrain.basis_fields`) as float32 tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32))
            .to(device) for k, v in geom.items()}


def horizon_sweep(z_outer, *, dx, dy, offset, inner_shape, azim,
                  dist_search, hori_acc=0.25, elev_ang_low_lim=-15.0,
                  elev_ang_up_lim=89.98, ray_org_elev=0.01, geom=None,
                  u_xy=None, rel_err=None, max_level=10, track_dist=False,
                  schedule=None):
    """Horizon elevation angles of a gridded domain
    (``horayzon_tpu.ops.sweep.horizon_sweep``) on ``z_outer``'s device.

    ``z_outer`` (H, W) tensor [metre]; ``dx``, ``dy`` signed spacings;
    ``offset``, ``inner_shape`` the inner block; ``azim`` (A,) [radian];
    ``dist_search`` [metre]; ``geom`` optional per-cell basis fields
    (:func:`horayzon_tpu_torch.terrain.basis_fields`, NumPy) for the
    general geometry, ``u_xy`` its (A, 2) marching directions; ``None``
    selects the planar path.  Returns ``(hori, dist)``: (in0, in1, A)
    float32 [radian] clipped to the limits, and with ``track_dist`` the
    winners' distances [metre], else None."""
    z_outer = torch.as_tensor(z_outer).to(torch.float32)
    step = min(abs(dx), abs(dy))
    if rel_err is None:
        rel_err = default_rel_err(hori_acc)
    if schedule is None:
        schedule = build_schedule(step, dist_search, rel_err,
                                  max_level=max_level)
    h_out, w_out = z_outer.shape
    halo = min(offset[0], offset[1],
               h_out - offset[0] - inner_shape[0],
               w_out - offset[1] - inner_shape[1])
    schedule = mark_safe_phases(schedule, halo)
    azim = np.asarray(azim, dtype=np.float64)
    tables = horizon_shift_tables(schedule, azim, dx, dy, offset, u_xy=u_xy)
    (off0, off1), (in0, in1) = offset, inner_shape
    z_inner = z_outer[off0:off0 + in0, off1:off1 + in1]
    planar = geom is None
    geom_t = None if planar else geom_fields(geom, z_outer.device)
    if planar:
        z_org = z_inner + _f(ray_org_elev)
    else:
        z_org = z_inner + _f(ray_org_elev) * geom_t["mz"]
    hori, dist = horizon_core(
        z_outer, z_org, z_inner, geom_t, tables, sweep_trig(azim, u_xy),
        sched_meta=schedule.meta(), pads=schedule.pads,
        inner_shape=tuple(inner_shape), planar=planar,
        track_dist=track_dist)
    hori = tie_clip(hori, math.radians(elev_ang_low_lim),
                    math.radians(elev_ang_up_lim))
    return (hori, dist) if track_dist else (hori, None)


# ---------------------------------------------------------------------------
# Shadow sweep core (one sun, marching direction from the host)
# ---------------------------------------------------------------------------

def shadow_s_phases(schedule, unroll=UNROLL):
    """The schedule's sample distances per phase, padded to multiples of
    ``unroll`` as the reference pads them (``_pad_unroll``) and
    flattened: float32 NumPy."""
    return tuple(_pad_unroll(s[None, :], unroll)[0].reshape(-1)
                 for s in schedule.s_values)


def _window(zp, i0, j0, n0, n1):
    """``lax.dynamic_slice(zp, (i0, j0), (n0, n1))`` for host ints."""
    h, w = zp.shape
    i0 = int(_clamp_start(i0, n0, h))
    j0 = int(_clamp_start(j0, n1, w))
    return zp[i0:i0 + n0, j0:j0 + n1]


def shadow_metric_core(pyramid, z_org, z_inner, m_slope, u_cells, s_phases,
                       *, sched_meta, offset, inner_shape, outer_shape):
    """Maximum over the sun ray of ``h(s) - (z_org + s * m_slope)``
    (``horayzon_tpu.ops.sweep.shadow_metric_core_fn``) for one sun.

    ``pyramid``: padded levels (:func:`horayzon_tpu_torch.ops.mip.
    padded_levels` of the (H, W) ``outer_shape`` grid with the schedule's
    pads); ``z_org``, ``z_inner``, ``m_slope`` (in0, in1) tensors on its
    device (``m_slope`` the per-cell ray slope); ``u_cells`` the float32
    (ui, uj) marching direction in grid cells per metre (host NumPy);
    ``s_phases`` :func:`shadow_s_phases`.  Differentiable by autograd
    w.r.t. the levels, ``z_org`` and ``m_slope``.  Returns (in0, in1)
    float32: > 0 where the terrain hides the sun."""
    in0, in1 = inner_shape
    h_out, w_out = outer_shape
    off0, off1 = offset
    ui, uj = _F32(u_cells[0]), _F32(u_cells[1])
    dev = z_org.device
    ar0 = torch.arange(in0, device=dev)
    ar1 = torch.arange(in1, device=dev)
    metric = z_inner * 0.0 + _NEG_INIT
    valid0 = z_inner == z_inner

    def inside(ii, jj, pad):
        top = ar0 + (ii - pad)
        left = ar1 + (jj - pad)
        ok_i = (top >= 0) & (top + 1 <= h_out - 1)
        ok_j = (left >= 0) & (left + 1 <= w_out - 1)
        return ok_i[:, None] & ok_j[None, :]

    h1 = h2 = z_inner
    v1 = v2 = valid0
    for p, (kind, level, pad, *_rest) in enumerate(sched_meta):
        s_arr = s_phases[p]
        zp = pyramid[level]
        if level == 0:
            s_last = _F32(0.0)
            for s in s_arr:
                s = _F32(s)
                step_len = max(s - s_last, _F32(1e-3))
                s_start = s - _F32(2.0) * step_len
                length = _F32(2.0) * step_len
                di, dj = s * ui, s * uj
                fi0, fj0 = np.floor(di), np.floor(dj)
                fi, fj = di - fi0, dj - fj0
                ii = int(fi0) + off0 + pad
                jj = int(fj0) + off1 + pad
                win = _window(zp, ii, jj, in0 + 1, in1 + 1)
                wj0, wj1 = _f(_F32(1.0) - fj), _f(fj)
                top = wj0 * win[:-1, :-1] + wj1 * win[:-1, 1:]
                bot = wj0 * win[1:, :-1] + wj1 * win[1:, 1:]
                he = _f(_F32(1.0) - fi) * top + _f(fi) * bot
                metric = torch.maximum(metric,
                                       he - z_org - _f(s) * m_slope)
                v_end = inside(ii, jj, pad)
                if s_start > _F32(-1e-6):
                    a_c, b_c = _segment_quad_coeffs(
                        h2, h1, he, _f(_F32(1.0) / length))
                    big = a_c.abs() > _TINY
                    t = (m_slope - b_c) / torch.where(big, 2.0 * a_c, _TINY)
                    valid = big & (a_c < 0.0) \
                        & (t > _f(_F32(0.5) * length)) & (t < _f(length)) \
                        & v2 & v1 & v_end
                    g_t = (a_c * t * t + b_c * t + h2 - z_org
                           - (t + _f(s_start)) * m_slope)
                    metric = torch.maximum(
                        metric, torch.where(valid, g_t, _NEG_INIT))
                h2, v2 = h1, v1
                h1, v1 = he, v_end
                s_last = s
        else:
            k = 2 ** level
            with torch.no_grad():
                # the provably safe phase skip (exact: no cell's metric
                # can rise)
                m_det = m_slope.detach()
                gain = (zp.detach().max() - z_org.detach()) - torch.minimum(
                    _f(s_arr[0]) * m_det, _f(s_arr[-1]) * m_det)
                skip = bool(((gain - metric.detach()).max() <= 0.0).item())
            if skip:
                continue
            si, sj = _mip_slice_size(in0, level), _mip_slice_size(in1, level)
            for s in s_arr:
                s = _F32(s)
                ci = int(np.round(s * ui)) + off0
                cj = int(np.round(s * uj)) + off1
                bi, bj = ci // k + pad, cj // k + pad
                ri, rj = ci % k, cj % k
                win = _window(zp, bi, bj, si, sj)
                ri = int(_clamp_start(ri, in0, si * k))
                rj = int(_clamp_start(rj, in1, sj * k))
                h = win[torch.div(ar0 + ri, k, rounding_mode="floor")][
                    :, torch.div(ar1 + rj, k, rounding_mode="floor")]
                metric = torch.maximum(metric,
                                       h - z_org - _f(s) * m_slope)
    return metric


def shadow_metric(z_outer, z_org, z_inner, m_slope, u_cells, schedule,
                  offset, inner_shape):
    """Run the shadow occlusion sweep for one sun
    (``horayzon_tpu.ops.sweep.shadow_metric``): the pyramid of
    ``z_outer`` with the schedule's pads, then
    :func:`shadow_metric_core`."""
    z_outer = torch.as_tensor(z_outer).to(torch.float32)
    return shadow_metric_core(
        _mip.padded_levels(z_outer, schedule.pads), z_org, z_inner, m_slope,
        np.asarray(u_cells, dtype=np.float32), shadow_s_phases(schedule),
        sched_meta=schedule.meta(), offset=tuple(offset),
        inner_shape=tuple(inner_shape), outer_shape=tuple(z_outer.shape))
