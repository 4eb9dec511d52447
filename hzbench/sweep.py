"""The benchmark's own sweep: a frozen plain-torch copy of the horizon and
shadow sweeps, run at a sample of cells, with a model of the value-exact
and sign-exact skips.

Copied at commit c632955 from ``horayzon_tpu_torch`` (which this module
does not import), and rewritten to gather a list of cells in place of
slicing the inner block:

* the schedule: ``ops/sweep.py::build_schedule``, ``default_rel_err``;
* the plan and its tables: ``ops/fused_sweep.py::plan_sweep``,
  ``_constants``, ``step_table``, ``trig_table``;
  ``ops/shadow_sweep.py::plan_shadow``, ``shadow_sun_table``,
  ``ray_slopes``; ``ops/replay.py::lattice_xy``, ``sqrt_rn``;
* the pyramid and its pooled companions: ``ops/mip.py::max_downsample2``,
  ``padded_levels``, ``pool8``, ``pool8_floor``;
* the sweep: ``ops/fused_sweep.py::sweep_plain``, ``_horizon_rows``,
  ``ops/shadow_sweep.py::_shadow_rows``;
* the skip model: ``ops/fused_sweep.py::warp_skip_plain`` and the counts
  of ``ops/shadow_sweep.py::metric_model``.

Every float32 operation is the original's, in its order, so at float32
this sweep gives the program's plain values.  ``dtype=torch.bfloat16``
runs the same arithmetic in bfloat16: the control of the comparison.

Cells come as whole blocks of the kernel (8 rows of 32 columns), so the
skip model sees every lane of a warp.  A block at the domain's edge
repeats its last column (a lane past the edge runs on the last cell, as
the kernel's does) and its last row; the repeated cells carry weight 0.
"""

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

F32 = np.float32
NEG_INIT = -3.0e38
POS_INIT = 3.0e38
PAD_VALUE = -3.0e4
NEG_TINY = float(F32(-1.0e-12))
BLOCK_ROWS, BLOCK_COLS = 8, 32
D1_CHUNK_PAIRS = 16
MIP_CHUNK = 32
D1_SLACK = F32(2.0 ** -18)
D1_REL = F32(2.0 ** -20)


# ---------------------------------------------------------------------------
# Schedule and plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Phase:
    level: int
    pad: int
    num: int
    kind: str = "mip"


def build_schedule(step, dist_search, rel_err, max_level=10, near_exact=16):
    """The distance samples: (phases, s_values)."""
    rel_err = float(np.clip(rel_err, 1.0e-4, 0.2))
    n_dense = int(math.ceil(1.0 / rel_err))
    phases, s_arrays = [], []
    n0 = min(n_dense, int(math.ceil(dist_search / step)))
    s = np.arange(1, n0 + 1, dtype=np.float64) * step
    s_end = float(s[-1])
    pad0 = int(math.ceil(s_end / step)) + 2
    n2 = min(near_exact, n0)
    phases.append(Phase(0, pad0, n2, "d2"))
    s_arrays.append(s[:n2].astype(F32))
    if n0 > n2:
        phases.append(Phase(0, pad0, n0 - n2, "d1"))
        s_arrays.append(s[n2:].astype(F32))
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
        phases.append(Phase(lvl, pad, len(s)))
        s_arrays.append(s.astype(F32))
        if lvl == max_level:
            break
        level += 1
    return phases, s_arrays


def default_rel_err(hori_acc_deg):
    return math.tan(math.radians(max(hori_acc_deg, 0.02)))


def plan_sweep(outer_shape, *, inner_shape, offset, dist_search, dx, dy,
               hori_acc=0.25, max_level=10):
    """The static plan of one sweep over the inner block."""
    step = float(min(abs(dx), abs(dy)))
    phases, s_values = build_schedule(step, float(dist_search),
                                      default_rel_err(hori_acc), max_level)
    pads = [0] * (max(p.level for p in phases) + 1)
    for p in phases:
        pads[p.level] = max(pads[p.level], p.pad)
    n_dense = sum(ph.num for ph in phases if ph.level == 0)
    meta = [(0, n_dense, step, step)]
    for p, ph in enumerate(phases):
        if ph.level == 0:
            continue
        sv = s_values[p]
        step_l = float(sv[1] - sv[0]) if ph.num > 1 else step * 2 ** ph.level
        meta.append((ph.level, ph.num, float(sv[0]), step_l))
    (in0, in1), (off0, off1), (h, w) = inner_shape, offset, outer_shape
    halo = min(off0, off1, h - off0 - in0, w - off1 - in1)
    n_safe = max(0, halo - 2)
    near_ex = phases[0].num if phases[0].kind == "d2" else 0
    nx = min(near_ex, n_dense)
    ns2 = min(nx, n_safe)
    ns1 = max(nx, min(n_dense, n_safe))
    if ns1 < n_dense:
        ns1 = nx + ((ns1 - nx) // 2) * 2
    plan = dict(phases_meta=tuple(meta), pads=tuple(pads),
                offset=(int(off0), int(off1)), inner_shape=(in0, in1),
                outer_shape=(h, w), dx=float(dx), dy=float(dy), step=step,
                dist=float(dist_search), n_dense=n_dense, nx=nx, ns2=ns2,
                ns1=ns1)
    k = plan["consts"] = dict(
        step=F32(step), half_step=F32(0.5 * step), two_step=F32(2.0 * step),
        dist=F32(dist_search), inv_l0=F32(1.0 / step),
        inv_l0_sq=F32((1.0 / step) * (1.0 / step)), inv_l1=F32(0.5 / step),
        inv_l1_sq=F32((0.5 / step) * (0.5 / step)),
        s_m1_safe=F32((nx + 2 * ((ns1 - nx) // 2) - 1) * step),
        s_m1_masked=F32((ns1 + 2 * ((n_dense - ns1) // 2) - 1) * step),
        lo2_0=F32(2.0 * (0.0 + 1e-3)), lo2_step=F32(2.0 * (step + 1e-3)),
        hi2_step=F32(2.0 * (step - 1e-3)),
        hi2_two_step=F32(2.0 * (2.0 * step - 1e-3)))
    # (s, 1/s) of every sample, in the order of the sample ids
    s = np.arange(1, n_dense + 1, dtype=np.int64).astype(F32) * k["step"]
    for lo, hi in ((nx, ns1), (ns1, n_dense)):
        if hi > lo:
            second = np.arange(lo + 1, lo + 2 * ((hi - lo) // 2), 2)
            s[second] = s[second - 1] + k["step"]
    parts = [s]
    for _, n_m, s_first, step_l in meta[1:]:
        m = np.arange(n_m, dtype=np.int64).astype(F32)
        parts.append(np.minimum(F32(s_first) + m * F32(step_l), k["dist"]))
    s = np.concatenate(parts).astype(F32)
    plan["steps"] = np.stack([s, F32(1.0) / s], axis=-1)
    return plan


def plan_shadow(outer_shape, *, inner_shape, offset, dx, dy, hori_acc=0.25):
    """The shadow sweep's plan: rays to the outer grid's diagonal."""
    h, w = outer_shape
    return plan_sweep(outer_shape, inner_shape=inner_shape, offset=offset,
                      dist_search=math.hypot(w * abs(dx), h * abs(dy)),
                      dx=dx, dy=dy, hori_acc=hori_acc)


def trig_table(azim_num):
    """(A, 2) float32 (sin, cos) of the float32 azimuths."""
    az = ((2.0 * np.pi) / azim_num * np.arange(azim_num)).astype(F32)
    return np.stack([np.sin(az.astype(np.float64)),
                     np.cos(az.astype(np.float64))], axis=-1).astype(F32)


def sun_table(sun_positions, center, dx, dy):
    """(T, 8) float32: sun x, y, z, kx_u, ky_u, ui, uj, 0; and the (T,)
    near-vertical flags."""
    sp = np.atleast_2d(np.asarray(sun_positions, dtype=np.float64))
    kx, ky = sp[:, 0] - center[0], sp[:, 1] - center[1]
    k_norm = np.hypot(kx, ky)
    near = k_norm < 1.0e-6
    kx_u = np.where(near, 1.0, kx / np.maximum(k_norm, 1e-6))
    ky_u = np.where(near, 0.0, ky / np.maximum(k_norm, 1e-6))
    table = np.zeros((sp.shape[0], 8), dtype=F32)
    table[:, 0:3] = sp
    table[:, 3], table[:, 4] = kx_u, ky_u
    table[:, 5], table[:, 6] = ky_u / dy, kx_u / dx
    return table, near


def sqrt_rn(x):
    """Correctly rounded square root of a float32 tensor."""
    return torch.sqrt(x.double()).to(x.dtype)


# ---------------------------------------------------------------------------
# Pyramid
# ---------------------------------------------------------------------------

def _down2(z):
    h, w = z.shape
    if h % 2 or w % 2:
        z = F.pad(z, (0, w % 2, 0, h % 2), value=PAD_VALUE)
    r = torch.maximum(z[0::2, :], z[1::2, :])
    return torch.maximum(r[:, 0::2], r[:, 1::2])


def padded_levels(z, pads):
    """The max-mip pyramid of ``z`` with ``pads[l]`` sentinels around
    level ``l``."""
    levels = [z]
    for _ in range(len(pads) - 1):
        levels.append(_down2(levels[-1]))
    return [F.pad(lv, (p, p, p, p), value=PAD_VALUE).contiguous()
            for lv, p in zip(levels, pads)]


def pooled(levels, pad0):
    """The 8 x 8 max-pooled companion of each padded level and the 8 x 8
    min-pooled floor of level 0's in-domain cells."""
    out = []
    for lv in levels:
        h, w = lv.shape
        h8, w8 = -(-h // 8), -(-w // 8)
        zp = F.pad(lv, (0, 8 * w8 - w, 0, 8 * h8 - h), value=PAD_VALUE)
        out.append(zp.view(h8, 8, w8, 8).amax(dim=(1, 3)).contiguous())
    lv = levels[0]
    h, w = lv.shape
    h8, w8 = -(-h // 8), -(-w // 8)
    zp = torch.full((8 * h8, 8 * w8), -PAD_VALUE, dtype=lv.dtype,
                    device=lv.device)
    zp[pad0:h - pad0, pad0:w - pad0] = lv[pad0:h - pad0, pad0:w - pad0]
    return out, zp.view(h8, 8, w8, 8).amin(dim=(1, 3)).contiguous()


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Cells:
    """Whole kernel blocks of the inner block: per cell its outer row and
    column (``rows``, ``cols``, int64), inner row and column (``ii``,
    ``jj``), and ``weight`` 1 for a cell of the domain, 0 for a repeat.
    Cells are ordered block, row, lane, so each 32 in a row are a warp."""
    rows: torch.Tensor
    cols: torch.Tensor
    ii: torch.Tensor
    jj: torch.Tensor
    weight: torch.Tensor

    @property
    def n(self):
        return self.rows.numel()


def block_grid(inner_shape):
    """(block rows, block columns) of the kernel's grid."""
    in0, in1 = inner_shape
    return -(-in0 // BLOCK_ROWS), -(-in1 // BLOCK_COLS)


def sample_blocks(inner_shape, n_blocks, rng, live=None):
    """``n_blocks`` distinct block indices (row-major) drawn by ``rng``
    (all blocks if there are fewer), from ``live`` (a bool array of
    :func:`block_grid`'s shape) if given, in ascending order."""
    nb0, nb1 = block_grid(inner_shape)
    pool = (np.arange(nb0 * nb1) if live is None
            else np.flatnonzero(np.asarray(live).reshape(-1)))
    if n_blocks >= pool.size:
        return pool
    return np.sort(rng.choice(pool, size=n_blocks, replace=False))


def cells_of_blocks(blocks, plan, device):
    """:class:`Cells` of the given block indices."""
    in0, in1 = plan["inner_shape"]
    off0, off1 = plan["offset"]
    _, nb1 = block_grid(plan["inner_shape"])
    b = torch.as_tensor(np.asarray(blocks, dtype=np.int64), device=device)
    r = torch.arange(BLOCK_ROWS, device=device)
    c = torch.arange(BLOCK_COLS, device=device)
    ii = (b // nb1)[:, None, None] * BLOCK_ROWS + r[None, :, None]
    jj = (b % nb1)[:, None, None] * BLOCK_COLS + c[None, None, :]
    ii, jj = torch.broadcast_tensors(ii, jj)
    weight = ((ii < in0) & (jj < in1)).to(torch.float64)
    ii = ii.clamp(max=in0 - 1).reshape(-1)
    jj = jj.clamp(max=in1 - 1).reshape(-1)
    return Cells(rows=ii + off0, cols=jj + off1, ii=ii, jj=jj,
                 weight=weight.reshape(-1))


# ---------------------------------------------------------------------------
# The sweep at a list of cells
# ---------------------------------------------------------------------------

def horizon_mode(plan, z_org, trig):
    """Per direction the row and column shifts and the candidates of the
    horizon sweep (the elevation ratio, ``_horizon_rows``)."""
    k = plan["consts"]
    eps = F32(1e-3)
    wins = ((k["step"], F32(0.0)), (k["two_step"], F32(0.0)),
            (k["two_step"], k["step"]))
    sh_i = (trig[:, 1] / F32(plan["dy"])).astype(F32)
    sh_j = (trig[:, 0] / F32(plan["dx"])).astype(F32)

    def point(he, s):
        return (he - z_org) * float(F32(1.0) / s)

    def quad(a_c, b_c, h0, s_start, win):
        length, t_lo = wins[win]
        ss = float(s_start)
        u = (a_c * ss - b_c) * ss + (h0 - z_org)
        g = sqrt_rn(torch.clamp_min(a_c * u, 0.0))
        g = torch.where(a_c >= 0.0, g, -g)
        r_int = b_c - 2.0 * a_c * ss + 2.0 * g
        lo = (s_start + t_lo) + eps
        hi = (s_start + length) - eps
        valid = (u - a_c * float(lo * lo)) * (u - a_c * float(hi * hi)) < 0.0
        return valid, r_int

    return sh_i, sh_j, point, quad


def ray_slopes(cells, z_org, table, plan, grid_origin):
    """(T, N) ray slopes of the cells toward each sun of ``table``."""
    dt = z_org.dtype
    xr = (cells.cols.to(dt) * float(F32(plan["dx"]))
          + float(F32(grid_origin[0])))
    yr = (cells.rows.to(dt) * float(F32(plan["dy"]))
          + float(F32(grid_origin[1])))
    t = torch.as_tensor(table, device=z_org.device).to(dt)
    sxr = t[:, 0:1] - xr
    syr = t[:, 1:2] - yr
    szr = t[:, 2:3] - z_org
    mag = sqrt_rn((sxr * sxr + syr * syr) + szr * szr)
    adv = (sxr * t[:, 3:4] + syr * t[:, 4:5]) / mag
    return (szr / mag) / torch.clamp_min(adv, float(F32(1.0e-4)))


def shadow_mode(plan, z_org, table, m):
    """Per sun the shifts and the clearance candidates (``_shadow_rows``);
    ``m``: the (T, N) ray slopes."""
    k = plan["consts"]
    wins = ((k["lo2_0"], k["hi2_step"]), (k["lo2_0"], k["hi2_two_step"]),
            (k["lo2_step"], k["hi2_two_step"]))

    def point(he, s):
        return (he - z_org) - m * float(s)

    def quad(a_c, b_c, h0, s_start, win):
        lo2, hi2 = wins[win]
        concave = a_c < NEG_TINY
        a_s = torch.where(concave, a_c, NEG_TINY)
        d = b_c - m
        valid = concave & ((d + a_c * float(lo2)) * (d + a_c * float(hi2))
                           < 0.0)
        cand = ((h0 - z_org) - m * float(s_start)) - ((d * 0.25) * d) / a_s
        return valid, cand

    return table[:, 5].astype(F32), table[:, 6].astype(F32), point, quad


def sweep_cells(cells, levels, plan, z_inner, mode, hook=None):
    """The running maxima (R, N) of the sweep of ``plan`` at ``cells`` for
    each of the R directions of ``mode`` (``(sh_i, sh_j, point, quad)`` of
    :func:`horizon_mode` or :func:`shadow_mode`), in the sections and
    chunks of ``sweep_plain``.  ``hook(ev)``: called before each d1 chunk,
    mip phase and mip chunk (``ev``: ``kind``, ``first``, ``n``, ``level``,
    ``masked``, ``acc``, ``h1``, ``v1``); it returns None or an (R, N) bool
    of the cells that skip the chunk, which keep their running value and
    re-read ``h1`` at the chunk's last sample."""
    sh_i, sh_j, point, quad = mode
    dev, dt = z_inner.device, z_inner.dtype
    k = plan["consts"]
    h, w = plan["outer_shape"]
    pads = plan["pads"]
    steps = plan["steps"]
    flat = [lv.reshape(-1) for lv in levels]
    w0 = levels[0].shape[1]
    rows, cols = cells.rows[None, :], cells.cols[None, :]
    n_dir = sh_i.shape[0]

    def col(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)[:, None]

    def read0(s):
        dif, djf = (s * sh_i).astype(F32), (s * sh_j).astype(F32)
        di, dj = np.floor(dif), np.floor(djf)
        fi, fj = (dif - di).astype(F32), (djf - dj).astype(F32)
        di_t, dj_t = col(di.astype(np.int64)), col(dj.astype(np.int64))
        idx = (rows + di_t + pads[0]) * w0 + (cols + dj_t + pads[0])
        lv = flat[0]
        gj = col((F32(1.0) - fj).astype(F32)).to(dt)
        fj_t = col(fj).to(dt)
        top = gj * lv[idx] + fj_t * lv[idx + 1]
        bot = gj * lv[idx + w0] + fj_t * lv[idx + w0 + 1]
        val = col((F32(1.0) - fi).astype(F32)).to(dt) * top \
            + col(fi).to(dt) * bot
        return val, di_t, dj_t

    def inside0(di, dj):
        return (((rows + di) >= 0) & ((rows + di + 1) <= h - 1)
                & ((cols + dj) >= 0) & ((cols + dj + 1) <= w - 1))

    def quad_update(acc, a_c, b_c, h0, s_start, win, extra):
        valid, cand = quad(a_c, b_c, h0, s_start, win)
        if extra is not None:
            valid = valid & extra
        return torch.maximum(acc, torch.where(valid, cand, NEG_INIT))

    def d2_step(m, acc, h1, masked):
        s_end = F32(m + 1) * k["step"]
        s_start = s_end - k["step"]
        hm, dim, djm = read0(s_end - k["half_step"])
        he, die, dje = read0(s_end)
        acc = torch.maximum(acc, point(he, s_end))
        a_c = (2.0 * he + 2.0 * h1 - 4.0 * hm) * float(k["inv_l0_sq"])
        b_c = (4.0 * hm - 3.0 * h1 - he) * float(k["inv_l0"])
        v_end = extra = None
        if masked:
            v_end = inside0(die, dje)
            extra = inside0(dim, djm) & v_end
        return quad_update(acc, a_c, b_c, h1, s_start, 0, extra), he, v_end

    def d1_pair(m, acc, h1, masked, v1=None):
        s_a = F32(m + 1) * k["step"]
        s_b = s_a + k["step"]
        h_a, dia, dja = read0(s_a)
        acc = torch.maximum(acc, point(h_a, s_a))
        h_b, dib, djb = read0(s_b)
        acc = torch.maximum(acc, point(h_b, s_b))
        a_c = (2.0 * h_b + 2.0 * h1 - 4.0 * h_a) * float(k["inv_l1_sq"])
        b_c = (4.0 * h_a - 3.0 * h1 - h_b) * float(k["inv_l1"])
        v_b = extra = None
        if masked:
            v_b = inside0(dib, djb)
            extra = v1 & inside0(dia, dja) & v_b
        return (quad_update(acc, a_c, b_c, h1, s_b - k["two_step"], 1, extra),
                h_b, v_b)

    def d1_single(m, acc, h2, h1, masked, v2=None, v1=None):
        s_end = F32(m + 1) * k["step"]
        he, die, dje = read0(s_end)
        acc = torch.maximum(acc, point(he, s_end))
        a_c = (2.0 * he + 2.0 * h2 - 4.0 * h1) * float(k["inv_l1_sq"])
        b_c = (4.0 * h1 - 3.0 * h2 - he) * float(k["inv_l1"])
        extra = v2 & v1 & inside0(die, dje) if masked else None
        return quad_update(acc, a_c, b_c, h2, s_end - k["two_step"], 2,
                           extra), he

    def chunk(ev, run, acc, carry=None):
        if hook is None:
            return run(acc, carry)
        h1, v1 = carry if isinstance(carry, tuple) else (carry, None)
        skip = hook(dict(ev, acc=acc, h1=h1, v1=v1))
        acc2, carry2 = run(acc, carry)
        if skip is None:
            return acc2, carry2
        acc2 = torch.where(skip, acc, acc2)
        if carry is not None:
            he, di, dj = read0(steps[ev["first"] + ev["n"] - 1, 0])
            if isinstance(carry, tuple):
                carry2 = (torch.where(skip, he, carry2[0]),
                          torch.where(skip, inside0(di, dj), carry2[1]))
            else:
                carry2 = torch.where(skip, he, carry2)
        return acc2, carry2

    z_in = z_inner[None, :].expand(n_dir, -1)
    acc = torch.full((n_dir, cells.n), NEG_INIT, dtype=dt, device=dev)
    h2 = h1 = z_in
    ones = torch.ones((n_dir, cells.n), dtype=torch.bool, device=dev)
    for m in range(plan["ns2"]):
        acc, he, _ = d2_step(m, acc, h1, False)
        h2, h1 = h1, he
    v2 = v1 = ones
    for m in range(plan["ns2"], plan["nx"]):
        acc, he, v_end = d2_step(m, acc, h1, True)
        h2, h1, v2, v1 = h1, he, v1, v_end
    nx, ns1, n_dense = plan["nx"], plan["ns1"], plan["n_dense"]
    if ns1 > nx:
        n_pairs = (ns1 - nx) // 2
        for q0 in range(0, n_pairs, D1_CHUNK_PAIRS):
            q1 = min(q0 + D1_CHUNK_PAIRS, n_pairs)

            def pairs(acc, h1, q0=q0, q1=q1):
                for q in range(q0, q1):
                    acc, h1, _ = d1_pair(nx + 2 * q, acc, h1, False)
                return acc, h1

            acc, h1 = chunk(dict(kind="d1", masked=False, first=nx + 2 * q0,
                                 n=2 * (q1 - q0), level=0), pairs, acc, h1)
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
                                       first=ns1 + 2 * q0, n=2 * (q1 - q0),
                                       level=0), mpairs, acc, (h1, v1))
        if n_pairs > 0 and (n_dense - ns1) % 2:
            h2, di, dj = read0(k["s_m1_masked"])
            v2 = inside0(di, dj)
        if (n_dense - ns1) % 2:
            acc, _ = d1_single(ns1 + 2 * n_pairs, acc, h2, h1, True, v2, v1)

    first = n_dense
    for lvl, n_m, s_first, step_l in plan["phases_meta"][1:]:
        kp = 2 ** lvl
        bias = kp * 16384
        lv, wl, pad = flat[lvl], levels[lvl].shape[1], pads[lvl]

        def samples(acc, m0, m1, kp=kp, bias=bias, lv=lv, wl=wl, pad=pad,
                    s_first=s_first, step_l=step_l):
            for m in range(m0, m1):
                s = np.minimum(F32(s_first) + F32(m) * F32(step_l),
                               k["dist"])
                ri = col(np.rint((s * sh_i).astype(F32)).astype(np.int64))
                rj = col(np.rint((s * sh_j).astype(F32)).astype(np.int64))
                r = torch.div(rows + (ri + bias), kp,
                              rounding_mode="floor") - bias // kp + pad
                c = torch.div(cols + (rj + bias), kp,
                              rounding_mode="floor") - bias // kp + pad
                acc = torch.maximum(acc, point(lv[r * wl + c], s))
            return acc

        def phase(acc, _, n_m=n_m, lvl=lvl, samples=samples, t0=first):
            for m0 in range(0, n_m, MIP_CHUNK):
                m1 = min(m0 + MIP_CHUNK, n_m)
                if m1 - m0 == n_m:
                    acc = samples(acc, m0, m1)
                    continue
                acc = chunk(dict(kind="mip", first=t0 + m0, n=m1 - m0,
                                 level=lvl, masked=False),
                            lambda a, _, m0=m0, m1=m1:
                            (samples(a, m0, m1), None), acc)[0]
            return acc, None

        acc = chunk(dict(kind="mip_phase", first=first, n=n_m, level=lvl,
                         masked=False), phase, acc)[0]
        first += n_m
    return acc


# ---------------------------------------------------------------------------
# The skip model and the count of the work the cells need
# ---------------------------------------------------------------------------

def warp_skip(ev, cells, plan, pool, pool_min0, z_org, sh, m=None,
              sign_exact=False):
    """The per-warp skip test of K1 (``m`` None) or K2 (``m`` the (R, N)
    ray slopes; ``sign_exact`` its sign-exact arm) at a chunk event of
    :func:`sweep_cells`: (R, N) bool, whether each cell's warp skips."""
    dev = z_org.device
    tab = plan["steps"]
    first, n, lvl = ev["first"], ev["n"], ev["level"]
    sh_i, sh_j = sh
    acc = ev["acc"]
    shadow = m is not None
    n_dir = acc.shape[0]
    wrow = cells.rows.view(-1, BLOCK_COLS)[:, 0]
    wb0 = cells.cols.view(-1, BLOCK_COLS)[:, 0]
    wb1 = cells.cols.view(-1, BLOCK_COLS)[:, -1]
    pad = plan["pads"][lvl]
    pl = pool[lvl]

    def box(r, q0, q1, pm, minimum=False):
        """Max (min) of the pooled cells over padded rows ``r`` and columns
        [q0, q1], each (k, R, warps): (k, R, warps)."""
        p0, p1 = q0 >> 3, q1 >> 3
        width = int((p1 - p0).max()) + 1
        idx = torch.minimum(p0[..., None] + torch.arange(width, device=dev),
                            p1[..., None])
        vals = pm[(r >> 3)[..., None], idx]
        return vals.amin(dim=-1) if minimum else vals.amax(dim=-1)

    def wmin(x):
        return x.view(*x.shape[:-1], -1, BLOCK_COLS).amin(dim=-1)

    def lanes(x):
        return x.repeat_interleave(BLOCK_COLS, dim=-1)

    def kr(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)[..., None]

    z_min = wmin(z_org)
    s = tab[first:first + n, 0]
    if ev["kind"] == "d1":
        di = kr(np.floor((s[:, None] * sh_i[None, :]).astype(F32))
                .astype(np.int64))
        dj = kr(np.floor((s[:, None] * sh_j[None, :]).astype(F32))
                .astype(np.int64))
        r = wrow + di + pad
        r = torch.cat([r, r + 1])
        q0 = (wb0 + dj + pad).repeat(2, 1, 1)
        q1 = (wb1 + dj + 1 + pad).repeat(2, 1, 1)
        d = box(r, q0, q1, pl).amax(dim=0)
        lo = box(r, q0, q1, pool_min0, True).amin(dim=0)
    else:
        ri = kr(np.rint((s[:, None] * sh_i[None, :]).astype(F32))
                .astype(np.int64))
        rj = kr(np.rint((s[:, None] * sh_j[None, :]).astype(F32))
                .astype(np.int64))
        d_k = box(((wrow + ri) >> lvl) + pad, ((wb0 + rj) >> lvl) + pad,
                  ((wb1 + rj) >> lvl) + pad, pl)
        d = d_k.amax(dim=0)
        lo = torch.full_like(d, POS_INIT)
        s_k = torch.as_tensor(s, device=dev)[:, None, None]
        if shadow:
            b_k = ((d_k - z_min) - s_k * wmin(m)).amax(dim=0)
        else:
            inv_k = torch.as_tensor(tab[first:first + n, 1],
                                    device=dev)[:, None, None]
            b_k = ((d_k - z_min) * inv_k).amax(dim=0)
    d, lo = lanes(d), lanes(lo)
    e_lo = tab[first - 1 if ev["kind"] == "d1" else first]
    e_hi = tab[first + n - 1]
    if ev["kind"] == "d1" and shadow:
        own = (ev["v1"] if ev["masked"]
               else torch.ones_like(d, dtype=torch.bool))
        d = torch.where(own, torch.maximum(d, ev["h1"]), d)
        lol = torch.where(own, torch.minimum(lo, ev["h1"]), lo)
        dp = d + d.abs() * float(D1_REL)
        lw = torch.minimum(lol, dp)
        gap = dp - lw
        hp = dp + 0.125 * gap
        sm_lo = float(e_lo[0]) * m
        sm_hi = float(e_hi[0]) * m
        slack = ((((gap + dp.abs()) + lw.abs()) + z_org.abs())
                 + torch.maximum(sm_lo.abs(), sm_hi.abs())) * float(D1_SLACK)
        bound = ((hp - z_org) - torch.minimum(sm_lo, sm_hi)) + slack
        if first < 1:
            bound = torch.full_like(bound, float("inf"))
    elif ev["kind"] == "d1":
        h1 = ev["h1"]
        d = torch.maximum(d, h1)
        lol = torch.minimum(lo, h1)
        dp = d + d.abs() * float(D1_REL)
        x = (dp + 0.125 * (dp - lol)) - z_org
        r = float(F32(e_hi[0] * plan["consts"]["inv_l0"]))
        slack = (float(D1_SLACK) * (((((dp - lol) * r) * r + dp.abs())
                                     + lol.abs()) + z_org.abs())
                 ) * float(e_lo[1])
        bound = x * torch.where(x >= 0.0, float(e_lo[1]),
                                float(e_hi[1])) + slack
        if first < 1:
            bound = torch.full_like(bound, float("inf"))
    elif shadow:
        bound = torch.minimum(
            (d - z_org) - torch.minimum(float(e_lo[0]) * m,
                                        float(e_hi[0]) * m), lanes(b_k))
    else:
        x = d - z_org
        bound = torch.minimum(
            x * torch.where(x >= 0.0, float(e_lo[1]), float(e_hi[1])),
            lanes(b_k))
    vote = bound <= acc
    if sign_exact:
        vote = vote | (bound <= 0.0) | (acc > 0.0)
    return lanes(vote.view(n_dir, -1, BLOCK_COLS).all(dim=-1))


class SkipCount:
    """The hook of :func:`sweep_cells` that applies the kernels' skips and
    counts, weighted by ``cells.weight``, the (cell, direction) samples
    taken and skipped and the skip tests made (the d1 chunks tested, the
    mip phases, the mip chunks inside a phase that runs)."""

    def __init__(self, cells, plan, pool, pool_min0, z_org, sh, m=None,
                 sign_exact=False):
        self.args = (cells, plan, pool, pool_min0, z_org, sh, m, sign_exact)
        self.w = cells.weight[None, :]
        self.shadow = m is not None
        self.n = dict(d1_taken=0.0, d1_skipped=0.0, d1_chunks_skipped=0.0,
                      mip_taken=0.0, mip_skipped=0.0, d1_tests=0.0,
                      mip_phase_tests=0.0, mip_chunk_tests=0.0,
                      mip_chunk_slots=0.0)
        self.phase_live = None

    def _sum(self, x):
        return float((x.to(torch.float64) * self.w).sum())

    def __call__(self, ev):
        kind, n = ev["kind"], ev["n"]
        if kind == "d1" and (ev["masked"] and not self.shadow):
            return None     # K1 takes no skip over the masked pairs
        cells, plan, pool, pmin, z_org, sh, m, sign = self.args
        skip = warp_skip(ev, cells, plan, pool, pmin, z_org, sh, m, sign)
        every = torch.ones_like(skip)
        if kind == "d1":
            self.n["d1_tests"] += self._sum(every) if ev["first"] >= 1 else 0
            self.n["d1_skipped"] += n * self._sum(skip)
            self.n["d1_taken"] += n * self._sum(~skip)
            self.n["d1_chunks_skipped"] += self._sum(skip)
        elif kind == "mip_phase":
            self.phase_live = ~skip
            self.n["mip_phase_tests"] += self._sum(every)
            self.n["mip_chunk_slots"] += n * self._sum(every)
            self.n["mip_skipped"] += n * self._sum(skip)
            if n <= MIP_CHUNK:
                self.n["mip_taken"] += n * self._sum(~skip)
        else:
            live = self.phase_live
            self.n["mip_chunk_tests"] += self._sum(live)
            self.n["mip_chunk_slots"] += n * self._sum(live)
            self.n["mip_taken"] += n * self._sum(live & ~skip)
            self.n["mip_skipped"] += n * self._sum(live & skip)
        return skip
