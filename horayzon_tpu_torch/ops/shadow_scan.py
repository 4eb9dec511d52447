# Copyright (c) 2026
# MIT License
"""Log-doubling shadow scan in plain torch: terrain occlusion in O(log N)
whole-grid passes.

Counterpart of :mod:`horayzon_tpu.ops.shadow_scan`, which the reference
runs in XLA (``Terrain(engine="scan")``).  The occlusion test is, per
cell, the maximum over the ray of ``h(q + k D u) - m k D``, which is
associative under concatenation of ray segments:

    S_2L(q) = max(S_L(q), S_L(q + L D u) - m L D)

so the suffix-max field comes from ``ceil(log2 K)`` shifted-max passes
(one bilinear whole-grid shift, a subtraction and a maximum each) with
the domain-mean ray slope ``m``.  The fields live on the grid padded by
the search distance.  Every float32 operation is done in the reference's
order on the device of the heightfield; the shifts are formed on the
host in float32, as XLA forms them.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from horayzon_tpu_torch.ops import mip as _mip

_F32 = np.float32
_NEG = float(_F32(-3.0e37))


def _shifted(field, dist_m, ui, uj, pad):
    """``field(q + dist * u)`` for every q by one bilinear whole-grid
    shift; reads beyond the field take the sentinel ``-3e37``."""
    h, w = field.shape
    di, dj = _F32(dist_m) * ui, _F32(dist_m) * uj
    fi0, fj0 = np.floor(di), np.floor(dj)
    fi, fj = di - fi0, dj - fj0
    big = F.pad(field, (pad + 1,) * 4, value=_NEG)
    hb, wb = big.shape
    i0 = int(np.clip(int(fi0) + pad + 1, 0, hb - (h + 1)))
    j0 = int(np.clip(int(fj0) + pad + 1, 0, wb - (w + 1)))
    win = big[i0:i0 + h + 1, j0:j0 + w + 1]
    wj0, wj1 = float(_F32(1.0) - fj), float(fj)
    top = wj0 * win[:-1, :-1] + wj1 * win[:-1, 1:]
    bot = wj0 * win[1:, :-1] + wj1 * win[1:, 1:]
    return float(_F32(1.0) - fi) * top + float(fi) * bot


def shadow_scan_core(z_outer, z_org, m_slope_mean, u_cells, step, *,
                     num_doublings, pad, offset, inner_shape):
    """Occlusion metric ``S(q) - z_org(q)`` of the inner cells from the
    log-doubling suffix max (``horayzon_tpu.ops.shadow_scan.
    _shadow_scan_core``).  ``m_slope_mean``: the float32 domain-mean ray
    slope; ``u_cells``: float32 (ui, uj) in cells per metre; ``step``
    [metre].  Returns (in0, in1) float32, > 0 where occluded."""
    zp = F.pad(z_outer.to(torch.float32), (pad,) * 4, value=_mip.PAD_VALUE)
    ui, uj = _F32(u_cells[0]), _F32(u_cells[1])
    m = _F32(m_slope_mean)
    step = _F32(step)
    s_field = _shifted(zp, step, ui, uj, pad) - float(m * step)
    for j in range(num_doublings):
        dist = step * _F32(2.0 ** j)
        s_field = torch.maximum(
            s_field, _shifted(s_field, dist, ui, uj, pad) - float(m * dist))
    (off0, off1), (in0, in1) = offset, inner_shape
    inner = s_field[off0 + pad:off0 + pad + in0, off1 + pad:off1 + pad + in1]
    return inner - z_org


def scan_meta(diag, step):
    """``(num_doublings, pad, step)`` of a ray of ``diag`` metres on a
    grid of ``step`` metres (``horayzon_tpu/shadow.py:367-370``)."""
    k_cells = max(1, int(math.ceil(diag / step)))
    return (max(0, int(math.ceil(math.log2(k_cells)))), k_cells + 2,
            float(step))


def shadow_scan_metric(z_outer, z_org, m_slope_mean, u_cells, step,
                       max_dist, offset, inner_shape):
    """Occlusion metric via the log-doubling scan (positive -> occluded),
    ``horayzon_tpu.ops.shadow_scan.shadow_scan_metric``: ``max_dist``
    [metre] bounds the ray."""
    k = max(1, int(math.ceil(max_dist / step)))
    num_doublings = max(0, int(math.ceil(math.log2(k))))
    pad = int(math.ceil(max_dist / step)) + 2
    return shadow_scan_core(
        torch.as_tensor(z_outer), z_org, m_slope_mean,
        np.asarray(u_cells, dtype=np.float32), float(step),
        num_doublings=num_doublings, pad=pad,
        offset=(int(offset[0]), int(offset[1])),
        inner_shape=tuple(inner_shape))
