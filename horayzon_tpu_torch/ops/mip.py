# Copyright (c) 2026
# MIT License
"""Conservative max-mip pyramid over a heightfield (torch).

Counterpart of :mod:`horayzon_tpu.ops.mip`: level ``l`` stores the maximum
elevation over aligned ``2^l x 2^l`` blocks of the outer DEM, so one coarse
sample bounds the terrain over its whole footprint.  Out-of-domain padding
uses a large negative sentinel so off-grid samples never contribute to the
horizon.  A max is exact, so every level is bit-equal to the reference's.

The sweep reads the pyramid as *padded levels*: level ``l`` surrounded by
``pads[l]`` sentinel cells on every side (:func:`padded_levels`).  This is
the state the sweep carries; :func:`pyramid_from_jax` lays out the JAX
package's padded levels the same way.  :func:`padded_levels_vjp` carries a
gradient from the padded levels back to the heightfield.  :func:`pool8`
builds the 8 x 8 max-pooled companion of each padded level, which bounds
the heights behind the sweep kernel's skips, and :func:`pool8_floor` the
floor of level 0's in-domain heights behind its d1 skips.
"""

import numpy as np
import torch
import torch.nn.functional as F

# Safely below any terrestrial elevation; kept small in magnitude so that
# products with direction components stay finite in float32.
PAD_VALUE = -3.0e4

#: Sentinel margins (low, high rows, high cols) that the JAX package's
#: Pallas kernel adds around each padded level on top of the schedule pad
#: (``horayzon_tpu.ops.pallas_sweep.LEVEL_PAD_EXTRA``); cropped away by
#: :func:`pyramid_from_jax`.
JAX_LEVEL_PAD_EXTRA = (4, 56, 776)


def max_downsample2(z):
    """2x2 max-pool with sentinel padding to even dimensions."""
    h, w = z.shape
    ph, pw = h % 2, w % 2
    if ph or pw:
        z = F.pad(z, (0, pw, 0, ph), value=PAD_VALUE)
    r = torch.maximum(z[0::2, :], z[1::2, :])
    return torch.maximum(r[:, 0::2], r[:, 1::2])


def build_pyramid(z, num_levels):
    """Return [level0, ..., level_{num_levels-1}] (level0 is ``z`` itself)."""
    levels = [z]
    for _ in range(num_levels - 1):
        levels.append(max_downsample2(levels[-1]))
    return levels


def level_shapes(outer_shape, num_levels):
    """Unpadded (H, W) of each pyramid level of an ``outer_shape`` grid."""
    h, w = outer_shape
    shapes = [(h, w)]
    for _ in range(num_levels - 1):
        h, w = (h + 1) // 2, (w + 1) // 2
        shapes.append((h, w))
    return shapes


def padded_levels(z, pads):
    """Pyramid of ``z`` with ``pads[l]`` sentinel cells around level ``l``.

    Returns a list of contiguous float32 tensors on ``z``'s device."""
    levels = build_pyramid(z, len(pads))
    return [F.pad(lv, (p, p, p, p), value=PAD_VALUE).contiguous()
            for lv, p in zip(levels, pads)]


def pool8(levels):
    """8 x 8 max-pooled companion of each padded level: cell ``(P, Q)`` is
    the maximum of padded rows ``[8P, 8P + 8)`` and columns ``[8Q, 8Q + 8)``,
    the level first padded with :data:`PAD_VALUE` to multiples of 8.  The
    counterpart of ``horayzon_tpu.ops.pallas_sweep._pool8`` without its
    margins for the TPU's window copies (equal to it on the shared extent).
    The companions only bound the heights the kernel's skips pass over, so
    they are built without autograd.  Returns contiguous float32 tensors of
    ``(ceil(H / 8), ceil(W / 8))``."""
    pooled = []
    with torch.no_grad():
        for lv in levels:
            h, w = lv.shape
            h8, w8 = -(-h // 8), -(-w // 8)
            zp = F.pad(lv.to(torch.float32), (0, 8 * w8 - w, 0, 8 * h8 - h),
                       value=PAD_VALUE)
            blocks = zp.view(h8, 8, w8, 8)
            pooled.append(blocks.amax(dim=(1, 3)).contiguous())
    return pooled


def pool8_floor(level, pad):
    """8 x 8 min-pooled companion of the in-domain cells of a padded level
    (``pad`` sentinel cells on every side), in :func:`pool8`'s layout: the
    sentinel margin and the fill to multiples of 8 count as ``-PAD_VALUE``,
    above any height, so a pooled cell's value is the lowest in-domain
    height it holds (``-PAD_VALUE`` where it holds none).  The floor of a
    parabola whose samples all lie in the domain, for the d1 skips of both
    sweep modes."""
    with torch.no_grad():
        h, w = level.shape
        h8, w8 = -(-h // 8), -(-w // 8)
        zp = torch.full((8 * h8, 8 * w8), -PAD_VALUE, dtype=torch.float32,
                        device=level.device)
        zp[pad:h - pad, pad:w - pad] = level[pad:h - pad, pad:w - pad]
        return zp.view(h8, 8, w8, 8).amin(dim=(1, 3)).contiguous()


def padded_levels_vjp(z, pads, level_cots):
    """``dz``: the VJP of :func:`padded_levels` at ``z`` applied to
    ``level_cots`` (one cotangent per padded level).

    Torch autograd through the strided-slice maxima and the pads, the
    counterpart of ``jax.vjp`` of the JAX package's pyramid
    (``pallas_sweep.py:2377-2381``).  An exact tie of ``torch.maximum``
    sends half the cotangent to each side, as ``jnp.maximum``'s VJP does;
    every cell of ``dz`` sums at most two terms, so the order of the sums
    cannot differ from the reference's."""
    with torch.enable_grad():
        zz = z.detach().requires_grad_(True)
        (dz,) = torch.autograd.grad(padded_levels(zz, pads), zz,
                                    list(level_cots))
    return dz


def pyramid_from_jax(levels_np, pads, device):
    """Port-layout padded levels from the JAX package's padded levels.

    ``levels_np``: the arrays of
    ``horayzon_tpu.ops.pallas_sweep.build_padded_pyramid(...)[0]`` as numpy
    arrays, each padded by ``pads[l]`` plus :data:`JAX_LEVEL_PAD_EXTRA`.
    The extra margins are cropped, which leaves exactly the layout of
    :func:`padded_levels`, so the port's sweep can run on the reference's
    pyramid."""
    if len(levels_np) != len(pads):
        raise ValueError(f"{len(levels_np)} levels for {len(pads)} pads")
    lo, hi_r, hi_c = JAX_LEVEL_PAD_EXTRA
    out = []
    for lv in levels_np:
        lv = np.asarray(lv, dtype=np.float32)
        if lv.ndim != 2 or lv.shape[0] <= lo + hi_r or lv.shape[1] <= lo + hi_c:
            raise ValueError(f"level of shape {lv.shape} is not a padded "
                             f"level of the JAX layout")
        crop = np.ascontiguousarray(lv[lo:lv.shape[0] - hi_r,
                                       lo:lv.shape[1] - hi_c])
        out.append(torch.from_numpy(crop).to(device))
    return out


def combined_pyramid_from_jax(levels_np, pads, fine_shape, device):
    """Port-layout padded levels from the JAX package's *combined*
    fine + coarse pyramid.

    ``levels_np``: the arrays of ``horayzon_tpu.ops.multires.
    combined_pyramid(..., pad_extra=LEVEL_PAD_EXTRA)`` as numpy arrays for
    a fine grid of ``fine_shape``.  Each has ``pads[l]`` plus the low
    margin of :data:`JAX_LEVEL_PAD_EXTRA` before fine cell 0; a
    coarse-derived level may run past the high margins (the reference pads
    one only if it is short), so the crop is taken from the low side:
    ``ceil(hf / 2^l) + 2 * pads[l]`` rows and columns, the layout of
    :func:`padded_levels` and of
    :func:`horayzon_tpu_torch.ops.multires.combined_pyramid`."""
    if len(levels_np) != len(pads):
        raise ValueError(f"{len(levels_np)} levels for {len(pads)} pads")
    lo = JAX_LEVEL_PAD_EXTRA[0]
    out = []
    for lv, (hl, wl), p in zip(levels_np,
                               level_shapes(tuple(fine_shape), len(pads)),
                               pads):
        lv = np.asarray(lv, dtype=np.float32)
        rows, cols = hl + 2 * p, wl + 2 * p
        if lv.ndim != 2 or lv.shape[0] < lo + rows or lv.shape[1] < lo + cols:
            raise ValueError(f"level of shape {lv.shape} is too small for a "
                             f"padded level of {(rows, cols)} in the JAX "
                             f"layout")
        crop = np.ascontiguousarray(lv[lo:lo + rows, lo:lo + cols])
        out.append(torch.from_numpy(crop).to(device))
    return out
