# Copyright (c) 2026
# MIT License
"""The far field of a simplified outer TIN on a CUDA device.

:func:`coarse_grid` is :func:`horayzon_tpu_torch.ops.multires.
coarse_grid_from_tin` with the coarse grid built on the card by the kernel
``csrc/tin_raster.cu`` (R1) and returned there as a float32 tensor, bit for
bit the copy's array.  The copy stays the CPU route; R1 is the card's.

The host keeps the scalar work, in ``coarse_grid_from_tin``'s own
expressions (:func:`lattice`): the pad in coarse cells, the coarse shape,
the fine grid's offset in it, the corner, the raster's points per coarse
cell with its cap, the raster's and the coarse lattice's spacings.  It
checks what the kernel cannot take, uploads the float32 vertices and the
int32 indices, fills the coarse grid with the pad value and launches R1 and
the fine overlay on the current stream; nothing waits for them.
"""

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from horayzon_tpu_torch.ops import _build
from horayzon_tpu_torch.ops import mip as _mip

#: The most raster points (rows x columns) ``coarse_grid_from_tin`` lets
#: a coarse lattice have before it halves the points a coarse cell.
MAX_RASTER_POINTS = 2 * 10 ** 8
#: Largest raster row or column index, number of triangles, and pooled
#: rows (65,535 blocks of 8) the kernel's integers and grid can hold.
MAX_INDEX = 2 ** 31 - 1
MAX_POOLED_ROWS = 65535 * 8

#: Launches of R1 made by this process (incremented only where the wrapper
#: launches it).
KERNEL_LAUNCHES = 0


class Lattice(NamedTuple):
    """The scalars of a coarse far field, as ``coarse_grid_from_tin``
    computes them: ``r`` fine cells a coarse cell; ``pad_c`` coarse cells
    of search distance on each side; the coarse shape ``n_i`` x ``n_j``;
    ``offset``, fine cell (0, 0) in fine cells of the coarse lattice; the
    ``corner`` (x, y) of raster point and coarse cell (0, 0); ``sub``
    raster points a coarse cell along an axis; the raster's ``spacing``
    (sx, sy) and the coarse lattice's ``coarse_spacing`` (cx, cy), sy and
    cy signed like ``dy``.  Floats are Python floats."""
    r: int
    pad_c: int
    n_i: int
    n_j: int
    offset: tuple
    corner: tuple
    sub: int
    spacing: tuple
    coarse_spacing: tuple


def lattice(grid, fine_shape, ratio_log2, dist_search):
    """The :class:`Lattice` of ``coarse_grid_from_tin(..., grid=grid,
    fine_shape=fine_shape, ratio_log2=ratio_log2,
    dist_search=dist_search)``, each value from its expression there."""
    r = 2 ** ratio_log2
    hf, wf = fine_shape
    pad_c = int(math.ceil(dist_search / (abs(grid.dx) * r))) + 2
    n_i = (hf + r - 1) // r + 2 * pad_c
    n_j = (wf + r - 1) // r + 2 * pad_c
    oi = oj = pad_c * r
    corner = (grid.x0 - oj * grid.dx, grid.y0 - oi * grid.dy)
    sub = min(r, 4)
    while sub > 1 and (n_i * sub) * (n_j * sub) > MAX_RASTER_POINTS:
        sub //= 2
    return Lattice(
        r=r, pad_c=pad_c, n_i=n_i, n_j=n_j, offset=(oi, oj),
        corner=(float(corner[0]), float(corner[1])), sub=sub,
        spacing=(float(grid.dx * r / sub), float(grid.dy * r / sub)),
        coarse_spacing=(float(grid.dx * r), float(grid.dy * r)))


class _TrParams(ctypes.Structure):
    """Mirror of ``struct TrParams`` in csrc/tin_raster.cu."""
    _fields_ = (
        [(n, ctypes.c_void_p) for n in ("verts", "tris", "z_fine",
                                        "z_coarse")]
        + [(n, ctypes.c_double) for n in ("x0", "y0", "sx", "sy", "cx",
                                          "cy")]
        + [(n, ctypes.c_int) for n in ("n_tri", "n_i", "n_j", "sub", "r",
                                       "hf", "wf", "ci", "cj")])


def _kernel_lib():
    """The loaded library of R1 (built with nvcc on first use)."""
    lib = _build.load("tin_raster")
    lib.tin_raster_launch.argtypes = [ctypes.POINTER(_TrParams),
                                      ctypes.c_int, ctypes.c_void_p]
    lib.tin_raster_launch.restype = ctypes.c_int
    lib.tin_raster_error_string.argtypes = [ctypes.c_int]
    lib.tin_raster_error_string.restype = ctypes.c_char_p
    lib.tin_raster_params_size.argtypes = []
    lib.tin_raster_params_size.restype = ctypes.c_int
    size = lib.tin_raster_params_size()
    if size != ctypes.sizeof(_TrParams):
        raise RuntimeError(f"TrParams is {size} bytes in the kernel but "
                           f"{ctypes.sizeof(_TrParams)} in _TrParams")
    return lib


def host_inputs(vert_simp, tri_ind_simp, lat, fine_shape):
    """The vertices as (n_vert, 3) float32 and the indices as (n_tri, 3)
    int32 NumPy arrays, after the checks of what R1 cannot take, each a
    ``ValueError``: a flat list not in threes, an index outside the
    vertices (the copy would wrap a negative one), a vertex of a triangle
    that is not finite (the copy raises for its x and y and spreads a NaN
    height), a lattice or fine grid too large for the kernel's
    integers."""
    verts = np.asarray(vert_simp, dtype=np.float32)
    tris = np.asarray(tri_ind_simp)
    if verts.size % 3 or tris.size % 3:
        raise ValueError("vert_simp and tri_ind_simp must hold whole "
                         "triples")
    verts = verts.reshape(-1, 3)
    tris = tris.reshape(-1, 3)
    if tris.size and not np.issubdtype(tris.dtype, np.integer):
        raise ValueError("tri_ind_simp must hold integer indices")
    if tris.size and (tris.min() < 0 or tris.max() >= len(verts)):
        raise ValueError(f"tri_ind_simp holds indices outside the "
                         f"{len(verts)} vertices")
    if not np.isfinite(verts).all() and tris.size and not np.isfinite(
            verts[np.unique(tris)]).all():
        raise ValueError("a vertex of the TIN is not finite")
    if (max(lat.n_i, lat.n_j) * lat.sub > MAX_INDEX
            or len(tris) > MAX_INDEX
            or fine_shape[0] // lat.r > MAX_POOLED_ROWS):
        raise ValueError("the TIN's lattice or the fine grid is too large "
                         "for the kernel")
    return np.ascontiguousarray(verts), np.ascontiguousarray(tris,
                                                              dtype=np.int32)


def _prepare(vert_simp, tri_ind_simp, grid, fine_shape, z_fine, ratio_log2,
             dist_search):
    """The host part of :func:`coarse_grid`: the scalars, the checks, the
    uploads and the coarse grid filled with the pad value.  Returns
    ``(params, keep, z_coarse, lat)``: the kernel's parameter block, the
    uploaded tensors it points into (to be kept alive until the launch),
    the coarse grid the launch completes and the :class:`Lattice`."""
    dev = z_fine.device
    if dev.type != "cuda":
        raise ValueError(f"no TIN far field on the card for device {dev}: "
                         f"the CPU's is multires.coarse_grid_from_tin")
    if (tuple(z_fine.shape) != tuple(fine_shape)
            or z_fine.dtype != torch.float32 or z_fine.dim() != 2):
        raise ValueError("z_fine must be a float32 tensor of fine_shape")
    lat = lattice(grid, fine_shape, ratio_log2, dist_search)
    verts, tris = host_inputs(vert_simp, tri_ind_simp, lat, fine_shape)
    z_f = z_fine.detach().contiguous()
    verts_d = torch.from_numpy(verts).to(dev)
    tris_d = torch.from_numpy(tris).to(dev)
    z_coarse = torch.full((lat.n_i, lat.n_j), _mip.PAD_VALUE,
                          dtype=torch.float32, device=dev)
    prm = _TrParams()
    prm.verts, prm.tris = verts_d.data_ptr(), tris_d.data_ptr()
    prm.z_fine, prm.z_coarse = z_f.data_ptr(), z_coarse.data_ptr()
    prm.x0, prm.y0 = lat.corner
    prm.sx, prm.sy = lat.spacing
    prm.cx, prm.cy = lat.coarse_spacing
    prm.n_tri, prm.n_i, prm.n_j = len(tris), lat.n_i, lat.n_j
    prm.sub, prm.r = lat.sub, lat.r
    prm.hf, prm.wf = fine_shape
    prm.ci, prm.cj = lat.pad_c, lat.pad_c
    return prm, (verts_d, tris_d, z_f), z_coarse, lat


def _launch(prm, dev):
    """One launch of R1 and the overlay on ``prm`` (from :func:`_prepare`)
    on ``dev``'s current stream; raises if the launch fails."""
    global KERNEL_LAUNCHES
    lib = _kernel_lib()
    err = lib.tin_raster_launch(
        ctypes.byref(prm),
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        msg = lib.tin_raster_error_string(err).decode()
        raise RuntimeError(f"TIN raster kernel launch failed: {msg}")
    KERNEL_LAUNCHES += 1


def coarse_grid(vert_simp, tri_ind_simp, *, grid, fine_shape, z_fine,
                ratio_log2, dist_search):
    """``multires.coarse_grid_from_tin``'s far field on ``z_fine``'s CUDA
    device: ``(z_coarse, coarse_offset)``, ``z_coarse`` a float32 (Hc, Wc)
    tensor there, bit-equal to the copy's array, and the offset the
    copy's.  ``vert_simp``: flat float32 (x, y, z) vertices;
    ``tri_ind_simp``: flat vertex indices, 3 a triangle, every one
    rasterised and its vertices scattered; ``z_fine``: the (Hf, Wf)
    float32 fine grid on the card, read detached.  Another device, and
    what :func:`host_inputs` refuses, raise ``ValueError``; a failed build
    or launch ``RuntimeError``."""
    prm, _, z_coarse, lat = _prepare(vert_simp, tri_ind_simp, grid,
                                     fine_shape, z_fine, ratio_log2,
                                     dist_search)
    _launch(prm, z_fine.device)
    return z_coarse, lat.offset
