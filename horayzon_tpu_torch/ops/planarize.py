# Copyright (c) 2026
# MIT License
"""The planarisation of a curved ENU mesh on the pipeline's device.

:func:`planarize` is :func:`horayzon_tpu_torch.regrid.planarize` with the
lattice's fields as tensors on ``device``:

* on the CPU, ``regrid.planarize`` itself (its plain version: NumPy
  float64 on the host), its arrays wrapped as tensors;
* on a CUDA device, the kernel ``csrc/planarize.cu``, one thread per
  lattice cell, which repeats ``regrid``'s float64 operations in its order
  and so gives the same ``fi``, ``fj`` and ``z`` bit for bit.

The host keeps the scalar work of a CUDA call, as ``regrid`` computes it:
the spacing (the least positive step along either axis), the extents, the
lattice's shape and row direction (reduced on the card from the uploaded
mesh, one read-back of eight numbers), and the global affine seed's least
squares on a 64 x 64 subsample (NumPy, from the host mesh).  Then one
launch; nothing waits for it.
"""

import ctypes
import math

import numpy as np
import torch

from horayzon_tpu_torch import regrid as _regrid
from horayzon_tpu_torch.ops import _build
from horayzon_tpu_torch.terrain import GridSpec

#: Newton steps of ``regrid.invert_mapping``'s default.
NUM_ITER = 8
#: Lattice rows a CUDA grid can hold (65,535 blocks of 8 rows).
MAX_LATTICE_ROWS = 65535 * 8

#: Launches of the planarisation kernel made by this process (incremented
#: only where the wrapper launches it).
KERNEL_LAUNCHES = 0


def affine_seed(x, y):
    """``regrid.invert_mapping``'s global affine seed of the mesh ``x``,
    ``y`` (H, W): the least-squares fit ``[x; y] ~= A [j; i] + b`` over a
    subsample of at most about 64 x 64 vertices, in NumPy float64 as
    ``invert_mapping`` computes it.  Returns ``(A^-1, b)``, (2, 2) and
    (2,) float64."""
    h, w = x.shape
    step_i = max(1, h // 64)
    step_j = max(1, w // 64)
    ii, jj = np.mgrid[0:h:step_i, 0:w:step_j]
    ones = np.ones(ii.size)
    m = np.stack([jj.ravel(), ii.ravel(), ones], axis=1)
    x_sub = np.asarray(x[::step_i, ::step_j], dtype=np.float64)
    y_sub = np.asarray(y[::step_i, ::step_j], dtype=np.float64)
    cx, *_ = np.linalg.lstsq(m, x_sub.ravel(), rcond=None)
    cy, *_ = np.linalg.lstsq(m, y_sub.ravel(), rcond=None)
    a_mat = np.array([[cx[0], cx[1]], [cy[0], cy[1]]])
    b_vec = np.array([cx[2], cy[2]])
    return np.linalg.inv(a_mat), b_vec


class _PlParams(ctypes.Structure):
    """Mirror of ``struct PlParams`` in csrc/planarize.cu."""
    _fields_ = (
        [(n, ctypes.c_void_p)
         for n in ("x", "y", "z", "fi", "fj", "z_out", "valid")]
        + [(n, ctypes.c_double)
           for n in ("x0", "y_start", "spacing", "a00", "a01", "a10", "a11",
                     "b0", "b1")]
        + [(n, ctypes.c_int)
           for n in ("h", "w", "hr", "wr", "y_desc", "num_iter")])


def _kernel_lib():
    """The loaded library of the planarisation kernel (built with nvcc on
    first use)."""
    lib = _build.load("planarize")
    lib.planarize_launch.argtypes = [ctypes.POINTER(_PlParams), ctypes.c_int,
                                     ctypes.c_void_p]
    lib.planarize_launch.restype = ctypes.c_int
    lib.planarize_error_string.argtypes = [ctypes.c_int]
    lib.planarize_error_string.restype = ctypes.c_char_p
    lib.planarize_params_size.argtypes = []
    lib.planarize_params_size.restype = ctypes.c_int
    size = lib.planarize_params_size()
    if size != ctypes.sizeof(_PlParams):
        raise RuntimeError(f"PlParams is {size} bytes in the kernel but "
                           f"{ctypes.sizeof(_PlParams)} in _PlParams")
    return lib


def _min_positive(d):
    """The least positive value of ``d`` as a 0-dim tensor (inf if none)."""
    return torch.where(d > 0, d, math.inf).min()


def _prepare(x, y, z, target_spacing, dev):
    """The host part of a CUDA planarisation: the mesh uploaded, the
    lattice and the seed computed, the outputs allocated.  Returns
    ``(params, mesh, pg)``: the kernel's parameter block, the uploaded
    (3, H, W) float64 mesh it points into (to be kept alive until the
    launch) and the :class:`~horayzon_tpu_torch.regrid.PlanarizedGrid`
    whose fields the launch fills."""
    x, y, z = (np.asarray(a) for a in (x, y, z))
    if x.shape != y.shape or y.shape != z.shape:
        raise ValueError("Inconsistent shapes of input arrays")
    if x.ndim != 2 or min(x.shape) < 2:
        raise ValueError("the mesh must be 2-D with at least 2 x 2 vertices")
    h, w = x.shape
    # one host copy and one upload; float32 -> float64 on the card is exact
    mesh = np.stack([x, y, z])
    if mesh.dtype != np.float32:
        mesh = mesh.astype(np.float64, copy=False)
    mesh = torch.from_numpy(mesh).to(dev).double()
    x_d, y_d, z_d = mesh
    stats = [x_d.min(), x_d.max(), y_d.min(), y_d.max(), y_d[-1, 0],
             y_d[0, 0]]
    if target_spacing is None:
        stats += [_min_positive((x_d[:, 1:] - x_d[:, :-1]).abs()),
                  _min_positive((y_d[1:, :] - y_d[:-1, :]).abs())]
    vals = torch.stack(stats).tolist()
    x0, x1, y_lo, y_hi, y_last, y_first = vals[:6]
    if target_spacing is None:
        target_spacing = float(min(vals[6:]))
        if not math.isfinite(target_spacing):
            raise ValueError("the mesh has no positive step along an axis")
    # regrid.planarize's lattice, expression for expression
    y_desc = y_last < y_first
    wr = int(np.floor((x1 - x0) / target_spacing)) + 1
    hr = int(np.floor((y_hi - y_lo) / target_spacing)) + 1
    if hr > MAX_LATTICE_ROWS:
        raise ValueError(f"a lattice of {hr} rows exceeds the kernel's "
                         f"{MAX_LATTICE_ROWS}")
    if y_desc:
        dy, y_start = -target_spacing, y_hi
    else:
        dy, y_start = target_spacing, y_lo
    a_inv, b_vec = affine_seed(x, y)

    fi = torch.empty((hr, wr), dtype=torch.float64, device=dev)
    fj = torch.empty_like(fi)
    z_out = torch.empty((hr, wr), dtype=torch.float32, device=dev)
    valid = torch.empty((hr, wr), dtype=torch.uint8, device=dev)
    prm = _PlParams()
    prm.x, prm.y, prm.z = x_d.data_ptr(), y_d.data_ptr(), z_d.data_ptr()
    prm.fi, prm.fj = fi.data_ptr(), fj.data_ptr()
    prm.z_out, prm.valid = z_out.data_ptr(), valid.data_ptr()
    prm.x0, prm.y_start, prm.spacing = x0, y_start, float(target_spacing)
    (prm.a00, prm.a01), (prm.a10, prm.a11) = a_inv.tolist()
    prm.b0, prm.b1 = b_vec.tolist()
    prm.h, prm.w, prm.hr, prm.wr = h, w, hr, wr
    prm.y_desc, prm.num_iter = int(y_desc), NUM_ITER
    grid = GridSpec(x0=x0, y0=y_start, dx=target_spacing, dy=dy,
                    shape=(hr, wr))
    pg = _regrid.PlanarizedGrid(grid=grid, z=z_out,
                                valid=valid.view(torch.bool), fi=fi, fj=fj)
    return prm, mesh, pg


def _launch(prm, dev):
    """One launch of the kernel on ``prm`` (from :func:`_prepare`) on
    ``dev``'s current stream; raises if the launch fails."""
    global KERNEL_LAUNCHES
    lib = _kernel_lib()
    err = lib.planarize_launch(
        ctypes.byref(prm),
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        msg = lib.planarize_error_string(err).decode()
        raise RuntimeError(f"planarize kernel launch failed: {msg}")
    KERNEL_LAUNCHES += 1


def planarize(x, y, z, target_spacing=None, *, device="cuda"):
    """:func:`horayzon_tpu_torch.regrid.planarize` of the ENU mesh ``x``,
    ``y``, ``z`` (H, W arrays) on ``device``: a
    :class:`~horayzon_tpu_torch.regrid.PlanarizedGrid` whose ``z``
    (float32), ``valid`` (bool), ``fi`` and ``fj`` (float64) are (Hr, Wr)
    tensors on ``device``: ``z``, ``fi`` and ``fj`` bit-equal to
    ``regrid.planarize``'s arrays, its ``grid`` equal, and ``valid`` equal
    except at a cell whose error lies within an ulp of 1 m, where the
    card's ``hypot`` may round its last bit otherwise than the C library's
    and so decide ``err < 1`` the other way.  A CUDA device runs the
    kernel (built with nvcc on first use; a failed build or launch
    raises), the CPU ``regrid.planarize``."""
    dev = torch.device(device)
    if dev.type == "cpu":
        pg = _regrid.planarize(x, y, z, target_spacing)
        return _regrid.PlanarizedGrid(
            grid=pg.grid, z=torch.from_numpy(pg.z),
            valid=torch.from_numpy(pg.valid), fi=torch.from_numpy(pg.fi),
            fj=torch.from_numpy(pg.fj))
    if dev.type != "cuda":
        raise ValueError(f"no planarisation for device {dev}")
    prm, _, pg = _prepare(x, y, z, target_spacing, dev)
    _launch(prm, dev)
    return pg


def bilinear(a, fi, fj):
    """``regrid._bilinear`` in torch on ``a``'s device: ``a`` (h, w) or
    (h, w, c) float64 read at fractional indices ``fi``, ``fj`` (float64
    tensors of one shape), its float64 operations in its order (bit-equal
    to it on the same values)."""
    h, w = a.shape[:2]
    i0 = fi.floor().long().clamp(0, h - 2)
    j0 = fj.floor().long().clamp(0, w - 2)
    wi = (fi - i0).clamp(0.0, 1.0)
    wj = (fj - j0).clamp(0.0, 1.0)
    if a.dim() == 3:
        wi, wj = wi[..., None], wj[..., None]
    return ((1 - wi) * (1 - wj) * a[i0, j0]
            + (1 - wi) * wj * a[i0, j0 + 1]
            + wi * (1 - wj) * a[i0 + 1, j0]
            + wi * wj * a[i0 + 1, j0 + 1])
