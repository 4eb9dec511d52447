# Copyright (c) 2026
# MIT License
"""Vertex-buffer construction (copy of :mod:`horayzon_tpu.auxiliary`).

Copied rather than imported: importing anything from ``horayzon_tpu`` runs
its package ``__init__``, which imports JAX, and this package never loads
JAX.  ``tests/test_torch_schedule.py`` holds the copies equal to the
originals.
"""

import numpy as np


def rearrange_pad_buffer(x, y, z):
    """Interleave x/y/z into a flat float32 buffer and pad (auxiliary.py:49).

    Parameters
    ----------
    x, y, z : ndarray of float32, shape (H, W)

    Returns
    -------
    buffer : ndarray of float32, one-dimensional
    """
    if (not isinstance(x, np.ndarray) or not isinstance(y, np.ndarray)
            or not isinstance(z, np.ndarray)):
        raise TypeError("One or more input arguments are of invalid type")
    if ((x.dtype != np.float32) or (y.dtype != np.float32)
            or (z.dtype != np.float32)):
        raise TypeError("Not all input arguments are 32-bit floats")
    if (any(i.ndim != 2 for i in (x, y, z))
            or not x.shape == y.shape == z.shape):
        raise ValueError("Dimensions of input arguments are "
                         "erroneous/inconsistent")
    buffer = np.stack([x.ravel(), y.ravel(), z.ravel()], axis=1).ravel()
    return pad_buffer(np.ascontiguousarray(buffer))


def pad_buffer(buffer):
    """Pad a flat geometry buffer to a 16-byte multiple (auxiliary.py:100)."""
    if not isinstance(buffer, np.ndarray):
        raise ValueError("argument 'buffer' has invalid type")
    if buffer.ndim != 1:
        raise ValueError("argument 'buffer' must be one-dimensional")
    add_elem = 16
    if not (buffer.nbytes % 16) == 0:
        add_elem += ((16 - (buffer.nbytes % 16)) // buffer.itemsize)
    return np.append(buffer, np.zeros(add_elem, dtype=buffer.dtype))
