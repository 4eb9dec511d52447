# Copyright (c) 2026
# MIT License
"""The read floor: a microbenchmark of the sweep's core primitive, the
counterpart of ``tools/read_floor.py`` (kernel K5).

The sweep kernels spend their time on shifted reads of a terrain window
with a little arithmetic per sample.  :func:`read_floor` computes that
primitive alone: for each of ``cells`` (n0, n1) window cells and each
direction of ``trig`` it marches ``n_steps`` steps of one cell, reads the
window at the shifted position and keeps the running max of ``he / s``.
Two implementations of identical arithmetic:

* kernel K5, ``csrc/read_floor.cu`` (CUDA C++ for ``sm_90a``, K1's launch
  geometry), run for a CUDA tensor; its source says how each mode is laid
  out on the card;
* :func:`read_floor_plain`, plain torch vectorised over the cells, run for
  a CPU tensor and used on the card as the kernel's reference.

Modes (:data:`MODES`): ``bilinear`` and ``nearest`` keep the arithmetic of
the TPU tool's body (``tools/read_floor.py:95-119``) operation by
operation; ``aligned`` is ``nearest`` with the column shift rounded up to a
multiple of 32 cells (a warp then reads one 128-byte line); ``stream`` is
``n_steps`` independent float4 reads per thread folded with max (the read
rate of L2 on a window inside it, of device memory on one many times its
size, a mix of both in between); ``alu`` is the TPU tool's ``vpu`` mode
(two multiply-add chains and a max merge, no reads); ``stage`` is the
shared-memory source's staging alone.  Sources (:data:`SOURCES`): ``l2``
reads the window in global memory as K1 does, ``smem`` stages each block's
strip in shared memory per chunk of ``chunk`` steps; both give the same
values.

:func:`work` counts what a call reads and computes, :func:`time_modes`
times calls on the card (the entry of ``tools/read_floor_torch.py``).
"""

import ctypes

import numpy as np
import torch

from horayzon_tpu_torch.ops import _build

MODES = ("bilinear", "nearest", "aligned", "stream", "alu", "stage")
SOURCES = ("l2", "smem")
#: Cells of one block: BLOCK_ROWS rows of BLOCK_COLS columns (kBlockRows,
#: kBlockCols of csrc/read_floor.cu; K1's block).
BLOCK_ROWS, BLOCK_COLS = 8, 32
#: Start of the running max (``tools/read_floor.py:122``).
INIT = -1.0e30
#: Shared memory one block can have on an H100 [bytes].
MAX_SMEM_BYTES = 232448
#: float32 operations per (cell, direction, step), counted from
#: csrc/read_floor.cu with a multiply, an add, a floor, a divide and a max
#: as one each: the shifts 2 multiplies + 2 floors, the weights 4
#: subtractions, the lerp 6 multiplies + 3 adds, then divide, multiply, max.
#: ``stream`` folds 4 values; ``alu`` is 1 add + 8 x (2 mul + 2 add + max).
OPS_PER_STEP = {"bilinear": 20, "nearest": 7, "aligned": 7, "stream": 4,
                "alu": 41, "stage": 0}

#: Launches of kernel K5 made by this process (incremented only where the
#: wrapper launches it).
KERNEL_LAUNCHES = 0


def first_quadrant_trig(a_num):
    """(a_num, 2) float32 (sin, cos) of ``a_num`` directions inside the
    first quadrant (``tools/read_floor.py:149-151``): every shift is
    non-negative, at most one cell per step."""
    az = 0.5 * np.pi * (np.arange(a_num) + 0.5) / a_num
    return np.stack([np.sin(az), np.cos(az)], -1).astype(np.float32)


def centre_offset(window_shape, cells):
    """The window position of cell (0, 0) that centres the cell block, as
    K1's inner block sits in its outer grid, rounded down to a multiple of
    32 columns (the ``aligned`` mode's condition)."""
    off0 = (window_shape[0] - cells[0]) // 2
    off1 = (window_shape[1] - cells[1]) // 2
    return max(off0, 0), max(off1 - off1 % BLOCK_COLS, 0)


def _shift(mode, s, sh):
    """``(d, f)``: the integer shift and float32 fraction of distance ``s``
    along one axis; ``mode`` "aligned" rounds the shift up to a multiple of
    32 (columns only)."""
    df = s * sh
    d = np.floor(df)
    di = int(d)
    if mode == "aligned":
        di = ((di + BLOCK_COLS) // BLOCK_COLS) * BLOCK_COLS
    return di, df - d


def _read_mode(mode):
    return "bilinear" if mode == "stage" else mode


def max_shifts(mode, trig, n_steps):
    """Largest row and column shift of any direction at the last step."""
    s = np.float32(n_steps)
    rd = _read_mode(mode)
    return (max(_shift("nearest", s, np.float32(t[0]))[0] for t in trig),
            max(_shift(rd, s, np.float32(t[1]))[0] for t in trig))


def strip_layout(mode, trig, n_steps, chunk):
    """``(rows, ld)``: the shared-memory strip that holds every chunk's box
    of every direction: the largest box height and width over (direction,
    chunk), computed with the kernel's float32 arithmetic."""
    rd = _read_mode(mode)
    extra = 1 if rd == "bilinear" else 0
    rows = cols = 0
    for t in trig:
        sh_i, sh_j = np.float32(t[0]), np.float32(t[1])
        for m0 in range(0, n_steps, chunk):
            m1 = min(m0 + chunk, n_steps)
            lo, hi = np.float32(m0 + 1), np.float32(m1)
            rows = max(rows, BLOCK_ROWS + extra
                       + _shift("nearest", hi, sh_i)[0]
                       - _shift("nearest", lo, sh_i)[0])
            cols = max(cols, BLOCK_COLS + extra + _shift(rd, hi, sh_j)[0]
                       - _shift(rd, lo, sh_j)[0])
    return rows, cols


def _check(win, trig, mode, cells, n_steps, offset, source, chunk):
    """Validate one call; returns ``(trig, offset)`` as the float32 table
    and the resolved offset."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if source not in SOURCES:
        raise ValueError(f"source must be one of {SOURCES}, got {source!r}")
    if mode in ("stream", "alu") and source != "l2":
        raise ValueError(f"mode {mode!r} has no shared-memory source")
    if mode == "stage" and source != "smem":
        raise ValueError("mode 'stage' is the shared-memory source's staging")
    if win.ndim != 2 or win.dtype != torch.float32:
        raise ValueError("the window must be a 2-D float32 tensor")
    trig = np.ascontiguousarray(trig, dtype=np.float32)
    if trig.ndim != 2 or trig.shape[1] != 2 or trig.shape[0] < 1:
        raise ValueError("trig must be (A, 2) (sh_i, sh_j)")
    if trig.min() < 0.0 or trig.max() > 1.0:
        raise ValueError("the shifts must lie in [0, 1] cells per step "
                         "(first-quadrant directions)")
    n0, n1 = cells
    if n0 < 1 or n1 < 1 or n_steps < 1 or chunk < 1:
        raise ValueError("cells, n_steps and chunk must be positive")
    if offset is None:
        offset = centre_offset(tuple(win.shape), cells)
    off0, off1 = offset
    if mode == "stream":
        if win.numel() % 4 or not win.is_contiguous():
            raise ValueError("stream reads the contiguous window as float4 "
                             "quads: its size must be a multiple of 4")
    elif mode != "alu":
        # the blocks' extents rounded up: threads past a ragged edge stage
        # their block's whole strip
        n0p = -(-n0 // BLOCK_ROWS) * BLOCK_ROWS
        n1p = -(-n1 // BLOCK_COLS) * BLOCK_COLS
        extra = 1 if _read_mode(mode) == "bilinear" else 0
        mi, mj = max_shifts(mode, trig, n_steps)
        if (min(off0, off1) < 0 or off0 + n0p + mi + extra > win.shape[0]
                or off1 + n1p + mj + extra > win.shape[1]):
            raise ValueError(
                f"window {tuple(win.shape)} too small: {n_steps} steps from "
                f"cells {cells} at offset {tuple(offset)} read rows up to "
                f"{off0 + n0p + mi + extra} and columns up to "
                f"{off1 + n1p + mj + extra}")
        if mode == "aligned" and (off1 % BLOCK_COLS
                                  or win.shape[1] % BLOCK_COLS):
            raise ValueError("the aligned mode needs a column offset and a "
                             "row stride that are multiples of 32")
    return trig, (int(off0), int(off1))


def stream_rotation(nq):
    """Quads between a thread's successive ``stream`` reads: the
    golden-ratio fraction of the window's ``nq`` quads, made odd."""
    return min(int(nq * 0.3819660112501051) | 1, max(nq - 1, 1))


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

def read_floor_plain(win, trig, mode, *, cells, n_steps, offset=None,
                     source="l2", chunk=32):
    """:func:`read_floor` in plain torch on ``win``'s device: the kernel's
    float32 operations in its order, vectorised over the cells.  The two
    sources read the same values, so ``source`` matters only to ``stage``.
    """
    trig, (off0, off1) = _check(win, trig, mode, cells, n_steps, offset,
                                source, chunk)
    f32 = np.float32
    n0, n1 = cells
    dev = win.device
    out = torch.empty((trig.shape[0], n0, n1), dtype=torch.float32,
                      device=dev)
    n0p = -(-n0 // BLOCK_ROWS) * BLOCK_ROWS
    n1p = -(-n1 // BLOCK_COLS) * BLOCK_COLS
    if mode == "stream":
        quads = win.reshape(-1, 4).max(dim=1).values
        nq = quads.numel()
        rot = stream_rotation(nq)
        t = (torch.arange(trig.shape[0] * n0p * n1p, device=dev)
             .view(trig.shape[0], n0p, n1p)[:, :n0, :n1])
        acc = torch.full(out.shape, INIT, dtype=torch.float32, device=dev)
        for m in range(n_steps):
            acc = torch.maximum(acc, quads[(t + m * rot) % nq])
        return acc
    for k in range(trig.shape[0]):
        sh_i, sh_j = f32(trig[k, 0]), f32(trig[k, 1])
        acc = torch.full((n0, n1), INIT, dtype=torch.float32, device=dev)
        if mode == "alu":
            for m in range(n_steps):
                x, y = acc, acc + float(f32(m + 1))
                for _ in range(8):
                    x = x * float(sh_i) + float(sh_j)
                    y = y * float(sh_j) + float(sh_i)
                    x = torch.maximum(x, y)
                acc = x
        elif mode == "stage":
            acc = _stage_plain(win, sh_i, sh_j, (n0p, n1p), n_steps,
                               (off0, off1), chunk)[:n0, :n1]
        else:
            for m in range(n_steps):
                s = f32(m + 1)
                di, fi = _shift("nearest", s, sh_i)
                dj, fj = _shift(mode, s, sh_j)
                r, c = off0 + di, off1 + dj
                if mode == "bilinear":
                    w = win[r:r + n0 + 1, c:c + n1 + 1]
                    gj = float(f32(1.0) - fj)
                    top = gj * w[:-1, :-1] + float(fj) * w[:-1, 1:]
                    bot = gj * w[1:, :-1] + float(fj) * w[1:, 1:]
                    he = float(f32(1.0) - fi) * top + float(fi) * bot
                else:
                    he = win[r:r + n0, c:c + n1]
                acc = torch.maximum(acc, he * float(f32(1.0) / s))
        out[k] = acc
    return out


def _stage_plain(win, sh_i, sh_j, cells_p, n_steps, offset, chunk):
    """The ``stage`` mode of one direction: thread (ty, tx) of each 32 x 8
    block keeps the max of the box cells (r, c) with ``r % 8 == ty`` and
    ``c % 32 == tx``, over the chunks' boxes (the bilinear mode's)."""
    f32 = np.float32
    n0p, n1p = cells_p
    acc = torch.full((n0p, n1p), INIT, dtype=torch.float32,
                     device=win.device)
    for m0 in range(0, n_steps, chunk):
        m1 = min(m0 + chunk, n_steps)
        lo_i = _shift("nearest", f32(m0 + 1), sh_i)[0]
        lo_j = _shift("nearest", f32(m0 + 1), sh_j)[0]
        box_h = BLOCK_ROWS + 1 + _shift("nearest", f32(m1), sh_i)[0] - lo_i
        box_w = BLOCK_COLS + 1 + _shift("nearest", f32(m1), sh_j)[0] - lo_j
        pad_h = -(-box_h // BLOCK_ROWS) * BLOCK_ROWS
        pad_w = -(-box_w // BLOCK_COLS) * BLOCK_COLS
        for b0 in range(0, n0p, BLOCK_ROWS):
            for b1 in range(0, n1p, BLOCK_COLS):
                r, c = offset[0] + b0 + lo_i, offset[1] + b1 + lo_j
                box = torch.full((pad_h, pad_w), INIT, dtype=torch.float32,
                                 device=win.device)
                box[:box_h, :box_w] = win[r:r + box_h, c:c + box_w]
                fold = box.view(pad_h // BLOCK_ROWS, BLOCK_ROWS,
                                pad_w // BLOCK_COLS, BLOCK_COLS).amax(
                                    dim=(0, 2))
                blk = acc[b0:b0 + BLOCK_ROWS, b1:b1 + BLOCK_COLS]
                torch.maximum(blk, fold, out=blk)
    return acc


# ---------------------------------------------------------------------------
# Kernel K5 (csrc/read_floor.cu)
# ---------------------------------------------------------------------------

class _RfParams(ctypes.Structure):
    """Mirror of ``struct RfParams`` in csrc/read_floor.cu."""
    _fields_ = (
        [("win", ctypes.c_void_p), ("trig", ctypes.c_void_p),
         ("out", ctypes.c_void_p)]
        + [(n, ctypes.c_int)
           for n in ("w0", "w1", "n0", "n1", "a_num", "off0", "off1",
                     "n_steps", "chunk", "ld")]
        + [("nq", ctypes.c_longlong), ("rot", ctypes.c_longlong)])


def _kernel_lib():
    """The loaded library of K5 (built with nvcc on first use)."""
    lib = _build.load("read_floor")
    lib.read_floor_launch.argtypes = [
        ctypes.POINTER(_RfParams), ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    lib.read_floor_launch.restype = ctypes.c_int
    lib.read_floor_error_string.argtypes = [ctypes.c_int]
    lib.read_floor_error_string.restype = ctypes.c_char_p
    lib.read_floor_params_size.argtypes = []
    lib.read_floor_params_size.restype = ctypes.c_int
    size = lib.read_floor_params_size()
    if size != ctypes.sizeof(_RfParams):
        raise RuntimeError(f"RfParams is {size} bytes in the kernel but "
                           f"{ctypes.sizeof(_RfParams)} in _RfParams")
    return lib


def _read_floor_cuda(win, trig, mode, cells, n_steps, offset, source, chunk):
    global KERNEL_LAUNCHES
    dev = win.device
    if not win.is_contiguous():
        raise ValueError("the read-floor kernel takes a contiguous window")
    n0, n1 = cells
    out = torch.empty((trig.shape[0], n0, n1), dtype=torch.float32,
                      device=dev)
    trig_t = torch.from_numpy(trig).to(dev)
    prm = _RfParams()
    prm.win, prm.trig, prm.out = (win.data_ptr(), trig_t.data_ptr(),
                                  out.data_ptr())
    prm.w0, prm.w1 = win.shape
    prm.n0, prm.n1, prm.a_num = n0, n1, trig.shape[0]
    prm.off0, prm.off1 = offset
    prm.n_steps, prm.chunk = n_steps, chunk
    smem_bytes = 0
    if source == "smem":
        rows, prm.ld = strip_layout(mode, trig, n_steps, chunk)
        smem_bytes = rows * prm.ld * 4
        if smem_bytes > MAX_SMEM_BYTES:
            raise ValueError(
                f"a strip of {rows} x {prm.ld} cells ({smem_bytes} bytes) "
                f"for chunks of {chunk} steps exceeds the {MAX_SMEM_BYTES} "
                f"bytes of shared memory a block can have: shorten the "
                f"chunk")
    if mode == "stream":
        prm.nq = win.numel() // 4
        prm.rot = stream_rotation(prm.nq)
    lib = _kernel_lib()
    err = lib.read_floor_launch(
        ctypes.byref(prm), MODES.index(mode), int(source == "smem"),
        smem_bytes, dev.index if dev.index is not None
        else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        msg = lib.read_floor_error_string(err).decode()
        raise RuntimeError(f"read_floor kernel launch failed: {msg}")
    KERNEL_LAUNCHES += 1
    return out


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def read_floor(win, trig, mode, *, cells, n_steps, offset=None, source="l2",
               chunk=32):
    """Running maxima (A, n0, n1) float32 of the read-floor primitive.

    ``win``: (w0, w1) float32 window tensor; ``trig``: (A, 2) float32
    (sh_i, sh_j) row and column shifts [cells per step] in [0, 1]
    (:func:`first_quadrant_trig`); ``mode``: one of :data:`MODES`;
    ``cells``: (n0, n1); ``offset``: the window position of cell (0, 0)
    (default :func:`centre_offset`); ``source``: one of :data:`SOURCES`;
    ``chunk``: steps per staged strip of the shared-memory source.  A
    window too small for the steps raises (the TPU tool once read out of
    bounds there, ``tools/read_floor.py:69-72``).

    A CUDA window runs kernel K5 (built with nvcc on first use; a failed
    build or launch raises), a CPU window :func:`read_floor_plain`."""
    if win.device.type == "cpu":
        return read_floor_plain(win, trig, mode, cells=cells,
                                n_steps=n_steps, offset=offset,
                                source=source, chunk=chunk)
    if win.device.type != "cuda":
        raise ValueError(f"no read floor for device {win.device}")
    trig, offset = _check(win, trig, mode, cells, n_steps, offset, source,
                          chunk)
    return _read_floor_cuda(win, trig, mode, cells, n_steps, offset, source,
                            chunk)


def work(mode, cells, a_num, n_steps):
    """What one call does: ``samples`` (cell, direction, step) triples,
    ``reads`` block-reads (one 32 x 8 block's shifted window read for one
    step, the counterpart of the TPU tool's one windowed read per tile and
    step), ``loads`` float32 values loaded (4 per bilinear sample, 1 per
    nearest, 4 per ``stream`` quad, 0 for ``alu``; ``stage`` loads depend
    on the strips and are not counted here) and ``ops`` float32 operations
    (:data:`OPS_PER_STEP`)."""
    n0, n1 = cells
    samples = n0 * n1 * a_num * n_steps
    blocks = -(-n0 // BLOCK_ROWS) * -(-n1 // BLOCK_COLS)
    per = {"bilinear": 4, "nearest": 1, "aligned": 1, "stream": 4, "alu": 0,
           "stage": 0}[mode]
    return dict(samples=samples, reads=blocks * a_num * n_steps,
                loads=per * samples, ops=OPS_PER_STEP[mode] * samples)


#: The (mode, source) pairs a full measurement runs, in order.
MEASURED = (("bilinear", "l2"), ("nearest", "l2"), ("aligned", "l2"),
            ("stage", "smem"), ("bilinear", "smem"), ("nearest", "smem"),
            ("aligned", "smem"), ("stream", "l2"), ("alu", "l2"))


def time_modes(win, *, cells=(1024, 1024), a_num=32, n_steps=246, chunk=32,
               iters=10, pairs=MEASURED):
    """Time K5 on the card: for each (mode, source) of ``pairs`` (e.g.
    ``stream`` alone on a window many times L2) one warm-up launch, then the mean of ``iters`` launches between CUDA
    events.  ``win`` must be a CUDA tensor.  Returns one dict per pair:
    ``mode``, ``source``, ``ms``, ``ns_per_read``, ``ps_per_sample``,
    ``gsamples_per_s``, for ``stream`` also ``tb_per_s`` (float4 bytes
    read over the time), for ``alu`` ``tops_per_s``, for the shared source
    the strip's ``smem_bytes``."""
    if win.device.type != "cuda":
        raise ValueError("time_modes measures the card: pass a CUDA window")
    trig = first_quadrant_trig(a_num)
    rows = []
    for mode, source in pairs:
        def run():
            return read_floor(win, trig, mode, cells=cells, n_steps=n_steps,
                              source=source, chunk=chunk)
        run()
        torch.cuda.synchronize(win.device)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            run()
        stop.record()
        torch.cuda.synchronize(win.device)
        ms = start.elapsed_time(stop) / iters
        w = work(mode, cells, a_num, n_steps)
        row = dict(mode=mode, source=source, ms=ms,
                   ns_per_read=1e6 * ms / w["reads"],
                   ps_per_sample=1e9 * ms / w["samples"],
                   gsamples_per_s=w["samples"] / ms / 1e6)
        if mode == "stream":
            row["tb_per_s"] = 4 * w["loads"] / ms / 1e9
        if mode == "alu":
            row["tops_per_s"] = w["ops"] / ms / 1e9
        if source == "smem":
            r, ld = strip_layout(mode, trig, n_steps, chunk)
            row["smem_bytes"] = r * ld * 4
        rows.append(row)
    return rows


def format_row(row):
    """One printed line of a :func:`time_modes` row."""
    extra = ""
    if "tb_per_s" in row:
        extra += f"   read {row['tb_per_s']:.3f} TB/s"
    if "tops_per_s" in row:
        extra += f"   {row['tops_per_s']:.2f} T op/s (--fmad=false)"
    if "smem_bytes" in row:
        extra += f"   strip {row['smem_bytes'] / 1024:.1f} KB"
    return (f"{row['mode']:<9}{row['source']:<5} {row['ms']:9.3f} ms   "
            f"{row['ns_per_read']:8.2f} ns/read   {row['ps_per_sample']:7.3f}"
            f" ps/sample   {row['gsamples_per_s']:8.1f} G samples/s{extra}")
