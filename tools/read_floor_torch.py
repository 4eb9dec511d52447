#!/usr/bin/env python
# Copyright (c) 2026
# MIT License
"""Read-floor microbenchmark on one CUDA card: the counterpart of
``tools/read_floor.py`` for the PyTorch/CUDA port.

Times kernel K5 (``horayzon_tpu_torch/csrc/read_floor.cu``) in every mode
and from both sources (the window in global memory read through L2, and
each block's strip staged in shared memory) at K1's bench cell: 1024^2
cells, 32 first-quadrant directions, 246 steps, on two windows: 2048^2
(16 MiB, level 0 of the bench grid, L2-resident) and 5120^2 (105 MB, level
0 of the 2 m example, twice L2: its ``stream`` row still mixes L2 hits
with device memory).  ``stream`` alone also runs on a 16384^2 window (1 GiB,
twenty times L2): the read rate of device memory.  Prints per mode and
window the time, ns per block-read, ps per (cell, direction, sample),
G samples/s, TB/s for ``stream`` and T op/s for ``alu``.  Every mode is
first held bit-equal to its plain torch version on a small window.

Usage: python tools/read_floor_torch.py [--windows 2048,5120]
           [--stream-window 16384] [--chunk 32]
"""

import argparse
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__),
                                                "..")))  # run without install

from horayzon_tpu_torch.ops import read_floor  # noqa: E402


def check_small(dev, chunk=8):
    """Every (mode, source) on a small window, bit-equal to the plain
    version; raises SystemExit otherwise."""
    rng = np.random.default_rng(0)
    win = torch.from_numpy(rng.normal(size=(160, 224)).astype(np.float32))
    trig = read_floor.first_quadrant_trig(5)
    kw = dict(cells=(20, 70), n_steps=37, offset=(8, 32), chunk=chunk)
    for mode, source in read_floor.MEASURED:
        got = read_floor.read_floor(win.to(dev), trig, mode, source=source,
                                    **kw)
        want = read_floor.read_floor_plain(win, trig, mode, source=source,
                                           **kw)
        torch.cuda.synchronize()
        if not torch.equal(got.cpu(), want):
            raise SystemExit(f"FAIL: K5 {mode}/{source} differs from its "
                             f"plain version")
    print(f"every mode and source bit-equal to its plain version "
          f"({len(read_floor.MEASURED)} pairs)")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", type=int, default=1024)
    ap.add_argument("--azim", type=int, default=32)
    ap.add_argument("--steps", type=int, default=246)
    ap.add_argument("--windows", type=str, default="2048,5120")
    ap.add_argument("--stream-window", type=int, default=16384,
                    help="side of the window (many times L2) on which "
                         "stream alone is timed: the device-memory row")
    ap.add_argument("--chunk", type=int, default=32,
                    help="steps per staged strip of the shared source")
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("read_floor_torch.py measures a CUDA card; "
                         "torch.cuda.is_available() is false")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    check_small(dev)
    kw = dict(cells=(args.cells, args.cells), a_num=args.azim,
              n_steps=args.steps, chunk=args.chunk, iters=args.iters)
    sides = [(int(w), read_floor.MEASURED) for w in args.windows.split(",")]
    sides.append((args.stream_window, (("stream", "l2"),)))
    for n, pairs in sides:
        gen = torch.Generator(device=dev).manual_seed(0)
        win = torch.randn((n, n), generator=gen, device=dev,
                          dtype=torch.float32)
        print(f"window {n}^2 ({win.numel() * 4 / 2**20:.0f} MiB), "
              f"{args.cells}^2 cells x {args.azim} directions x "
              f"{args.steps} steps, chunk {args.chunk}")
        for row in read_floor.time_modes(win, pairs=pairs, **kw):
            print(read_floor.format_row(row))
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        win.max()
        start.record()
        for _ in range(args.iters):
            win.max()
        stop.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(stop) / args.iters
        print(f"torch max over the window (one pass): {ms:.4f} ms, "
              f"{win.numel() * 4 / ms / 1e9:.3f} TB/s")


if __name__ == "__main__":
    main()
