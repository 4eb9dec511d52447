#!/usr/bin/env python3
# Copyright (c) 2026
# MIT License
"""Time kernel K1 (or K1-argmax) of this checkout against that of another
checkout, on one CUDA card, in turns (other, this, this, other), at the
bench's headline shape (``chip_smoke.py`` phase 4: 2048^2 outer, 1024^2
inner, 32 azimuths, 20 km, 25 m) or at the 2 m multires example's defaults
(phase K: the combined pyramid of a 5120^2 fine grid, 1024^2 inner, 60
azimuths, 20 km).

    python tools/k1_ab.py OTHER_CHECKOUT [--reps 10] [--argmax]
                          [--cell bench|multires]

OTHER_CHECKOUT is a directory holding another commit's
``horayzon_tpu_torch/csrc/horizon_sweep.cu`` (for example one unpacked
with ``git archive``).  Its source is built with this checkout's nvcc
flags and launched with this checkout's parameter block, which must start
with the other's fields (fields are only ever appended).  This
checkout's K1 runs through its wrapper, ``fused_sweep._ratio_cuda``, whose
time includes what the wrapper builds per call (the pooled companions of
the skips, the small tables).  Prints the mean milliseconds of each turn
and whether the outputs (raw ratios; with ``--argmax`` also winner ids and
D) are bit-equal.
"""

import argparse
import ctypes
import pathlib
import subprocess
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from horayzon_tpu_torch.ops import _build, fused_sweep  # noqa: E402


def build_other(checkout):
    """The other checkout's horizon_sweep library, built into
    ``build/kernels/``."""
    src = pathlib.Path(checkout) / "horayzon_tpu_torch" / "csrc" / \
        "horizon_sweep.cu"
    out = _build.BUILD_DIR / "other_horizon_sweep.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                    str(src)], check=True)
    lib = ctypes.CDLL(str(out))
    for fn in (lib.horizon_sweep_launch, lib.horizon_sweep_argmax_launch):
        fn.argtypes = [ctypes.POINTER(fused_sweep._HzParams), ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.horizon_sweep_params_size.restype = ctypes.c_int
    size = lib.horizon_sweep_params_size()
    if size > ctypes.sizeof(fused_sweep._HzParams):
        raise RuntimeError(f"the other HzParams ({size} bytes) is larger "
                           f"than this one's")
    return lib


def cell_args(cell, dev):
    """The sweep's inputs at ``cell``: the bench's headline shape
    (``bench``) or the 2 m multires example's defaults (``multires``)."""
    if cell == "multires":
        zf_np, zc_np, kw = chip_smoke.multires_2m_scene()
        return chip_smoke.multires_args(torch.from_numpy(zf_np).to(dev),
                                        torch.from_numpy(zc_np).to(dev), kw)
    n, halo = 2048, 512
    zt = torch.from_numpy(chip_smoke.make_terrain(n, n, seed=0)).to(dev)
    return fused_sweep.sweep_args(zt, dx=25.0, dy=-25.0, offset=(halo, halo),
                                  inner_shape=(n - 2 * halo,) * 2,
                                  azim_num=32, dist_search=20000.0,
                                  hori_acc=0.25)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("other")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--argmax", action="store_true",
                    help="time K1-argmax (raw, ids and D compared)")
    ap.add_argument("--cell", choices=("bench", "multires"), default="bench")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda", 0)
    other = build_other(args.other)
    sargs = cell_args(args.cell, dev)
    z_org, z_inner, levels, trig, plan, shape = sargs[:6]
    outs = [torch.empty((trig.shape[0],) + z_org.shape, dtype=dt,
                        device=dev)
            for dt in ((torch.float32, torch.int32, torch.float32)
                       if args.argmax else (torch.float32,))]
    prm = fused_sweep.kernel_params(z_org, z_inner, levels, plan, shape,
                                    trig.shape[0], outs[0])
    trig_t = torch.from_numpy(trig).to(dev)
    prm.trig = trig_t.data_ptr()
    entry = other.horizon_sweep_launch
    if args.argmax:
        prm.ids, prm.aux = outs[1].data_ptr(), outs[2].data_ptr()
        entry = other.horizon_sweep_argmax_launch

    def run_other():
        fused_sweep.launch(other, entry, prm, dev)
        return tuple(outs)

    def run_this():
        res = fused_sweep._ratio_cuda(*sargs, emit_argmax=args.argmax)
        return res if args.argmax else (res,)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    what = "K1-argmax" if args.argmax else "K1"
    print(f"{what} at the {args.cell} cell: {trig.shape[0]} azimuths over "
          f"{tuple(z_org.shape)} cells, {len(levels)} levels")
    for name, fn in (("other", run_other), ("this", run_this),
                     ("this", run_this), ("other", run_other)):
        fn()
        ms = chip_smoke.cuda_ms(fn, args.reps)
        print(f"{what} {name}: {ms:.3f} ms (mean of {args.reps})")
    want = [t.clone() for t in run_other()]
    same = all(torch.equal(a, b) for a, b in zip(want, run_this()))
    print(f"outputs bit-equal: {same}")
    return 0 if same else 1

if __name__ == "__main__":
    sys.exit(main())
