#!/usr/bin/env python3
# Copyright (c) 2026
# MIT License
"""Time kernel K1 of this checkout against K1 of another checkout, on one
CUDA card, in turns (other, this, this, other), at the bench's headline
shape (``chip_smoke.py`` phase 4: 2048^2 outer, 1024^2 inner, 32
azimuths, 20 km, 25 m).

    python tools/k1_ab.py OTHER_CHECKOUT [--reps 10]

OTHER_CHECKOUT is a directory holding another commit's
``horayzon_tpu_torch/csrc/horizon_sweep.cu`` (for example one unpacked
with ``git archive``).  Its source is built with this checkout's nvcc
flags and launched with this checkout's parameter block, which must start
with the other's fields (fields are only ever appended).  Prints the mean
milliseconds of each turn and whether the two outputs are bit-equal.
"""

import argparse
import ctypes
import pathlib
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from horayzon_tpu_torch.ops import _build, fused_sweep, mip  # noqa: E402


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
    lib.horizon_sweep_launch.argtypes = [
        ctypes.POINTER(fused_sweep._HzParams), ctypes.c_int, ctypes.c_void_p]
    lib.horizon_sweep_launch.restype = ctypes.c_int
    lib.horizon_sweep_params_size.restype = ctypes.c_int
    size = lib.horizon_sweep_params_size()
    if size > ctypes.sizeof(fused_sweep._HzParams):
        raise RuntimeError(f"the other HzParams ({size} bytes) is larger "
                           f"than this one's")
    return lib


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("other")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda", 0)
    other = build_other(args.other)
    n, halo, azim_num = 2048, 512, 32
    inner = n - 2 * halo
    zt = torch.from_numpy(chip_smoke.make_terrain(n, n, seed=0)).to(dev)
    plan = fused_sweep.plan_sweep((n, n), inner_shape=(inner, inner),
                                  offset=(halo, halo), dist_search=20000.0,
                                  dx=25.0, dy=-25.0, hori_acc=0.25)
    levels = mip.padded_levels(zt, plan["pads"])
    z_inner = zt[halo:halo + inner, halo:halo + inner].contiguous()
    z_org = z_inner + float(np.float32(0.01))
    trig = fused_sweep.trig_table(azim_num)
    sargs = (z_org, z_inner, levels, trig, plan, (n, n))
    out = torch.empty((azim_num, inner, inner), dtype=torch.float32,
                      device=dev)
    prm = fused_sweep.kernel_params(z_org, z_inner, levels, plan, (n, n),
                                    azim_num, out)
    trig_t = torch.from_numpy(trig).to(dev)
    prm.trig = trig_t.data_ptr()

    def run_other():
        fused_sweep.launch(other, other.horizon_sweep_launch, prm, dev)
        return out

    def run_this():
        return fused_sweep._ratio_cuda(*sargs)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    for name, fn in (("other", run_other), ("this", run_this),
                     ("this", run_this), ("other", run_other)):
        fn()
        ms = chip_smoke.cuda_ms(fn, args.reps)
        print(f"K1 {name}: {ms:.3f} ms (mean of {args.reps})")
    same = torch.equal(run_other().clone(), run_this())
    print(f"outputs bit-equal: {same}")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
