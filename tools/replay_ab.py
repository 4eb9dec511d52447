#!/usr/bin/env python3
# Copyright (c) 2026
# MIT License
"""Time the replay kernels K3 and K4 of this checkout against those of
another checkout, on one CUDA card, in turns (other, this, this, other),
on the records of three cells:

* ``grad``: K3 at the bench's gradient row (``chip_smoke.py`` phase 6:
  2048^2 outer, 1024^2 inner, 32 azimuths, 20 km, 25 m);
* ``shadow_grad``: K4 at the bench's shadow-gradient row (phase E: the
  same grid, 16 suns);
* ``multires``: K3 at the defaults of
  ``examples/horizon/gridded_planar_dem_2m.py`` (phase K: 2 m grid, fine
  5120^2, inner 1024^2, 60 azimuths, the combined pyramid).

    python tools/replay_ab.py OTHER_CHECKOUT [--reps 5] [--cells grad,...]

OTHER_CHECKOUT is a directory holding another commit's
``horayzon_tpu_torch`` (for example the parent unpacked with ``git
archive`` into the gitignored ``build/parent/``).  Its
``csrc/horizon_replay_bwd.cu`` is built with this checkout's nvcc flags
and launched through its own ``ops/replay.py`` (so its parameter block may
differ from this one's).  Prints the mean milliseconds of each turn, the
device time of each kernel of one call of this checkout's version
(``torch.profiler``), the largest difference of the two versions' cotangents relative to max |.| of
each (the other version may round its sums otherwise: the gather of
earlier commits summed in float32) and this version's fixed-point word
choice and precision bound per level.
"""

import argparse
import ctypes
import importlib.util
import pathlib
import subprocess
import sys
import types

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from horayzon_tpu_torch.ops import _build, fused_sweep, replay  # noqa: E402
from horayzon_tpu_torch.ops import shadow_sweep  # noqa: E402

CELLS = ("grad", "shadow_grad", "multires")


def other_replay(checkout):
    """The other checkout's ``ops/replay.py`` as a module of its own, whose
    kernel library is built from the other checkout's source into
    ``build/kernels/``."""
    root = pathlib.Path(checkout) / "horayzon_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        "other_replay", root / "ops" / "replay.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    cache = {}

    def load(name):
        if name not in cache:
            out = _build.BUILD_DIR / f"other_{name}.so"
            out.parent.mkdir(parents=True, exist_ok=True)
            subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                            str(out), str(root / "csrc" / f"{name}.cu")],
                           check=True, capture_output=True)
            cache[name] = ctypes.CDLL(str(out))
        return cache[name]

    mod._build = types.SimpleNamespace(load=load)
    return mod


def grad_record(dev):
    """K3's inputs at the gradient row: K1-argmax's record and the
    cotangent of ``mean(h^2)``."""
    n, halo = 2048, 512
    zt = torch.from_numpy(chip_smoke.make_terrain(n, n, seed=0)).to(dev)
    sargs = fused_sweep.sweep_args(
        zt, dx=25.0, dy=-25.0, offset=(halo, halo),
        inner_shape=(n - 2 * halo,) * 2, azim_num=32, dist_search=20000.0,
        hori_acc=0.25)
    plan = sargs[4]
    raw, ids, aux = fused_sweep._ratio_cuda(*sargs, emit_argmax=True)
    lims = (-15.0, 89.98)
    h = fused_sweep._angles(raw.clone(), *lims)
    graw = fused_sweep.raw_cotangent(raw, 2.0 * h / h.numel(), lims)
    return ((tuple(zt.shape), graw, ids, aux, plan,
             replay.horizon_shifts(sargs[3], plan)), {})


def shadow_grad_record(dev):
    """K4's inputs at the shadow-gradient row: K2-argmax's record and the
    cotangent of ``mean(sigmoid(metric / 2))``."""
    n, halo = 2048, 512
    inner = n - 2 * halo
    zt = torch.from_numpy(chip_smoke.make_terrain(n, n, seed=0)).to(dev)
    tt = np.linspace(0.15, 2.9, 16)
    track = list(zip(3.0e5 * np.cos(tt), 3.0e5 * np.sin(tt),
                     2.0e4 + 1.0e4 * np.sin(2 * tt)))
    z_org, z_in, table, kw = chip_smoke.shadow_inputs(
        zt, (halo, halo), (inner, inner), 25.0, -25.0, (0.0, 0.0), track)
    sargs = shadow_sweep.metric_args(
        zt, z_org, z_in, table,
        **{k: kw[k] for k in ("offset", "inner_shape", "dx", "dy")})
    met, ids, aux = shadow_sweep._metric_cuda(*sargs, grid_origin=(0.0, 0.0),
                                              emit_argmax=True)
    sig = torch.sigmoid(met / 2.0)
    gmet = sig * (1.0 - sig) * (0.5 / met.numel())
    return ((tuple(zt.shape), gmet, ids, aux, sargs[4]),
            {"shadow": (table, sargs[0], (0.0, 0.0))})


def multires_record(dev):
    """K3's inputs at the 2 m multires cell: K1-argmax's record on the
    combined pyramid and a uniform cotangent."""
    zf_np, zc_np, kw = chip_smoke.multires_2m_scene()
    zf = torch.from_numpy(zf_np).to(dev)
    zc = torch.from_numpy(zc_np).to(dev)
    sargs = chip_smoke.multires_args(zf, zc, kw)
    plan = sargs[4]
    raw, ids, aux = fused_sweep._ratio_cuda(*sargs, emit_argmax=True)
    g = torch.ones_like(raw) / raw.numel()
    return ((tuple(zf.shape), g, ids, aux, plan,
             replay.horizon_shifts(sargs[3], plan)), {})


RECORDS = {"grad": grad_record, "shadow_grad": shadow_grad_record,
           "multires": multires_record}


def device_times(fn):
    """(name, device ms) of each kernel and copy one call of ``fn``
    launches, by ``torch.profiler``; empty when the profiler records no
    device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0.0)
        if us > 0.0:
            rows.append((ev.key, us / 1e3))
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("other")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--cells", default=",".join(CELLS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda", 0)
    other = other_replay(args.other)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    for cell in args.cells.split(","):
        bargs, kw = RECORDS[cell](dev)
        kernel = "K4" if kw else "K3"
        fns = {"other": lambda: other._bwd_cuda(*bargs, **kw),
               "this": lambda: replay._bwd_cuda(*bargs, **kw)}
        for name in ("other", "this", "this", "other"):
            fns[name]()
            ms = chip_smoke.cuda_ms(fns[name], args.reps)
            print(f"{cell}: {kernel} {name}: {ms:.3f} ms (mean of "
                  f"{args.reps})  [{smi}]")
        a_cots, a_z = fns["other"]()
        b_cots, b_z = fns["this"]()
        errs = [chip_smoke.rel_err(b, a) for a, b in zip(a_cots + [a_z],
                                                         b_cots + [b_z])]
        print(f"{cell}: this against other, per output (relative to max "
              f"|.|): {', '.join(f'{e:.1e}' for e in errs)}")
        times = device_times(fns["this"])
        for key, ms in times:
            print(f"{cell}: this, device time of {key[:70]}: {ms:.3f} ms")
        if not times:
            print(f"{cell}: this, device times per kernel: not measured (the "
                  f"profiler recorded no device time)")
        for lvl, c_bits, words, m, bnd in replay.level_report():
            print(f"{cell}: level {lvl}: c_bits {c_bits}, {words} word(s), "
                  f"max |coefficient| {m:.4e}, precision bound {bnd:.3e}")
        del bargs, kw, fns, a_cots, a_z, b_cots, b_z
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
