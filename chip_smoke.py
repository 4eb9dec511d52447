#!/usr/bin/env python3
# Copyright (c) 2026
# MIT License
"""Smoke run of horayzon_tpu_torch on one CUDA card (an H100).

    python3 chip_smoke.py

Phases, each of which ends the run with a nonzero exit on failure:

1. environment: torch, CUDA, the card, its name and power limit;
2. build: kernel K1 (csrc/horizon_sweep.cu) with nvcc for sm_90a;
3. K1 against its plain torch version on the card, on three small cases;
4. the main path, ``PlanarPipeline.run`` at the bench headline shape
   (25 m grid, 2048^2 outer, 1024^2 inner, 32 azimuths, 20 km search),
   timed with CUDA events, with output checks and a cropped comparison
   against the plain version; then K1 and the plain sweep timed alone;
5. one JSON line per kernel, then the result line
   ``{"ok": true, "device": {...}}``.

TF32 is switched off for matmuls and cuDNN, so nothing here runs in
reduced precision.  Imports nothing of JAX.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

from horayzon_tpu_torch.models import PlanarPipeline
from horayzon_tpu_torch.ops import _build, fused_sweep, mip

#: Horizon-angle tolerance [rad] of K1 against the plain version.
TOL = 1.0e-5
KERNEL_SOURCE = "horayzon_tpu_torch/csrc/horizon_sweep.cu"
REPLACES = "horayzon_tpu/ops/pallas_sweep.py:157"


def make_terrain(h, w, seed=0):
    """The bench's synthetic DEM (bench.py make_terrain): 24 gaussian
    bumps of 100-800 m on a flat plane."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    z = np.zeros((h, w), dtype=np.float64)
    for _ in range(24):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        sig = rng.uniform(6.0, h / 6.0)
        z += rng.uniform(100, 800) * np.exp(
            -(((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sig ** 2)))
    return z.astype(np.float32)


def check(cond, what):
    if not cond:
        raise SystemExit(f"FAIL: {what}")
    print(f"  ok: {what}")


def small_cases():
    """(name, z, kwargs) of the kernel-vs-plain phase."""
    spike_halo, spike_inner = 256, 64
    z_sp = np.zeros((spike_inner + 2 * spike_halo,) * 2, dtype=np.float32)
    z_sp[spike_halo - 96, spike_halo + 32] = 500.0
    return [
        # 32-cell halo: masked d2 and d1 steps run
        ("bumps96_inner32_d2500", make_terrain(96, 96, seed=3),
         dict(offset=(32, 32), inner_shape=(32, 32), azim_num=4,
              dist_search=2500.0)),
        # far spike caught only by the mip phases' reads
        ("spike_inner64_d6000", z_sp,
         dict(offset=(spike_halo, spike_halo),
              inner_shape=(spike_inner, spike_inner), azim_num=4,
              dist_search=6000.0)),
        ("bumps768_inner256_a7_d6000", make_terrain(768, 768, seed=1),
         dict(offset=(256, 256), inner_shape=(256, 256), azim_num=7,
              dist_search=6000.0)),
    ]


def cuda_ms(fn, reps):
    """Mean milliseconds of ``fn()`` over ``reps`` runs, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    print("== 1. environment")
    print(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}")
    check(torch.cuda.is_available(), "torch.cuda.is_available()")
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "?"
    print(f"  device {kind}, count {torch.cuda.device_count()}")
    print(card)

    print("== 2. build")
    fresh = not _build.library_path("horizon_sweep").is_file()
    t0 = time.perf_counter()
    lib = _build.build("horizon_sweep")
    print(f"  {lib.name}: {'built' if fresh else 'cached'} in "
          f"{time.perf_counter() - t0:.2f} s")
    for line in _build.BUILD_LOG.get("horizon_sweep", (0, ""))[1].splitlines():
        print(f"  nvcc: {line}")

    print("== 3. K1 against the plain version on the card")
    max_err = 0.0
    for name, z, kw in small_cases():
        zt = torch.from_numpy(z).to(dev)
        kw = dict(kw, dx=25.0, dy=-25.0, hori_acc=0.25)
        n0 = fused_sweep.KERNEL_LAUNCHES
        got = fused_sweep.horizon_sweep_fused(zt, **kw)
        ref = fused_sweep.horizon_sweep_plain(zt, **kw)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        max_err = max(max_err, err)
        print(f"  {name}: max |hori_K1 - hori_plain| = {err:.3e} rad")
        check(fused_sweep.KERNEL_LAUNCHES == n0 + 1,
              f"{name}: K1 launched once")
        check(bool(torch.isfinite(got).all()) and err <= TOL,
              f"{name}: finite and within {TOL} rad")

    print("== 4. main path: PlanarPipeline.run at the bench shape")
    n, halo, dx, azim_num, dist_km = 2048, 512, 25.0, 32, 20.0
    inner = n - 2 * halo
    z = make_terrain(n, n, seed=0)
    x = np.arange(n, dtype=np.float32) * dx
    y = (n - 1 - np.arange(n, dtype=np.float32)) * dx    # north-up
    domain = {"x_min": float(x[halo]), "x_max": float(x[halo + inner - 1]),
              "y_min": float(y[halo + inner - 1]), "y_max": float(y[halo])}
    pipe = PlanarPipeline(x, y, z, domain, dist_search=dist_km,
                          azim_num=azim_num, hori_acc=0.25, device=dev)
    check((pipe.offset_0, pipe.offset_1) == (halo, halo),
          f"inner domain at offset {halo}")
    t0 = time.perf_counter()
    pipe.run()
    torch.cuda.synchronize()
    print(f"  warm-up run (first launch at this shape): "
          f"{time.perf_counter() - t0:.3f} s")
    runs = 5
    fused_sweep.KERNEL_LAUNCHES = 0
    walls, ev_ms = [], []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = pipe.run()
        stop.record()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        ev_ms.append(start.elapsed_time(stop))
    launches = fused_sweep.KERNEL_LAUNCHES
    wall = float(np.median(walls))
    rate = inner * inner * azim_num / wall
    print(f"  PlanarPipeline.run over {runs} runs: median {wall:.4f} s wall "
          f"(min {min(walls):.4f}, max {max(walls):.4f}; median "
          f"{np.median(ev_ms):.2f} ms between CUDA events), "
          f"{rate:.4e} (cell*azimuth)/s  [{card}]")
    check(launches == runs, f"main path launched K1 ({launches} launches "
          f"in {runs} runs)")
    hori, svf = out["hori"], out["svf"]
    check(tuple(hori.shape) == (inner, inner, azim_num) and hori.is_cuda,
          "hori shape and device")
    check(bool(torch.isfinite(hori).all()), "hori finite")
    check(bool(torch.isfinite(svf).all()) and svf.min().item() > 0.0
          and svf.max().item() <= 1.0 + 1e-3,
          f"svf finite in (0, 1.001]: [{svf.min().item():.4f}, "
          f"{svf.max().item():.4f}]")
    zt = torch.from_numpy(z).to(dev)
    sweep_kw = dict(dx=dx, dy=-dx, azim_num=azim_num,
                    dist_search=dist_km * 1000.0, hori_acc=0.25)
    flat = fused_sweep.horizon_sweep_fused(
        torch.zeros_like(zt), offset=(halo, halo),
        inner_shape=(inner, inner), **sweep_kw)
    check(flat.abs().max().item() < 1e-4,
          f"flat plane: max |hori| = {flat.abs().max().item():.2e} rad")
    c0 = halo + inner // 2 - 64
    crop = fused_sweep.horizon_sweep_plain(
        zt, offset=(c0, c0), inner_shape=(128, 128), **sweep_kw)
    err = (hori[c0 - halo:c0 - halo + 128, c0 - halo:c0 - halo + 128]
           - crop).abs().max().item()
    max_err = max(max_err, err)
    check(err <= TOL, f"128^2 crop against the plain version: {err:.3e} rad")

    # K1 and the plain sweep alone at the main-path shape: raw ratios from
    # the same padded levels (levels, arctan and transpose not included)
    plan = fused_sweep.plan_sweep(
        tuple(zt.shape), inner_shape=(inner, inner), offset=(halo, halo),
        dist_search=dist_km * 1000.0, dx=dx, dy=-dx, hori_acc=0.25)
    levels = mip.padded_levels(zt, plan["pads"])
    z_inner = zt[halo:halo + inner, halo:halo + inner].contiguous()
    z_org = z_inner + float(np.float32(0.01))
    trig = fused_sweep.trig_table(azim_num)
    args = (z_org, z_inner, levels, trig, plan, tuple(zt.shape))
    fused_sweep._ratio_cuda(*args)
    k1_ms = cuda_ms(lambda: fused_sweep._ratio_cuda(*args), 10)
    plain_ms = cuda_ms(lambda: fused_sweep._ratio_plain(*args), 1)
    samples = plan["nx"] * 2 + (plan["n_dense"] - plan["nx"]) + sum(
        ph[1] for ph in plan["phases_meta"][1:])
    print(f"  K1 alone: {k1_ms:.3f} ms; plain torch sweep: {plain_ms:.1f} ms "
          f"({samples} samples per (cell, azimuth))  [{card}]")

    print("== 5. result")
    print(json.dumps({"kernels": [{
        "name": "horizon_sweep (K1)", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": REPLACES,
        "launches": launches, "max_abs_err": max_err,
        "ms": k1_ms, "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
