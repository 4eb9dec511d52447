#!/usr/bin/env python3
# Copyright (c) 2026
# MIT License
"""Time kernel K2 (or K2-argmax) of this checkout against that of another
checkout, on one CUDA card, in turns (other, this, this, other), or print
the share of samples K2's skips pass over as their plain model decides
them, on any device.

    python tools/k2_ab.py OTHER_CHECKOUT [--cell row_b|hemisphere]
                          [--argmax] [--sign-exact] [--reps 10]
    python tools/k2_ab.py --model [--cell row_b|hemisphere] [--rows 64]
                          [--device cpu]

Cells: ``row_b``, the bench's shadow row (``chip_smoke.py`` phase B:
2048^2 outer, 1024^2 inner, 16 suns 300 km out; with ``--argmax`` the
shadow-gradient row E's forward), and ``hemisphere``, the ``Terrain`` of
``examples/shadow/gridded_planar_dem_artificial.py`` at its defaults
(phase C: 800^2 at 100 m, 600^2 inner, 181 suns at 30 degrees; with
``--argmax`` the forward of phase F's soft step).

A/B: OTHER_CHECKOUT is a directory holding another commit's
``horayzon_tpu_torch/csrc/horizon_sweep.cu`` (for example one unpacked
with ``git archive``).  Its source is built with this checkout's nvcc
flags and launched with this checkout's parameter block, which must start
with the other's fields (fields are only ever appended); the other gets
the pooled companions and runs value-exact.  This checkout's
K2 runs through its wrapper, ``shadow_sweep._metric_cuda``, with the
pooled companions built per call at ``row_b`` (as ``shadow_metric_fused``
builds them) and the ``Terrain``'s at ``hemisphere``.  Prints the mean
milliseconds of each turn, the kernel's skip counters, and whether the
outputs (metric; with ``--argmax`` also winner ids and D) are bit-equal
(``--sign-exact``: whether the metric has the other's sign and is at most
its value, the other being exact).

``--model``: runs ``shadow_sweep.metric_model`` in the value-exact and the
sign-exact mode on ``--rows`` rows from the middle of the inner block,
every sun, and prints the share of samples skipped per section: safe d1
pairs, masked d1 pairs, mip phases.  The rows of a crop are swept exactly
as in the full block (the plan and the warps do not change).
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
from horayzon_tpu_torch import shadow, sun_position  # noqa: E402
from horayzon_tpu_torch.ops import _build, fused_sweep  # noqa: E402
from horayzon_tpu_torch.ops import shadow_sweep  # noqa: E402


def build_other(checkout):
    """The other checkout's horizon_sweep library, built into
    ``build/kernels/``."""
    src = pathlib.Path(checkout) / "horayzon_tpu_torch" / "csrc" / \
        "horizon_sweep.cu"
    out = _build.BUILD_DIR / "other_k2_horizon_sweep.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                    str(src)], check=True)
    lib = ctypes.CDLL(str(out))
    for fn in (lib.shadow_sweep_launch, lib.shadow_sweep_argmax_launch):
        fn.argtypes = [ctypes.POINTER(fused_sweep._HzParams), ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.horizon_sweep_params_size.restype = ctypes.c_int
    size = lib.horizon_sweep_params_size()
    if size > ctypes.sizeof(fused_sweep._HzParams):
        raise RuntimeError(f"the other HzParams ({size} bytes) is larger "
                           f"than this one's")
    return lib


def cell_args(cell, dev, rows=None):
    """``(args, grid_origin, pooled)``: the inputs of
    ``shadow_sweep._metric_cuda`` at ``cell`` on ``dev``, the grid origin
    and the pooled companions a caller keeps (None where the library
    builds them per call); ``rows``: only that many rows from the middle of
    the inner block."""
    if cell == "row_b":
        n, halo, dx = 2048, 512, 25.0
        inner = n - 2 * halo
        zt = torch.from_numpy(chip_smoke.make_terrain(n, n, seed=0)).to(dev)
        tt = np.linspace(0.15, 2.9, 16)
        track = list(zip(3.0e5 * np.cos(tt), 3.0e5 * np.sin(tt),
                         2.0e4 + 1.0e4 * np.sin(2 * tt)))
        z_org, z_in, table, kw = chip_smoke.shadow_inputs(
            zt, (halo, halo), (inner, inner), dx, -dx, (0.0, 0.0), track)
        off, origin, pyramid = (halo, halo), (0.0, 0.0), None
    else:
        terrain = shadow.Terrain()
        terrain.initialise(*chip_smoke.hemisphere_terrain(), ang_max=89.99,
                           device=dev)
        suns = sun_position.sun_position_planar(np.linspace(0.0, 360.0, 181),
                                                30.0, dist=1.0e7)
        table, _ = shadow_sweep.shadow_sun_table(
            suns, terrain._center, terrain.grid.dx, terrain.grid.dy)
        zt, f = terrain._z_outer, terrain._fields
        z_org, z_in = f["z_org_r"], f["z_inner_r"]
        kw = dict(dx=terrain.grid.dx, dy=terrain.grid.dy,
                  inner_shape=terrain.comp_shape)
        off, origin = terrain.offset, terrain._grid_origin
        pyramid = terrain._levels
    in0, in1 = z_org.shape
    if rows is not None:
        r0 = (in0 - rows) // 2
        z_org, z_in = z_org[r0:r0 + rows], z_in[r0:r0 + rows]
        off, in0 = (off[0] + r0, off[1]), rows
    args = shadow_sweep.metric_args(zt, z_org, z_in, table, offset=off,
                                    inner_shape=(in0, in1), dx=kw["dx"],
                                    dy=kw["dy"], pyramid=pyramid)
    pooled = None if pyramid is None else fused_sweep.skip_inputs(
        args[2], args[4])
    return args, origin, pooled


def model(args):
    dev = torch.device(args.device)
    margs, origin, pooled = cell_args(args.cell, dev, args.rows)
    plan = margs[4]
    per_cell = (2 * plan["nx"] + plan["n_dense"] - plan["nx"]
                + sum(ph[1] for ph in plan["phases_meta"][1:]))
    total = per_cell * margs[0].numel() * margs[3].shape[0]
    print(f"{args.cell}, {args.rows} rows x {margs[0].shape[1]} columns x "
          f"{margs[3].shape[0]} suns: nx {plan['nx']}, ns1 {plan['ns1']}, "
          f"n_dense {plan['n_dense']}, mip phases "
          f"{[ph[:2] for ph in plan['phases_meta'][1:]]}; {per_cell} samples "
          f"per (cell, sun)")
    for exact in (True, False):
        _, counts = shadow_sweep.metric_model(*margs, grid_origin=origin,
                                              exact_metric=exact,
                                              pooled=pooled)
        taken = 1.0 - (counts["d1_skipped"] + counts["mip_skipped"]) / total
        print(f"  {'exact' if exact else 'sign-exact'}: skipped: "
              f"{chip_smoke.skip_shares(counts)}; "
              f"{taken:.4f} of all samples taken")
    return 0


def ab(args):
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda", 0)
    other = build_other(args.other)
    margs, origin, pooled = cell_args(args.cell, dev)
    z_org, z_inner, levels, table, plan, shape = margs
    outs = [torch.empty((table.shape[0],) + z_org.shape, dtype=dt,
                        device=dev)
            for dt in ((torch.float32, torch.int32, torch.float32)
                       if args.argmax else (torch.float32,))]
    prm = fused_sweep.kernel_params(z_org, z_inner, levels, plan, shape,
                                    table.shape[0], outs[0])
    table_t = torch.from_numpy(table).to(dev)
    prm.sun = table_t.data_ptr()
    prm.x0, prm.y0 = np.float32(origin[0]), np.float32(origin[1])
    # the value-exact skips' companions, for another checkout's K2 that
    # reads them (one that does not leaves them unread)
    other_pooled = pooled or fused_sweep.skip_inputs(levels, plan)
    prm.pool_min0 = other_pooled[1].data_ptr()
    for lvl, t in enumerate(other_pooled[0]):
        prm.pool[lvl], prm.pool_w[lvl] = t.data_ptr(), t.shape[1]
    entry = other.shadow_sweep_launch
    if args.argmax:
        prm.ids, prm.aux = outs[1].data_ptr(), outs[2].data_ptr()
        entry = other.shadow_sweep_argmax_launch

    def run_other():
        fused_sweep.launch(other, entry, prm, dev)
        return tuple(outs)

    def run_this(counters=None):
        res = shadow_sweep._metric_cuda(
            *margs, grid_origin=origin, emit_argmax=args.argmax,
            exact_metric=not args.sign_exact, pooled=pooled,
            counters=counters)
        return res if args.argmax else (res,)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    what = "K2-argmax" if args.argmax else "K2"
    mode = "sign-exact" if args.sign_exact else "exact"
    print(f"{what} ({mode}) at the {args.cell} cell: {table.shape[0]} suns "
          f"over {tuple(z_org.shape)} cells, {len(levels)} levels")
    for name, fn in (("other", run_other), ("this", run_this),
                     ("this", run_this), ("other", run_other)):
        fn()
        ms = chip_smoke.cuda_ms(fn, args.reps)
        print(f"{what} {name}: {ms:.3f} ms (mean of {args.reps})")
    counters = torch.zeros(len(fused_sweep.COUNTER_FIELDS),
                           dtype=torch.int64, device=dev)
    got = run_this(counters)
    counts = dict(zip(fused_sweep.COUNTER_FIELDS, counters.tolist()))
    print(f"{what} this, its counters: {counts}; skipped: "
          f"{chip_smoke.skip_shares(counts)}")
    want = [t.clone() for t in run_other()]
    if args.sign_exact:
        same = (torch.equal(got[0] > 0, want[0] > 0)
                and bool((got[0] <= want[0]).all()))
        print(f"metric > 0 equal to the other's and metric <= the other's: "
              f"{same}; {int((got[0] != want[0]).sum())} of "
              f"{got[0].numel()} values differ")
    else:
        same = all(torch.equal(a, b) for a, b in zip(want, got))
        print(f"outputs bit-equal: {same}")
    return 0 if same else 1


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("other", nargs="?")
    ap.add_argument("--cell", choices=("row_b", "hemisphere"),
                    default="row_b")
    ap.add_argument("--argmax", action="store_true",
                    help="time K2-argmax (metric, ids and D compared)")
    ap.add_argument("--sign-exact", action="store_true",
                    help="this checkout's K2 with its sign-exact arm")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--model", action="store_true",
                    help="print the plain model's skip shares on a crop")
    ap.add_argument("--rows", type=int, default=64)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()
    if args.model:
        return model(args)
    if args.other is None or (args.argmax and args.sign_exact):
        ap.error("give OTHER_CHECKOUT (and not --argmax with --sign-exact)")
    return ab(args)


if __name__ == "__main__":
    sys.exit(main())
