#!/usr/bin/env python3
# Copyright (c) 2026
# MIT License
"""What the port's spans and counted launches cost on one CUDA card, with
the profiler off and on (``horayzon_tpu_torch.utils.profiling``).

    python tools/tracing_cost.py [--spans 200000] [--reps 4] [--seed 7]

Spans: host microseconds of one ``with profiling.span(...)`` (enter and
exit) and of one ``profiling.tracing()``, over ``--spans`` of them with
the profiler off and on (CPU and CUDA activities), beside an empty loop
and an ungated ``torch.profiler.record_function`` with the profiler off.
Launches: K1 on the first DEM of the benchmark's ``dhm25_hz`` cell and
K2's sign-exact arm on the first track of its ``hemi_track_batch`` cell,
through their wrappers (``fused_sweep._ratio_cuda``,
``shadow_sweep._metric_cuda``) as the program launches them, in turns:
profiler off and no counters, profiler off with a counters tensor (the
kernel's atomics alone), profiler on (the launch counted into
``profiling.counters()``); device milliseconds by CUDA events and host
microseconds of the wrapper call, medians over ``--reps`` turns.  Prints
one JSON line.
"""

import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

from horayzon_tpu_torch.ops import fused_sweep  # noqa: E402
from horayzon_tpu_torch.ops import shadow_sweep  # noqa: E402
from horayzon_tpu_torch.utils import profiling  # noqa: E402


def _profiler():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _us_each(fn, n):
    t0 = time.perf_counter()
    fn(n)
    return (time.perf_counter() - t0) / n * 1e6


def _spans(n):
    span = profiling.span
    for _ in range(n):
        with span("hzt.cost"):
            pass


def _flags(n):
    tracing = profiling.tracing
    for _ in range(n):
        tracing()


def _empty(n):
    for _ in range(n):
        pass


def _ungated(n):
    rf = torch.profiler.record_function
    for _ in range(n):
        with rf("hzt.cost"):
            pass


def span_cost(n):
    """Microseconds per span, flag read and loop turn, profiler off and
    on."""
    out = {"empty_loop_us": _us_each(_empty, n),
           "span_off_us": _us_each(_spans, n),
           "tracing_off_us": _us_each(_flags, n),
           "record_function_off_us": _us_each(_ungated, n // 10)}
    with _profiler():
        out["span_on_us"] = _us_each(_spans, n // 10)
        out["tracing_on_us"] = _us_each(_flags, n)
    return out


def _timed(launch):
    """(device ms, host us) of one ``launch()``."""
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    e0.record()
    t0 = time.perf_counter()
    launch()
    host = (time.perf_counter() - t0) * 1e6
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1), host


def launch_cost(launch, reps):
    """Medians of (device ms, host us) of ``launch(counters)`` per mode."""
    dev = torch.device("cuda")
    runs = {"off": [], "off_counters": [], "on_counted": []}
    launch(None)                                   # warm-up
    for r in range(reps):
        order = ("off", "off_counters", "on_counted")
        for mode in (order if r % 2 == 0 else order[::-1]):
            if mode == "on_counted":
                with _profiler():
                    runs[mode].append(_timed(lambda: launch(None)))
            else:
                c = (torch.zeros(4, dtype=torch.int64, device=dev)
                     if mode == "off_counters" else None)
                runs[mode].append(_timed(lambda c=c: launch(c)))
    profiling.reset_counters()
    return {m: {"device_ms": statistics.median(d for d, _ in v),
                "host_us": statistics.median(h for _, h in v)}
            for m, v in runs.items()}


def k1_launch(seed):
    from hzbench import harness
    _, _, _, _, sc, _ = harness.set_up("dhm25_hz", seed)
    args = fused_sweep.sweep_args(
        sc["z"], dx=sc["dx"], dy=sc["dy"], offset=sc["offset"],
        inner_shape=sc["inner_shape"], azim_num=sc["azim_num"],
        dist_search=sc["dist_search_km"] * 1000.0, hori_acc=sc["hori_acc"])
    return lambda c: fused_sweep._ratio_cuda(*args, counters=c)


def k2_launch(seed):
    from hzbench import harness
    _, _, _, _, _, drv = harness.set_up("hemi_track_batch", seed)
    t, f = drv.terrain, drv.terrain._fields
    table, _ = shadow_sweep.shadow_sun_table(drv.track(0), t._center,
                                             t.grid.dx, t.grid.dy)
    args = shadow_sweep.metric_args(
        t._z_outer, f["z_org_r"], f["z_inner_r"], table, offset=t.offset,
        inner_shape=t.comp_shape, dx=t.grid.dx, dy=t.grid.dy,
        hori_acc=t.acc, pyramid=t._levels, pooled=t._pooled)
    return lambda c: shadow_sweep._metric_cuda(
        *args, grid_origin=t._grid_origin, exact_metric=False,
        pooled=t._pooled, counters=c)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--spans", type=int, default=200000)
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tracing_cost: needs a CUDA card", file=sys.stderr)
        return 2
    out = {"device": torch.cuda.get_device_name(0),
           "spans": span_cost(args.spans),
           "k1": launch_cost(k1_launch(args.seed), args.reps),
           "k2": launch_cost(k2_launch(args.seed), args.reps)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
