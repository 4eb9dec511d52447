#!/usr/bin/env python3
# Copyright (c) 2026
# MIT License
"""One traced run (``--trace 1``) of a benchmark cell, with what its
result line leaves out: the cell's end-to-end metrics beside the
per-layer ones, how much of each root span of the program its child
spans cover, the milliseconds per call of every ``hzt.*`` span, the
share of the card's idle time that falls under the benchmark's own
wrapper spans (``hzbench/harness.py::SPANS``), the routes the traced
``PlanarPipeline.run`` and ``CurvedPipeline.run`` calls took
(``utils/profiling.routes``), the planarisation, geometry and TIN far
field kernels' launches while the trace ran
(``ops/planarize.KERNEL_LAUNCHES`` and ``ops/geometry.KERNEL_LAUNCHES``:
one each per curved call; ``ops/tin_raster.KERNEL_LAUNCHES``: one per TIN
call on the card), the lattice cells the curved runs swept per inner cell
(``utils/profiling.lattice``), the triangles the TIN runs (route
``tin``) rasterised (``utils/profiling.tin``; each null for a checkout
that does not count it) and K1's launches in the device trace.  Idle
gaps are labelled by the innermost span around them, ``hzt.curved.*``
(planarisation, lattice, upload, read-back) and ``hzt.tin.*`` among
them.

    python tools/trace_check.py --workload dhm25_hz --seed 5 \\
        [--seconds 51] [--out build/trace_check] [--no-wrappers] \\
        [--dump 3]

Runs the checkout it is started from (the working directory), so a copy
of another commit can be measured with this file:
``cd build/parent && python ../../tools/trace_check.py ...``.  Prints one
JSON line and writes it, with the per-span table, to
``<out>/<workload>_<seed>.json``.  Needs a CUDA card.
"""

import argparse
import importlib
import json
import os
import sys
import time
import types

T_START = time.perf_counter()
sys.path.insert(0, os.getcwd())

from hzbench import program_spans  # noqa: E402

ROOTS = ("hzt.pipeline.run", "hzt.terrain.query", "hzt.curved.run")


def union_us(intervals):
    """The length of the union of ``intervals`` (start, end)."""
    total, end = 0.0, None
    for t0, t1 in sorted(intervals):
        if end is None or t0 > end:
            total += t1 - t0
            end = t1
        elif t1 > end:
            total += t1 - end
            end = t1
    return total


def cover(ann):
    """Per root name: calls, milliseconds per call, and the share of its
    time no other ``hzt.*`` span inside it covers [%]."""
    spans = [a for a in ann if a[0].startswith("hzt.")]
    kids = sorted((t0, t1) for n, t0, t1 in spans if n not in ROOTS)
    out = {}
    for root in ROOTS:
        mine = [(t0, t1) for n, t0, t1 in spans if n == root]
        if not mine:
            continue
        dur = sum(t1 - t0 for t0, t1 in mine)
        inside = [(max(c0, t0), min(c1, t1)) for t0, t1 in mine
                  for c0, c1 in kids if c0 < t1 and c1 > t0]
        out[root] = {"calls": len(mine), "ms_per_call": dur / len(mine) / 1e3,
                     "uncovered_pct": 100.0 * (dur - union_us(inside)) / dur}
    return out


def dump(parsed, n):
    """The annotations and device operations of the first ``n`` traced
    calls, each ``(name, start, end)`` in microseconds from the call's
    start (device operations ``(name, category, start, end)``)."""
    calls = sorted((t0, t1) for name, t0, t1 in parsed["ann"]
                   if name == program_spans.CALL)[:n]
    out = []
    for c0, c1 in calls:
        out.append({
            "ann": sorted([name, t0 - c0, t1 - c0]
                          for name, t0, t1 in parsed["ann"]
                          if c0 <= t0 and t1 <= c1),
            "dev": [[name[:40], cat, t0 - c0, t1 - c0]
                    for name, cat, t0, t1 in parsed["dev"]
                    if c0 <= t0 < c1]})
    return out


def routes():
    """The gridded-horizon entry's route counts over the traced calls, by
    the checkout's route names (``profiling.ROUTES``), or None where the
    checkout does not count them."""
    try:
        from horayzon_tpu_torch.utils import profiling
        return profiling.routes()
    except (ImportError, AttributeError):
        return None


def launches():
    """The launches made so far by this process of the planarisation, the
    geometry and the TIN far field kernel, by name, each None where the
    checkout has no such kernel."""
    counts = {}
    for name in ("planarize", "geometry", "tin_raster"):
        try:
            counts[name] = importlib.import_module(
                f"horayzon_tpu_torch.ops.{name}").KERNEL_LAUNCHES
        except ImportError:
            counts[name] = None
    return counts


def tin_counts():
    """The triangles the TIN runs rasterised over the traced calls
    (``profiling.tin()``), or None where the checkout does not count
    them."""
    try:
        from horayzon_tpu_torch.utils import profiling
        return profiling.tin()
    except (ImportError, AttributeError):
        return None


def lattice_per_inner():
    """Lattice cells swept per inner cell over the traced curved runs, or
    None where the checkout does not count them or no curved run was
    traced."""
    try:
        from horayzon_tpu_torch.utils import profiling
        n = profiling.lattice()
    except (ImportError, AttributeError):
        return None
    return n["box_cells"] / n["inner_cells"] if n["inner_cells"] else None


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--out", default="build/trace_check")
    ap.add_argument("--no-wrappers", action="store_true",
                    help="run without the benchmark's wrapper spans "
                    "(harness.SPANS), so only the program's spans remain")
    ap.add_argument("--dump", type=int, default=0,
                    help="write the annotations and device operations of "
                    "the first DUMP calls, in microseconds from each "
                    "call's start")
    args = ap.parse_args()

    import torch
    from hzbench import harness, trace

    wrappers = {name for _, _, name in harness.SPANS}

    if not torch.cuda.is_available():
        print("trace_check: needs a CUDA card", file=sys.stderr)
        return 2
    kept = {}
    start, close, stop = trace.Tracer.start, trace.Tracer.close, \
        trace.Tracer.stop

    def count_start(self):
        kept["launches_at_start"] = launches()
        start(self)

    def count_close(self):
        if self.active:
            kept["launches_at_close"] = launches()
        close(self)

    def keep_stop(self):
        kept["trace"] = stop(self)
        return kept["trace"]

    per_layer = harness.Manifest.per_layer
    if args.no_wrappers:
        harness.SPANS = ()
    trace.Tracer.start, trace.Tracer.close = count_start, count_close
    trace.Tracer.stop = keep_stop
    harness.Manifest.per_layer = (
        lambda self, cell: per_layer(self, cell) + self.end_to_end(cell))
    res = harness.run_cell(args.workload, args.seed, args.seconds, True,
                           t_start=T_START)
    parsed = kept["trace"]
    ann = parsed["ann"]
    names = sorted({n for n, _, _ in ann if n.startswith("hzt.")})
    ctx = types.SimpleNamespace(trace=parsed)
    span_ms = {n: program_spans.ms_per_call(ctx, n) for n in names}
    gaps = trace.breakdown(parsed, top=1000)["idle_gaps"]
    idle = sum(s for _, s in gaps)
    summary = {
        "workload": args.workload, "seed": args.seed,
        "device": res["device"], "correct": res["correct"],
        "metrics": {n: m["value"] for n, m in res["metrics"].items()},
        "calls_traced": parsed["calls"], "routes": routes(),
        "k1_launches": sum(1 for n, cat, _, _ in parsed["dev"]
                           if cat == "kernel" and trace.K1 in n),
        **{f"{name}_launches": (
            None if at_start is None
            else kept["launches_at_close"][name] - at_start)
           for name, at_start in kept.get("launches_at_start", {}).items()},
        "lattice_per_inner": lattice_per_inner(),
        "tin": tin_counts(),
        "roots": cover(ann),
        "idle_s": idle,
        "idle_under_wrappers_pct": 100.0 * sum(
            s for n, s in gaps if n in wrappers) / idle if idle else 0.0,
        "idle_gaps": gaps[:12]}
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"{args.workload}_{args.seed}.json"),
              "w") as f:
        json.dump(dict(summary, span_ms_per_call=span_ms,
                       breakdown=res["breakdown"],
                       calls=dump(parsed, args.dump)), f, indent=1)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
