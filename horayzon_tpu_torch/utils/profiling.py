# Copyright (c) 2026
# MIT License
"""Structured timing and throughput instrumentation (counterpart of
:mod:`horayzon_tpu.utils.profiling`), and the port's own spans and sample
counters.

The reference instruments itself with wall-clock printfs (BVH build time
horizon_comp.cpp:225-227, ray-tracing time :802-805, rays shot and mean
rays/(cell,azimuth) :807-810).  This module provides the equivalent as
structured records plus a ``torch.profiler`` trace hook.

CUDA calls return before the card finishes, so :func:`sync` waits for
every CUDA device the given tensors live on; a wall time around work ends
in it.

Spans and counters record only while ``torch.profiler`` records
(:func:`tracing`).  A span (:func:`span`, names ``hzt.*``) is a user
annotation of the profiler: it lives in the profiler's memory, is written
out with its trace (:func:`profiler_trace`, or whoever runs the profiler)
and shares that trace's clock with the card's operations.  Calls run one
after another on one thread, so a span's parent is the span that contains
it.  While tracing, every launch of the sweep kernels K1 and K2 that its
caller gives no counters adds its sample counts to this module's counters
(:func:`counters`, :func:`reset_counters`), and every gridded horizon
(``horizon.gridded_planes``) counts the route it took
(:func:`count_route`, :func:`routes`); a curved run counts the cells it
swept (:func:`lattice`), a TIN run the triangles it rasterised (:func:`tin`).
With the profiler off a span is a shared no-op context and a launch or a
run counts nothing.  This module imports nothing of the port, so every
module of it may import this one.
"""

import contextlib
import dataclasses
import json
import os
import time

import torch
from torch.autograd import profiler as _autograd_profiler


def _tensors(x):
    """The tensors in ``x``: a tensor, or lists, tuples and dicts of them
    (other leaves are skipped)."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def sync(x):
    """Wait until the tensors in ``x`` are computed: one
    ``torch.cuda.synchronize`` per CUDA device they live on (CPU tensors
    are ready when returned).  Returns ``x``."""
    for dev in {t.device for t in _tensors(x) if t.is_cuda}:
        torch.cuda.synchronize(dev)
    return x


@dataclasses.dataclass
class SweepStats:
    """Throughput record for one horizon/shadow sweep."""
    wall_time_s: float
    cells: int
    azim_num: int
    samples_per_cell_azim: int

    @property
    def samples_per_s(self):
        return self.cells * self.azim_num * self.samples_per_cell_azim \
            / self.wall_time_s

    @property
    def rays_per_s_equivalent(self):
        """Reference-equivalent rays/s (the reference shoots ~2 rays per
        (cell, azimuth) with guess_constant, horizon_comp.cpp:807-810)."""
        return self.cells * self.azim_num * 2.0 / self.wall_time_s

    def to_json(self):
        return json.dumps({
            "wall_time_s": self.wall_time_s,
            "cells": self.cells,
            "azim_num": self.azim_num,
            "samples_per_cell_azim": self.samples_per_cell_azim,
            "samples_per_s": self.samples_per_s,
            "rays_per_s_equivalent": self.rays_per_s_equivalent,
        })


def time_sweep(fn, cells, azim_num, samples_per_cell_azim, iters=3):
    """Time ``fn`` (returning tensors) and build a SweepStats: the best
    wall time of ``iters`` synchronised calls after one warm-up call."""
    sync(fn())   # warm-up (kernel build and load on first use)
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        sync(fn())
        best = min(best, time.perf_counter() - t0)
    return SweepStats(wall_time_s=best, cells=cells, azim_num=azim_num,
                      samples_per_cell_azim=samples_per_cell_azim)


@contextlib.contextmanager
def profiler_trace(log_dir):
    """``torch.profiler`` trace around a block, written as one Chrome trace
    file (``trace_<pid>_<ns>.json``) into ``log_dir`` when the block ends.
    It records the CPU, and the card too whenever CUDA is available (a
    first CUDA call inside the block is traced as well), with the ``hzt.*``
    spans beside the card's operations.  A failure of the profiler
    raises."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir,
                        f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(path)


#: What a launch of K1 or K2 counts (the kernel's counter slots, in order):
#: (cell, azimuth or sun) samples of swept cells taken and skipped in the
#: d1 pairs (K1: the safe pairs; K2: the masked pairs too) and in the mip
#: phases.
COUNTER_FIELDS = ("d1_taken", "d1_skipped", "mip_taken", "mip_skipped")
#: The kernels :func:`counters` reports: K1 (every launch through
#: ``fused_sweep._ratio_cuda``) and K2 (``shadow_sweep._metric_cuda``).
COUNTED_KERNELS = ("k1", "k2")
_NO_SPAN = contextlib.nullcontext()
#: The routes :func:`routes` reports, the branches of
#: ``horizon.gridded_planes``: a regular grid with default vectors on the
#: fused sweep; an irregular grid through the planarised lattice and K1's
#: tilt ramp; a regular grid on the XLA engine; the simplified outer TIN.
ROUTES = ("planar", "curved_tilt", "xla", "tin")
#: What :func:`lattice` reports: the lattice cells of the boxes that the
#: curved runs swept, and the inner (lon/lat) cells they read back.
LATTICE_FIELDS = ("box_cells", "inner_cells")
#: (kernel, device) -> the (4,) int64 counts of the launches made while
#: tracing.
_counts = {}
#: route -> the runs that took it while tracing.
_route_counts = dict.fromkeys(ROUTES, 0)
#: field of :data:`LATTICE_FIELDS` -> cells, summed over the curved runs
#: made while tracing.
_lattice_counts = dict.fromkeys(LATTICE_FIELDS, 0)
#: The triangles that the TIN runs made while tracing rasterised.
_tin_counts = {"triangles": 0}


def tracing():
    """Whether ``torch.profiler`` records in this process: the one test
    every span and counted launch makes."""
    return _autograd_profiler._is_profiler_enabled


def span(name):
    """A context that marks ``name`` in the profiler's trace
    (``torch.profiler.record_function``) while :func:`tracing` holds, and
    a shared no-op context otherwise."""
    return torch.profiler.record_function(name) if tracing() else _NO_SPAN


def launch_counters(kernel, device):
    """The (4,) int64 tensor on ``device`` to which a launch of ``kernel``
    (one of :data:`COUNTED_KERNELS`) adds its counts while :func:`tracing`
    holds; None otherwise."""
    if not tracing():
        return None
    key = (kernel, torch.device(device))
    t = _counts.get(key)
    if t is None:
        t = _counts[key] = torch.zeros(len(COUNTER_FIELDS),
                                       dtype=torch.int64, device=device)
    return t


def counters():
    """``{kernel: {field: samples}}`` of the launches made while tracing
    since the last :func:`reset_counters`, summed over devices, fields in
    :data:`COUNTER_FIELDS` order.  Reads the counts back from the card, so
    it waits for the launches: call it after the work."""
    out = {k: dict.fromkeys(COUNTER_FIELDS, 0) for k in COUNTED_KERNELS}
    for (kernel, _), t in _counts.items():
        for field, v in zip(COUNTER_FIELDS, t.tolist()):
            out[kernel][field] += v
    return out


def count_route(route):
    """Count one run that took ``route`` (one of :data:`ROUTES`) while
    :func:`tracing` holds."""
    if tracing():
        _route_counts[route] += 1


def routes():
    """``{route: runs}`` of the runs made while tracing since the last
    :func:`reset_counters`, routes in :data:`ROUTES` order."""
    return dict(_route_counts)


def count_lattice(box_cells, inner_cells):
    """Count one curved run that swept ``box_cells`` lattice cells for
    ``inner_cells`` inner cells while :func:`tracing` holds."""
    if tracing():
        _lattice_counts["box_cells"] += int(box_cells)
        _lattice_counts["inner_cells"] += int(inner_cells)


def lattice():
    """``{field: cells}`` of the curved runs made while tracing since the
    last :func:`reset_counters`, fields in :data:`LATTICE_FIELDS` order."""
    return dict(_lattice_counts)


def count_tin(triangles):
    """Count the ``triangles`` one TIN run rasterised, while
    :func:`tracing` holds."""
    if tracing():
        _tin_counts["triangles"] += int(triangles)


def tin():
    """``{"triangles": sum}`` of the TIN runs made while tracing since the
    last :func:`reset_counters`."""
    return dict(_tin_counts)


def reset_counters():
    """Zero the counters of :func:`counters`, :func:`routes`,
    :func:`lattice` and :func:`tin`."""
    _counts.clear()
    _route_counts.update(dict.fromkeys(ROUTES, 0))
    _lattice_counts.update(dict.fromkeys(LATTICE_FIELDS, 0))
    _tin_counts["triangles"] = 0
