# Copyright (c) 2026
# MIT License
"""Structured timing and throughput instrumentation (counterpart of
:mod:`horayzon_tpu.utils.profiling`).

The reference instruments itself with wall-clock printfs (BVH build time
horizon_comp.cpp:225-227, ray-tracing time :802-805, rays shot and mean
rays/(cell,azimuth) :807-810).  This module provides the equivalent as
structured records plus a ``torch.profiler`` trace hook.

CUDA calls return before the card finishes, so :func:`sync` waits for
every CUDA device the given tensors live on; a wall time around work ends
in it.
"""

import contextlib
import dataclasses
import json
import os
import time

import torch


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


@contextlib.contextmanager
def timed(label="", result_holder=None):
    """Context manager timing a device computation (callers must sync)."""
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    if result_holder is not None:
        result_holder.append(dt)
    if label:
        print(f"{label}: {dt:.3f} s")


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
    It records the CPU, and the card too when this process uses CUDA.  A
    failure of the profiler raises."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
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
