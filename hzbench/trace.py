"""Spans and the device trace of a ``--trace 1`` run.

Spans are the benchmark's own: :func:`wrap` replaces a module or class
attribute of the program by a wrapper that records the host clock at
entry and exit and marks the interval in the profiler's trace
(``torch.profiler.record_function``).  The device trace is
``torch.profiler``'s (CUPTI), exported as a Chrome trace to a temporary
file under ``TMPDIR``, read back and deleted.
"""

import functools
import json
import os
import tempfile
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "hzb.window"
#: The sweep kernels of ``csrc/horizon_sweep.cu`` by their names in the
#: trace: K1 (horizon mode, its mask variant too) and K2 (shadow mode).
K1 = "horizon_sweep_kernel<false, false>"
K2 = "horizon_sweep_kernel<false, true>"


class Spans:
    """Host-clock spans of wrapped program calls, and the wrappers'
    undo list."""

    def __init__(self):
        self.log = []          # (name, t_enter, t_exit)
        self._undo = []

    def wrap(self, owner, attr, name):
        orig = getattr(owner, attr)

        @functools.wraps(orig)
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            with torch.profiler.record_function(name):
                out = orig(*args, **kwargs)
            self.log.append((name, t0, time.perf_counter()))
            return out

        setattr(owner, attr, wrapper)
        self._undo.append((owner, attr, orig))

    def unwrap(self):
        for owner, attr, orig in reversed(self._undo):
            setattr(owner, attr, orig)
        self._undo.clear()


class Tracer:
    """``torch.profiler`` over the first ``max_calls`` calls of the
    window; :meth:`stop` returns the parsed trace (:func:`parse`)."""

    def __init__(self, max_calls):
        self.max_calls = max_calls
        self.prof = None
        self.window = None
        self.calls = 0

    def start(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        self.window = torch.profiler.record_function(WINDOW)
        self.window.__enter__()

    @property
    def active(self):
        return self.window is not None

    def count_call(self):
        """After a call: stop tracing once ``max_calls`` are traced."""
        if self.active:
            self.calls += 1
            if self.calls >= self.max_calls:
                self.close()

    def close(self):
        if self.active:
            self.window.__exit__(None, None, None)
            self.window = None
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self.prof.stop()

    def stop(self):
        """Close the trace and parse it."""
        self.close()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                trace = parse(json.load(f))
        finally:
            os.unlink(path)
        trace["calls"] = self.calls
        return trace


def parse(chrome):
    """From a Chrome trace: the traced window (start, end) [us], the
    device operations ``(name, cat, start, end)`` inside it (clipped),
    and the benchmark's annotations ``(name, start, end)``."""
    events = chrome["traceEvents"]
    ann = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
           for e in events if e.get("cat") == "user_annotation"]
    win = [a for a in ann if a[0] == WINDOW]
    if not win:
        raise RuntimeError("the trace holds no window annotation")
    w0, w1 = win[0][1], win[0][2]
    dev = []
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        t0 = float(e["ts"])
        t1 = t0 + float(e.get("dur", 0.0))
        if t1 <= w0 or t0 >= w1:
            continue
        dev.append((e["name"], e["cat"], max(t0, w0), min(t1, w1)))
    dev.sort(key=lambda d: d[2])
    return {"window": (w0, w1), "dev": dev,
            "ann": [a for a in ann if a[0] != WINDOW]}


def busy_intervals(trace):
    """The union of the device operations' intervals, sorted."""
    out = []
    for _, _, t0, t1 in trace["dev"]:
        if out and t0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t1)
        else:
            out.append([t0, t1])
    return out


def busy_s(trace):
    return sum(t1 - t0 for t0, t1 in busy_intervals(trace)) * 1e-6


def window_s(trace):
    w0, w1 = trace["window"]
    return (w1 - w0) * 1e-6


def kernel_us(trace, name, other=False):
    """Device microseconds of the kernels whose name holds ``name`` (with
    ``other``: of every other kernel)."""
    return sum(t1 - t0 for n, cat, t0, t1 in trace["dev"]
               if cat == "kernel" and (name in n) != other)


def idle_pct(trace):
    """The share of the traced window in which the device ran nothing."""
    return 100.0 * (1.0 - busy_s(trace) / window_s(trace))


def idle_gaps(trace):
    """(start, end) [us] of every interval of the window in which no
    device operation runs."""
    w0, w1 = trace["window"]
    gaps, t = [], w0
    for b0, b1 in busy_intervals(trace):
        if b0 > t:
            gaps.append((t, b0))
        t = max(t, b1)
    if t < w1:
        gaps.append((t, w1))
    return gaps


def breakdown(trace, top=10):
    """The device operations that took most time (summed by name) and
    the idle time by the innermost span the host was in at each gap's
    middle, each the ``top`` largest, in seconds."""
    by_op = {}
    for name, _, t0, t1 in trace["dev"]:
        by_op[name] = by_op.get(name, 0.0) + (t1 - t0) * 1e-6
    ann = sorted(trace["ann"], key=lambda a: a[2] - a[1])
    by_span = {}
    for g0, g1 in idle_gaps(trace):
        mid = 0.5 * (g0 + g1)
        label = next((a[0] for a in ann if a[1] <= mid <= a[2]),
                     "between calls")
        by_span[label] = by_span.get(label, 0.0) + (g1 - g0) * 1e-6
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(by_span.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:120], s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gaps]}
