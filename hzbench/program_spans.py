"""What a ``--trace 1`` run reads from the program itself: its spans
(``hzt.*``, ``horayzon_tpu_torch.utils.profiling.span``: user annotations
in the device trace, on its clock) and the sample counters of K1 and K2
(``horayzon_tpu_torch.utils.profiling.counters``, counted only while the
profiler runs, so over the traced calls).

A program without them (one older than its spans) gives nothing to read:
every function here returns None then, and raises nothing.
"""

import bisect

CALL = "hzb.call"


def in_calls(trace, names):
    """The annotations named in ``names`` that lie inside a traced call
    (the benchmark's ``hzb.call``), and the number of traced calls."""
    calls = sorted((t0, t1) for n, t0, t1 in trace["ann"] if n == CALL)
    starts = [c[0] for c in calls]
    out = []
    for name, t0, t1 in trace["ann"]:
        if name in names:
            i = bisect.bisect_right(starts, t0) - 1
            if i >= 0 and t1 <= calls[i][1]:
                out.append((name, t0, t1))
    return out, len(calls)


def ms_per_call(ctx, *names):
    """Milliseconds per traced call of the spans ``names``, summed; None
    where the trace holds none of them."""
    if ctx.trace is None:
        return None
    spans, calls = in_calls(ctx.trace, set(names))
    if not spans:
        return None
    return sum(t1 - t0 for _, t0, t1 in spans) / calls / 1e3


def copies(trace):
    """(start, end) [us] of the device's copies (``gpu_memcpy``), sorted."""
    return sorted((c0, c1) for _, cat, c0, c1 in trace["dev"]
                  if cat == "gpu_memcpy")


def copy_us(copied, t0, t1):
    """Device microseconds of the ``copied`` intervals (:func:`copies`)
    inside ``[t0, t1]``, each clipped to it."""
    # from the last copy that started before t0: it may run on inside
    i = max(bisect.bisect_left(copied, (t0,)) - 1, 0)
    us = 0.0
    for c0, c1 in copied[i:]:
        if c0 >= t1:
            break
        us += max(0.0, min(c1, t1) - max(c0, t0))
    return us


def host_ms_per_call(ctx, name):
    """Milliseconds per traced call of the spans ``name`` less the device
    time of the copies inside them: the host's share of a read-back."""
    if ctx.trace is None:
        return None
    spans, calls = in_calls(ctx.trace, {name})
    if not spans:
        return None
    copied = copies(ctx.trace)
    host = sum(t1 - t0 - copy_us(copied, t0, t1) for _, t0, t1 in spans)
    return host / calls / 1e3


def taken_pct(kernel):
    """100 x the samples ``kernel`` ("k1", "k2") took over those it took
    and skipped, in the launches made while the profiler ran; None where
    it counted nothing (no launch, the CPU, a program without counters)."""
    try:
        from horayzon_tpu_torch.utils import profiling
        counts = profiling.counters()[kernel]
    except (ImportError, AttributeError, KeyError):
        return None
    total = sum(counts.values())
    if not total:
        return None
    return 100.0 * (counts["d1_taken"] + counts["mip_taken"]) / total
