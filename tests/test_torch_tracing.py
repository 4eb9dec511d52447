"""The port's spans and sample counters (``horayzon_tpu_torch.utils.
profiling``): under ``torch.profiler`` a ``PlanarPipeline.run`` and a
``Terrain.sw_dir_cor(sun, buffer)`` emit each span of their path once,
nested as listed below (``hzt.terrain.sun_table`` twice: the sun's checks,
then its table); no span but the two roots encloses an entry the
benchmark wraps in spans of its own (``hzbench/harness.py::SPANS``), so
the benchmark's idle-time labels fall to the program's spans; a traced
``PlanarPipeline.run`` counts the entry's route once; with the profiler off no
``record_function`` is entered and nothing is counted.
On the CPU, where the plain sweeps stand in for the kernels."""

import functools
import json
import os
import sys

import numpy as np
import pytest
import torch

from horayzon_tpu_torch import shadow
from horayzon_tpu_torch.models import PlanarPipeline
from horayzon_tpu_torch.utils import profiling

from torch_scenes import planar_pipeline_scene, sun_track_terrain_inputs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from hzbench import harness  # noqa: E402

ROOTS = ("hzt.pipeline.run", "hzt.terrain.query")
#: Each call's spans in the order they start, and each one's parent.
PIPELINE_SPANS = (
    ("hzt.pipeline.run", None),
    ("hzt.pipeline.grid", "hzt.pipeline.run"),
    ("hzt.horizon.check", "hzt.pipeline.run"),
    ("hzt.horizon.upload", "hzt.pipeline.run"),
    ("hzt.sweep.prepare", "hzt.pipeline.run"),
    ("hzt.sweep.k1", "hzt.pipeline.run"),
    ("hzt.sweep.angles", "hzt.pipeline.run"),
    ("hzt.horizon.fill", "hzt.pipeline.run"),
    ("hzt.horizon.report", "hzt.pipeline.run"),
    ("hzt.pipeline.topo", "hzt.pipeline.run"),
    ("hzt.pipeline.outputs", "hzt.pipeline.run"),
)
STEP_SPANS = (
    ("hzt.terrain.query", None),
    ("hzt.terrain.sun_table", "hzt.terrain.query"),
    ("hzt.terrain.sun_table", "hzt.terrain.query"),
    ("hzt.shadow.args", "hzt.terrain.query"),
    ("hzt.shadow.k2", "hzt.terrain.query"),
    ("hzt.terrain.occluded", "hzt.terrain.query"),
    ("hzt.terrain.classify", "hzt.terrain.query"),
    ("hzt.terrain.readback", "hzt.terrain.query"),
)
ENTERED = "entered:"


def _pipeline_call():
    """A small masked ``PlanarPipeline.run`` on the CPU (the mask has
    zeros, so the fill runs)."""
    n, dx = 80, 25.0
    rng = np.random.default_rng(3)
    z = rng.uniform(0.0, 50.0, (n, n)).astype(np.float32)
    x = np.arange(n, dtype=np.float32) * dx
    y = (n - 1 - np.arange(n, dtype=np.float32)) * dx
    pad = 400.0
    domain = {"x_min": float(x.min()) + pad, "x_max": float(x.max()) - pad,
              "y_min": float(y.min()) + pad, "y_max": float(y.max()) - pad}
    pipe = PlanarPipeline(x, y, z, domain, dist_search=0.3, azim_num=8,
                          device="cpu")
    in0 = pipe.slice_in[0].stop - pipe.slice_in[0].start
    in1 = pipe.slice_in[1].stop - pipe.slice_in[1].start
    mask = np.ones((in0, in1), dtype=np.uint8)
    mask[:5] = 0
    return lambda: pipe.run(mask=mask)


def _step_call():
    """One ``Terrain.sw_dir_cor(sun, buffer)`` step on the CPU."""
    args, suns = sun_track_terrain_inputs()
    terrain = shadow.Terrain()
    terrain.initialise(*args, device="cpu")
    buffer = np.empty(args[5].shape[:2], dtype=np.float32)
    return lambda: terrain.sw_dir_cor(suns[2], buffer)


CALLS = {"pipeline": (_pipeline_call, PIPELINE_SPANS),
         "step": (_step_call, STEP_SPANS)}


def _annotations(prof, tmp_path):
    """The trace's user annotations ``(name, start, end)`` [us] in the
    order they start."""
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ann = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
           for e in events if e.get("cat") == "user_annotation"]
    return sorted(ann, key=lambda a: (a[1], -a[2]))


def _parent(spans, s):
    """The innermost other span that contains ``s``."""
    outer = [p for p in spans if p is not s and p[1] <= s[1]
             and s[2] <= p[2]]
    return min(outer, key=lambda p: p[2] - p[1])[0] if outer else None


def _traced(call, tmp_path):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        call()
    return _annotations(prof, tmp_path)


@pytest.mark.parametrize("which", sorted(CALLS))
def test_call_emits_its_spans_nested(which, tmp_path, capsys):
    make, want = CALLS[which]
    call = make()
    call()                                   # outside the trace: no spans
    spans = [a for a in _traced(call, tmp_path) if a[0].startswith("hzt.")]
    assert [s[0] for s in spans] == [w[0] for w in want]
    assert [_parent(spans, s) for s in spans] == [w[1] for w in want]
    # siblings do not overlap
    kids = spans[1:]
    assert all(a[2] <= b[1] for a, b in zip(kids, kids[1:]))


@pytest.mark.parametrize("which", sorted(CALLS))
def test_only_roots_enclose_the_benchmarks_entries(which, tmp_path,
                                                   monkeypatch, capsys):
    call = CALLS[which][0]()
    for mod_name, attr, name in harness.SPANS:
        owner, last = harness._attr_owner(mod_name, attr)
        orig = getattr(owner, last)

        def wrapper(*args, _orig=orig, _name=name, **kwargs):
            with torch.profiler.record_function(ENTERED + _name):
                pass
            return _orig(*args, **kwargs)

        monkeypatch.setattr(owner, last, functools.wraps(orig)(wrapper))
    ann = _traced(call, tmp_path)
    spans = [a for a in ann if a[0].startswith("hzt.")]
    entries = [a for a in ann if a[0].startswith(ENTERED)]
    # pipeline: run, horizon_sweep_fused; step: _run, the metric, _classify
    assert len(entries) == {"pipeline": 2, "step": 3}[which]
    for name, t, _ in entries:
        around = {s[0] for s in spans if s[1] <= t <= s[2]}
        assert around <= set(ROOTS), (name, around)


@pytest.mark.parametrize("which", sorted(CALLS))
def test_profiler_off_enters_no_record_function(which, monkeypatch, capsys):
    call = CALLS[which][0]()

    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with the profiler "
                             "off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not profiling.tracing()
    profiling.reset_counters()
    call()
    zero = dict.fromkeys(profiling.COUNTER_FIELDS, 0)
    assert profiling.counters() == {"k1": zero, "k2": zero}
    assert profiling.routes() == dict.fromkeys(profiling.ROUTES, 0)


#: The spans of each route that the benchmark's readers take.
ROUTE_SPANS = {"planar": {"hzt.pipeline.grid", "hzt.horizon.check",
                          "hzt.horizon.upload"},
               "curved_tilt": {"hzt.pipeline.grid", "hzt.horizon.check"}}


@pytest.mark.parametrize("route", sorted(ROUTE_SPANS))
def test_pipeline_counts_its_route(route, tmp_path, capsys):
    """Uniform axes take the planar route, an axis with one uneven spacing
    the curved one: each traced run counts its route once and emits the
    spans the benchmark reads; an untraced run counts nothing."""
    pipe, mask = planar_pipeline_scene(
        jitter=None if route == "planar" else "x", mask="patches")
    profiling.reset_counters()
    try:
        pipe.run(mask=mask)
        assert profiling.routes() == dict.fromkeys(profiling.ROUTES, 0)
        spans = {a[0] for a in _traced(
            lambda: [pipe.run(mask=mask) for _ in range(2)], tmp_path)}
        assert profiling.routes() == {r: 2 * (r == route)
                                      for r in profiling.ROUTES}
    finally:
        profiling.reset_counters()
    assert ROUTE_SPANS[route] <= spans


def test_span_and_counters_follow_the_profiler(tmp_path):
    assert not profiling.tracing()
    assert profiling.span("hzt.x") is profiling.span("hzt.y")
    assert profiling.launch_counters("k1", "cpu") is None
    profiling.reset_counters()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            assert profiling.tracing()
            with profiling.span("hzt.x"):
                pass
            k1 = profiling.launch_counters("k1", "cpu")
            assert profiling.launch_counters("k1", "cpu") is k1
            k2 = profiling.launch_counters("k2", torch.device("cpu"))
            assert k2 is not k1 and k1.dtype == torch.int64
            k1 += torch.tensor([3, 1, 4, 1])
            k2[2] += 5
        assert not profiling.tracing()
        assert profiling.launch_counters("k1", "cpu") is None
        got = profiling.counters()
        assert got["k1"] == dict(zip(profiling.COUNTER_FIELDS, (3, 1, 4, 1)))
        assert got["k2"] == dict(zip(profiling.COUNTER_FIELDS, (0, 0, 5, 0)))
        assert [a[0] for a in _annotations(prof, tmp_path)] == ["hzt.x"]
    finally:
        profiling.reset_counters()
    assert sum(profiling.counters()["k1"].values()) == 0
