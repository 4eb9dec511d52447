"""The spans and counters of ``CurvedPipeline.run`` (``horayzon_tpu_torch.
utils.profiling``): under ``torch.profiler`` a run emits each of its spans
once, nested under ``hzt.curved.run`` as listed below, counts the route
``curved_tilt`` once and the lattice box's cells against the inner cells;
its outputs are bit-equal to an untraced run's.  On the CPU, where the
plain sweep stands in for K1."""

import json

import pytest
import torch

from horayzon_tpu_torch import horizon
from horayzon_tpu_torch.utils import profiling

from torch_scenes import curved_pipeline_scene

#: Each run's spans in the order they start, and each one's parent.
CURVED_SPANS = (
    ("hzt.curved.run", None),
    ("hzt.curved.geometry", "hzt.curved.run"),
    ("hzt.horizon.check", "hzt.curved.run"),
    ("hzt.curved.planarize", "hzt.curved.run"),
    ("hzt.curved.lattice", "hzt.curved.run"),
    ("hzt.curved.upload", "hzt.curved.run"),
    ("hzt.sweep.prepare", "hzt.curved.run"),
    ("hzt.sweep.k1", "hzt.curved.run"),
    ("hzt.sweep.angles", "hzt.curved.run"),
    ("hzt.curved.readback", "hzt.curved.run"),
    ("hzt.curved.topo", "hzt.curved.run"),
    ("hzt.curved.outputs", "hzt.curved.run"),
)


def _annotations(prof, tmp_path):
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ann = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
           for e in events if e.get("cat") == "user_annotation"]
    return sorted(ann, key=lambda a: (a[1], -a[2]))


def _parent(spans, s):
    outer = [p for p in spans if p is not s and p[1] <= s[1]
             and s[2] <= p[2]]
    return min(outer, key=lambda p: p[2] - p[1])[0] if outer else None


@pytest.fixture(scope="module")
def traced_run(tmp_path_factory):
    """(untraced outputs, traced outputs, spans, routes, lattice counts,
    the pipeline) of one small curved run each."""
    plain = curved_pipeline_scene()[0].run()
    pipe, _ = curved_pipeline_scene()
    profiling.reset_counters()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            traced = pipe.run()
        routes, lattice = profiling.routes(), profiling.lattice()
    finally:
        profiling.reset_counters()
    spans = [a for a in _annotations(prof, tmp_path_factory.mktemp("t"))
             if a[0].startswith("hzt.")]
    return plain, traced, spans, routes, lattice, pipe


def test_curved_run_emits_its_spans_nested(traced_run):
    _, _, spans, _, _, _ = traced_run
    assert [s[0] for s in spans] == [w[0] for w in CURVED_SPANS]
    assert [_parent(spans, s) for s in spans] == [w[1] for w in CURVED_SPANS]
    kids = spans[1:]
    assert all(a[2] <= b[1] for a, b in zip(kids, kids[1:]))


def test_curved_run_counts_its_route_and_lattice(traced_run):
    _, _, _, routes, lattice, pipe = traced_run
    assert routes == {r: int(r == "curved_tilt") for r in profiling.ROUTES}
    lat = horizon.curved_lattice(pipe.x, pipe.y, pipe.z, pipe.vec_norm,
                                 pipe.offset_0, pipe.offset_1, device="cpu")
    i_lo, i_hi, j_lo, j_hi = lat["box"]
    assert lattice == {"box_cells": (i_hi - i_lo) * (j_hi - j_lo),
                       "inner_cells": pipe.vec_norm[..., 0].size}
    assert lattice["box_cells"] > 0


def test_traced_outputs_bit_equal_to_untraced(traced_run):
    plain, traced, _, _, _, _ = traced_run
    assert set(plain) == set(traced)
    for key in plain:
        assert torch.equal(plain[key], traced[key]), key


def test_untraced_curved_run_counts_nothing():
    profiling.reset_counters()
    curved_pipeline_scene()[0].run()
    assert profiling.routes() == dict.fromkeys(profiling.ROUTES, 0)
    assert profiling.lattice() == dict.fromkeys(profiling.LATTICE_FIELDS, 0)
