"""The readers of the program's own spans and counters
(``hzbench/program_spans.py``): a small traced run of each cell on the CPU
reads a number from every span metric of the cell, and none from the
counters (the plain sweeps count nothing); a program without the spans
or the counters gives no number and no error."""

import types

import pytest

from conftest import CPU_CELLS, run_small
from hzbench import harness, program_spans


def _metrics(workload, source):
    man = harness.Manifest()
    return [m["name"] for m in man.per_layer(man.cell(workload))
            if m["source"] == source]


@pytest.mark.parametrize("workload", CPU_CELLS)
def test_traced_run_reads_the_programs_spans(workload):
    res = run_small(workload, trace_on=True)
    assert res["correct"]
    got = res["metrics"]
    for name in _metrics(workload, "program_span"):
        assert got[name]["value"] > 0.0, name
    for name in _metrics(workload, "program_counter"):
        assert name not in got
    if workload.startswith("dhm25"):
        assert (got["grid_ms.hz"]["value"] + got["check_ms.hz"]["value"]
                <= got["prep_ms.hz"]["value"])


def _ctx(ann, dev=()):
    trace = {"window": (0.0, 1000.0), "dev": list(dev), "ann": ann,
             "calls": 2}
    return types.SimpleNamespace(trace=trace)


def test_readback_host_share_and_per_call_sums():
    ann = [("hzb.call", 0.0, 100.0), ("hzb.call", 200.0, 300.0),
           ("hzt.terrain.readback", 10.0, 60.0),
           ("hzt.terrain.readback", 210.0, 230.0),
           ("hzt.terrain.readback", 400.0, 450.0)]      # outside a call
    dev = [("k", "kernel", 5.0, 25.0), ("c", "gpu_memcpy", 5.0, 20.0),
           ("c", "gpu_memcpy", 50.0, 70.0), ("c", "gpu_memcpy", 215.0, 220.0)]
    ctx = _ctx(ann, dev)
    # wall 50 + 20, copies inside 10 + 10 and 5, over two calls
    assert program_spans.ms_per_call(ctx, "hzt.terrain.readback") == 0.035
    assert program_spans.host_ms_per_call(
        ctx, "hzt.terrain.readback") == pytest.approx(0.0225)


def test_no_spans_or_counters_give_no_number(monkeypatch):
    ctx = _ctx([("hzb.call", 0.0, 100.0), ("pipeline.run", 1.0, 90.0)])
    man = harness.Manifest()
    for m in man.bench["per_layer"]:
        if m["source"] == "program_span" and m["name"] != "prep_ms.hz":
            assert man.reader(m["name"])(ctx) is None, m["name"]
    from horayzon_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "counters")
    for name in ("k1_taken_pct", "k2_taken_pct"):
        assert man.reader(name)(ctx) is None
