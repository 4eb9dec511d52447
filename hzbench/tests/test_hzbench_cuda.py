"""On the card: one short run of each cell through the command, its
result line, and the control's readings on one seed.  Run there with
``python -m pytest -m cuda hzbench/tests/test_hzbench_cuda.py``."""

import json
import subprocess
import sys

import pytest
import torch

from conftest import CPU_CELLS, ROOT

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.parametrize("workload", CPU_CELLS)
@pytest.mark.parametrize("trace_on", [0, 1])
def test_cell_runs_correct_on_the_card(card, workload, trace_on):
    out = subprocess.run([sys.executable, "hzbench/run.py", "--workload",
                          workload, "--seed", str(2 ** 31 + 7), "--seconds",
                          "2", "--trace", str(trace_on)], cwd=ROOT,
                         text=True, capture_output=True, timeout=360)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert res["metrics"]
    if trace_on:
        assert 0.0 < res["device"]["busy_s"] <= res["device"]["window_s"]
        assert res["breakdown"]["device_ops"]
        assert all(v["value"] <= 105.0 for n, v in res["metrics"].items()
                   if n.endswith("_roofline"))


@pytest.mark.parametrize("workload", ["dhm25_hz", "hemi_track_batch"])
def test_control_fails_on_the_card(card, workload):
    from hzbench import control, harness
    prog, ctrl = control.readings(workload, 99)
    man = harness.Manifest()
    limits = man.config(man.cell(workload))["limits"]
    assert all(v <= limits[n] for n, v in prog.items()), prog
    assert any(v > limits[n] for n, v in ctrl.items()), ctrl
