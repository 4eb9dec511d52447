"""No run loads JAX or the JAX package, compared by whole top-level
names; a run without the card, or without the program beside the
benchmark, prints no result."""

import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest
import torch

from conftest import ROOT
from hzbench import harness


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    for name in ("horayzon_tpu_torch_extra", "jaxtyping", "flaxen.x"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "horayzon_tpu.ops", sys)
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert harness.forbidden_modules() == ["horayzon_tpu.ops", "jax"]


def test_a_run_loads_no_jax():
    code = textwrap.dedent("""
        import json, sys
        sys.path.insert(0, "hzbench/tests")
        from conftest import run_small
        from hzbench import harness
        for w in ("dhm25_glacier", "hemi_track_steps"):
            assert run_small(w, trace_on=True)["correct"]
        print(json.dumps(harness.forbidden_modules()))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, text=True,
                         capture_output=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "hzbench/run.py", "--workload",
                          "dhm25_hz", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, text=True,
                         capture_output=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_benchmark_alone_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "hzbench", tmp_path / "hzbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = textwrap.dedent("""
        import sys, time
        sys.path.insert(0, ".")
        from hzbench import harness
        harness.run_cell("dhm25_hz", 1, 1.0, False,
                         t_start=time.perf_counter(), device="cpu")
        print("{}")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         text=True, capture_output=True, timeout=300,
                         env=env)
    assert out.returncode != 0
    assert "horayzon_tpu_torch" in out.stderr
    assert out.stdout.strip() == ""
