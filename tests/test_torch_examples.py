"""The port's example workflows (``examples/torch/``).

* Every script imports only the port, numpy, torch, the standard library
  and its helper ``common`` (``examples/plots_util.py`` under ``--plot``):
  its import statements are parsed, then all scripts are run with
  ``--help`` in one fresh interpreter, which must load no ``jax`` and no
  ``horayzon_tpu``.
* ``examples/torch/verify_drive.py --device cpu`` runs to its end with
  every printed check met; asked for ``cuda`` with no CUDA device, a
  script exits with a message instead of falling back to the CPU.

The scripts' defaults run on the card: ``chip_smoke.py`` phase P runs
four of them and ``verify_drive.py`` as subprocesses.

CPU cost: about 20 s of wall on one core (verify_drive's plain sweeps
on one thread about 12 s of it, three fresh interpreters the rest).
"""

import ast
import glob
import os
import subprocess
import sys

import pytest
import torch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_EXAMPLES = os.path.join(_REPO, "examples", "torch")
SCRIPTS = sorted(os.path.relpath(p, _EXAMPLES) for p in
                 glob.glob(os.path.join(_EXAMPLES, "**", "*.py"),
                           recursive=True))
#: The reference's ten workflows, each with a port of the same name.
WORKFLOWS = sorted(os.path.relpath(p, os.path.join(_REPO, "examples"))
                   for d in ("horizon", "shadow") for p in
                   glob.glob(os.path.join(_REPO, "examples", d, "*.py")))
ALLOWED = {"argparse", "ast", "glob", "json", "math", "os", "sys", "time",
           "numpy", "torch", "horayzon_tpu_torch", "common", "plots_util"}


def _env():
    """The environment of a script's process: no PYTHONPATH (the scripts
    find the repository themselves) and one CPU thread: the test workers
    already use every core, and a second full thread pool beside them
    slows the drive down many times over."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    return env


def test_every_workflow_has_a_port():
    assert len(WORKFLOWS) == 10
    for name in WORKFLOWS:
        assert name in SCRIPTS, name
    assert "verify_drive.py" in SCRIPTS and "common.py" in SCRIPTS


@pytest.mark.parametrize("name", SCRIPTS)
def test_script_imports_only_the_port(name):
    with open(os.path.join(_EXAMPLES, name)) as f:
        tree = ast.parse(f.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            roots.add(node.module.split(".")[0])
    assert roots <= ALLOWED, sorted(roots - ALLOWED)


def test_scripts_load_no_jax():
    code = r"""
import runpy, sys
bad = {}
for path in sys.argv[1:]:
    sys.argv = [path, "--help"]
    try:
        runpy.run_path(path, run_name="__main__")
    except SystemExit as e:
        assert e.code in (0, None), (path, e.code)
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "horayzon_tpu"))
    if loaded:
        bad[path] = loaded
print("BAD", bad)
sys.exit(1 if bad else 0)
"""
    paths = [os.path.join(_EXAMPLES, n) for n in SCRIPTS
             if n != "common.py"]
    res = subprocess.run([sys.executable, "-c", code, *paths], cwd=_REPO,
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert res.stdout.count("usage:") == len(paths)


def test_verify_drive_on_cpu():
    res = subprocess.run(
        [sys.executable, os.path.join(_EXAMPLES, "verify_drive.py"),
         "--device", "cpu"], cwd=_REPO, env=_env(), capture_output=True,
        text=True, timeout=600)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert "CHECK FAILED" not in res.stdout
    assert res.stdout.count("check ok:") == 8
    assert "ALL VERIFICATION DRIVES COMPLETED" in res.stdout


def test_cuda_device_without_a_card_exits(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is available")
    res = subprocess.run(
        [sys.executable,
         os.path.join(_EXAMPLES, "shadow", "gridded_planar_dem_artificial.py"),
         "--out", str(tmp_path)], cwd=_REPO, env=_env(),
        capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr
    assert not os.listdir(tmp_path)
