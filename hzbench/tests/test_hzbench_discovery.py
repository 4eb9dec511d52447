"""A configuration, a traffic mix and a per-layer metric added as new
files, with entries in BENCHMARK.json, are found by name: no existing
file is edited.  So are a scene generator and a traffic kind (a driver
with its control) of files of their own; a name both built in and of a
file, or of neither, is an error."""

import json
import shutil
import subprocess
import sys
import textwrap

import pytest

from conftest import ROOT, SMALL
from hzbench import harness


def test_new_files_are_found_by_name(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "hzbench", tmp_path / "hzbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    hz = tmp_path / "hzbench"
    cfg = json.loads((hz / "configs" / "dhm25_planar.json").read_text())
    cfg.update(SMALL["dhm25_hz"], name="tiny_planar", azim_num=8)
    (hz / "configs" / "tiny_planar.json").write_text(json.dumps(cfg))
    traffic = json.loads((hz / "traffic" / "horizon_calls.json").read_text())
    traffic["why"] = "two calls' worth of the main path"
    (hz / "traffic" / "horizon_twice.json").write_text(json.dumps(traffic))
    (hz / "metrics" / "calls_done.tiny.py").write_text(textwrap.dedent("""
        def read(ctx):
            return float(len(ctx.calls))
    """))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny_planar", "source": "x",
                             "file": "hzbench/configs/tiny_planar.json",
                             "reduced": ["domain"], "why": "a test"})
    bench["workloads"].append({"name": "tiny.hz", "config": "tiny_planar",
                               "traffic": "horizon_twice", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "horizon_rate":
            m["workloads"].append("tiny.hz")
    bench["per_layer"].append({"name": "calls_done.tiny", "unit": "calls",
                               "better": "higher", "source": "host_clock",
                               "layer": "harness", "moves": "horizon_rate",
                               "workloads": ["tiny.hz"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = textwrap.dedent(f"""
        import json, sys, time
        sys.path[:0] = [{str(tmp_path)!r}, {str(ROOT)!r}]
        from hzbench import harness
        assert harness.ROOT == harness.pathlib.Path({str(tmp_path)!r})
        out = []
        for trace_on in (False, True):
            out.append(harness.run_cell("tiny.hz", 5, 0.2, trace_on,
                                        t_start=time.perf_counter(),
                                        device="cpu"))
        print(json.dumps(out))
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         text=True, capture_output=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    plain, traced = json.loads(res.stdout.strip().splitlines()[-1])
    assert plain["correct"] and traced["correct"]
    assert set(plain["metrics"]) == {"horizon_rate", "setup_s"}
    assert traced["metrics"]["calls_done.tiny"]["value"] >= 1.0
    assert traced["metrics"]["calls_done.tiny"]["unit"] == "calls"


TINY_SCENE = '''
"""A scene of its own file: the built-in DHM25-like terrain."""

from hzbench import scenes


def make(cfg, seed, device, dem=0):
    return scenes.dhm25_like(cfg, seed, device, dem=dem)
'''

TINY_KIND = '''
"""A traffic kind of its own file: the built-in horizon calls on a scene
found by name, unmasked, and their control."""

import numpy as np
import torch

from hzbench import drivers, harness, reference

CONTROL_CALLS = 1


class Driver(drivers.HorizonCalls):
    def __init__(self, *args):
        super().__init__(*args)
        self.make = harness.Manifest().scene(self.cfg["scene"])

    def dem(self, d):
        scene = (self.scene if d == 0 else
                 self.make(self.cfg, self.seed, self.device, dem=d))
        cells = drivers._check_cells(scene, self.cfg["check_blocks"],
                                     self.seed, self.device, None, d)
        return scene, None, cells


def control_readings(drv):
    """The bfloat16 reference at each call's sampled cells, judged as the
    program's answers are; its non-finite answers as the bad values."""
    out = {"bad_values": 0}
    for d, _ in drv.samples:
        dem = drv.dem(d)
        r = reference.horizon_reference(dem[0], dem[2], torch.bfloat16)
        sample = {n: v.float().cpu().numpy() for n, v in r.items()}
        out["bad_values"] += sum(int((~np.isfinite(v)).sum())
                                 for v in sample.values())
        for n, v in drv.gaps(dem, sample).items():
            out[n] = max(out.get(n, 0.0), v)
    return out
'''


def _copy(tmp_path):
    """BENCHMARK.json and hzbench/ copied under ``tmp_path``."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "hzbench", tmp_path / "hzbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path / "hzbench"


def test_new_scene_and_kind_are_found_by_name(tmp_path):
    hz = _copy(tmp_path)
    for folder, name, text in (("scene", "tiny_scene", TINY_SCENE),
                               ("driver", "tiny_kind", TINY_KIND)):
        (hz / folder).mkdir(exist_ok=True)
        (hz / folder / f"{name}.py").write_text(text)
    cfg = json.loads((hz / "configs" / "dhm25_planar.json").read_text())
    cfg.update(SMALL["dhm25_hz"], name="tiny_found", azim_num=8,
               scene="tiny_scene")
    (hz / "configs" / "tiny_found.json").write_text(json.dumps(cfg))
    traffic = json.loads((hz / "traffic" / "horizon_calls.json").read_text())
    traffic.update(kind="tiny_kind", why="a kind of its own file")
    (hz / "traffic" / "tiny_calls.json").write_text(json.dumps(traffic))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny_found", "source": "x",
                             "file": "hzbench/configs/tiny_found.json",
                             "reduced": ["domain"], "why": "a test"})
    bench["workloads"].append({"name": "tiny.kind", "config": "tiny_found",
                               "traffic": "tiny_calls", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("horizon_rate", "grid_ms.hz", "check_ms.hz"):
            m["workloads"].append("tiny.kind")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = textwrap.dedent(f"""
        import json, sys, time
        sys.path[:0] = [{str(tmp_path)!r}, {str(ROOT)!r}]
        from hzbench import control, harness
        assert harness.ROOT == harness.pathlib.Path({str(tmp_path)!r})
        out = [harness.run_cell("tiny.kind", 7, 0.2, trace_on,
                                t_start=time.perf_counter(), device="cpu")
               for trace_on in (False, True)]
        out.append(control.readings("tiny.kind", 7, device="cpu"))
        out.append(harness.forbidden_modules())
        print(json.dumps(out))
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         text=True, capture_output=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    plain, traced, (prog, ctrl), loaded = json.loads(
        res.stdout.strip().splitlines()[-1])
    assert plain["correct"] and traced["correct"], (plain, traced)
    assert set(plain["checks"]) == set(cfg["limits"])
    assert set(plain["metrics"]) == {"horizon_rate", "setup_s"}
    assert set(traced["metrics"]) == {"grid_ms.hz", "check_ms.hz"}
    assert all(v["value"] > 0.0 for v in traced["metrics"].values())
    limits = cfg["limits"]
    assert set(ctrl) == set(prog) == set(limits)
    assert all(v <= limits[n] for n, v in prog.items()), prog
    assert any(v > limits[n] for n, v in ctrl.items()), ctrl
    assert loaded == []


_BUILT_IN = {"scene": ("dhm25_like", "hzbench/scenes.py"),
             "driver": ("horizon_calls", "hzbench/drivers.py")}


@pytest.mark.parametrize("folder", sorted(_BUILT_IN))
def test_built_in_name_with_a_file_raises(tmp_path, folder):
    hz = _copy(tmp_path)
    name, where = _BUILT_IN[folder]
    (hz / folder).mkdir(exist_ok=True)
    path = hz / folder / f"{name}.py"
    path.write_text("make = Driver = None\n")
    man = harness.Manifest(tmp_path)
    with pytest.raises(ValueError) as err:
        getattr(man, folder)(name)
    assert where in str(err.value) and str(path) in str(err.value)


@pytest.mark.parametrize("folder", sorted(_BUILT_IN))
def test_unknown_name_raises_naming_both_places(tmp_path, folder):
    _copy(tmp_path)
    man = harness.Manifest(tmp_path)
    with pytest.raises(KeyError) as err:
        getattr(man, folder)("no_such")
    msg = err.value.args[0]
    assert _BUILT_IN[folder][1] in msg
    assert str(tmp_path / "hzbench" / folder / "no_such.py") in msg
