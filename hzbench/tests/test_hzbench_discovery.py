"""A configuration, a traffic mix and a per-layer metric added as new
files, with entries in BENCHMARK.json, are found by name: no existing
file is edited."""

import json
import shutil
import subprocess
import sys
import textwrap

from conftest import ROOT, SMALL


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
