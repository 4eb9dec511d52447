"""BENCHMARK.json against the benchmark's contract, and every name it
gives found as a file."""

import json
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(BENCH) == TOP_KEYS
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(_line(w) and not w.startswith("/") and ".." not in w
               for w in BENCH["command"])
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p)
        assert not p.endswith("_torch")
    assert any(w.startswith(tuple(BENCH["paths"]))
               for w in BENCH["command"][1:])


@pytest.mark.parametrize("part,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
])
def test_entries_have_exactly_their_keys(part, keys):
    for e in BENCH[part]:
        assert set(e) == keys, e["name"]
        assert NAME.match(e["name"])
        assert _line(e["why"])


def test_metric_entries():
    names = []
    for kind in ("end_to_end", "per_layer"):
        for m in BENCH[kind]:
            base = {"name", "unit", "better", "source"}
            base |= {"bound"} if kind == "end_to_end" else {"layer", "moves"}
            assert set(m) - {"workloads"} == base, m["name"]
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher")
            assert m["source"] in SOURCES
            names.append(m["name"])
    assert len(names) == len(set(names))
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert _line(m["layer"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_name_is_a_file_under_paths():
    paths = [ROOT / p for p in BENCH["paths"]]
    for c in BENCH["configs"]:
        f = ROOT / c["file"]
        assert f.is_file() and any(p in f.parents for p in paths)
        assert json.loads(f.read_text())["name"] == c["name"]
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        traffic = ROOT / "hzbench" / "traffic" / f"{w['traffic']}.json"
        assert traffic.is_file()
        assert w["config"] in {c["name"] for c in BENCH["configs"]}
        assert w["chips"] == 1
    metrics = ROOT / "hzbench" / "metrics"
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert ((metrics / f"{m['name']}.py").is_file()
                or (metrics / f"{m['name'].split('.')[0]}.py").is_file())


def test_each_cell_reports_what_its_layers_move():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(BENCH["workloads"])
    for w in BENCH["workloads"]:
        mine = {n for n, m in e2e.items()
                if w["name"] in m.get("workloads", [w["name"]])}
        assert "setup_s" in mine and len(mine) >= 2, w["name"]
        layer = [m for m in BENCH["per_layer"] if w["name"] in m["workloads"]]
        assert layer, w["name"]
        for m in layer:
            assert m["moves"] in mine, (w["name"], m["name"])
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= {w["name"] for w in BENCH["workloads"]}


def test_configs_are_used_and_limits_cover_the_checks():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["precision"] and cfg["reference"]
        assert cfg["limits"]["bad_values"] == 0
        assert all(v >= 0 for v in cfg["limits"].values())
