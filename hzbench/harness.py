"""One run of one cell, driven by ``BENCHMARK.json`` and the files it
names.

The cell's configuration is ``hzbench/configs/<config>.json`` (its
``scene`` names the scene generator, ``check_blocks`` the sample the
reference checks, ``limits`` the limit of each number compared); its
traffic mix is ``hzbench/traffic/<traffic>.json`` (its ``kind`` names the
driver); each metric is read by ``hzbench/metrics/<name>.py`` (or the
file of the name's part before its first dot), whose ``read(ctx)``
returns the value or None.

A scene name is found in :data:`hzbench.scenes.SCENES` or else as the
file ``hzbench/scene/<name>.py``, whose ``make(cfg, seed, device, dem=0)``
returns the scene; a traffic kind in :data:`hzbench.drivers.DRIVERS` or
else as the file ``hzbench/driver/<kind>.py``, whose ``Driver`` class
takes the built-in drivers' arguments and methods and which also gives
the control's ``CONTROL_CALLS`` and ``control_readings(drv)``
(:mod:`hzbench.control`).  A name found in both places, or in neither, is
an error.  So a later cell, mix, metric, scene or traffic kind is a new
file and a new entry.

A run: set-up (imports, the kernel build into the program's own cache,
the scene from the seed, the program's set-up, one warm-up call of the
cell's shapes), a window of back-to-back calls of at least ``seconds``,
the device's peak memory, the program's state freed, then the check
against the plain reference and the metrics.  ``--trace 1`` wraps the
program's layer entries in spans and traces the device over the first
calls of the window (the traffic file's ``trace_calls``).
"""

import gc
import importlib.util
import json
import math
import pathlib
import sys
import time
import traceback
import types

import numpy as np
import torch

from hzbench import drivers, scenes, trace

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "horayzon_tpu")
#: Program entries a traced run wraps in spans: (module, attribute path,
#: span name).
SPANS = (("horayzon_tpu_torch.models.pipeline", "PlanarPipeline.run",
          "pipeline.run"),
         ("horayzon_tpu_torch.ops.fused_sweep", "horizon_sweep_fused",
          "fused_sweep.horizon_sweep_fused"),
         ("horayzon_tpu_torch.shadow", "Terrain._run", "Terrain._run"),
         ("horayzon_tpu_torch.ops.shadow_sweep", "shadow_metric_fused",
          "shadow_sweep.shadow_metric_fused"),
         ("horayzon_tpu_torch.shadow", "_classify", "shadow._classify"))


def load_json(path):
    with open(path) as f:
        return json.load(f)


class Manifest:
    """``BENCHMARK.json`` and the files of one cell."""

    def __init__(self, root=ROOT):
        self.root = pathlib.Path(root)
        self.bench = load_json(self.root / "BENCHMARK.json")
        self._files = {}    # (folder, name): a scene's or driver's module

    def cell(self, name):
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, cell):
        for c in self.bench["configs"]:
            if c["name"] == cell["config"]:
                return load_json(self.root / c["file"])
        raise KeyError(f"no config {cell['config']!r} in BENCHMARK.json")

    def traffic(self, cell):
        return load_json(self.root / "hzbench" / "traffic"
                         / f"{cell['traffic']}.json")

    def end_to_end(self, cell):
        return [m for m in self.bench["end_to_end"]
                if cell["name"] in m.get("workloads", [cell["name"]])]

    def per_layer(self, cell):
        return [m for m in self.bench["per_layer"]
                if cell["name"] in m["workloads"]]

    def reader(self, name):
        """``read`` of ``metrics/<name>.py``, or else of the file named by
        the part of ``name`` before its first dot (one reader for a
        quantity split by cells: ``device_idle_pct.hz``, ``.sun``)."""
        metrics = self.root / "hzbench" / "metrics"
        path = metrics / f"{name}.py"
        if not path.is_file():
            path = metrics / f"{name.split('.')[0]}.py"
        return _load(path, "hzbench_metric_" + name.replace(".", "_")).read

    def scene(self, name):
        """The scene generator ``name``: ``scenes.SCENES[name]``, or
        ``make`` of ``scene/<name>.py``."""
        mod = self._file("scene", name, scenes.SCENES, "hzbench/scenes.py")
        return scenes.SCENES[name] if mod is None else mod.make

    def driver(self, kind):
        """The driver class of traffic kind ``kind``:
        ``drivers.DRIVERS[kind]``, or ``Driver`` of ``driver/<kind>.py``."""
        mod = self.driver_file(kind)
        return drivers.DRIVERS[kind] if mod is None else mod.Driver

    def driver_file(self, kind):
        """The module of ``driver/<kind>.py``; None for a built-in kind."""
        return self._file("driver", kind, drivers.DRIVERS,
                          "hzbench/drivers.py")

    def _file(self, folder, name, built_in, where):
        """The module of ``hzbench/<folder>/<name>.py``, loaded once per
        manifest; None where ``name`` is a key of ``built_in`` (the dict of
        the file ``where``).  A name of both, or of neither, raises."""
        path = self.root / "hzbench" / folder / f"{name}.py"
        if name in built_in:
            if path.is_file():
                raise ValueError(f"{folder} {name!r} is both built in "
                                 f"({where}) and the file {path}")
            return None
        if not path.is_file():
            raise KeyError(f"no {folder} {name!r}: not built in ({where}) "
                           f"and no file {path}")
        if (folder, name) not in self._files:
            self._files[folder, name] = _load(
                path, f"hzbench_{folder}_{name}".replace(".", "_"))
        return self._files[folder, name]


def _load(path, mod_name):
    """The module of the Python file ``path``, run under ``mod_name``."""
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared as whole names."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def _attr_owner(mod_name, attr):
    """The object that holds ``attr`` (a dotted path) in ``mod_name``, and
    the last name of the path."""
    mod = importlib.import_module(mod_name)
    *owners, last = attr.split(".")
    for o in owners:
        mod = getattr(mod, o)
    return mod, last


def device_info(device):
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def set_up(workload, seed, *, root=ROOT, device="cuda",
           config_overrides=None, traffic_overrides=None):
    """The cell's manifest entries, files, scene and driver, the
    program's set-up done.  ``device``, ``config_overrides`` and
    ``traffic_overrides`` let the tests drive a small cell on the CPU."""
    man = Manifest(root)
    cell = man.cell(workload)
    cfg = dict(man.config(cell), **(config_overrides or {}))
    traffic = dict(man.traffic(cell), **(traffic_overrides or {}))
    dev = torch.device(device)
    import horayzon_tpu_torch as hray

    if dev.type == "cuda":
        hray.ops.fused_sweep.kernel_lib()     # the build, cached
    scene = man.scene(cfg["scene"])(cfg, seed, dev)
    drv = man.driver(traffic["kind"])(hray, scene, traffic, cfg, seed, dev)
    return man, cell, cfg, traffic, scene, drv


def run_cell(workload, seed, seconds, trace_on, *, t_start, root=ROOT,
             device="cuda", config_overrides=None, traffic_overrides=None):
    """One run; returns its result (the arguments after ``t_start`` as
    :func:`set_up` takes them)."""
    man, cell, cfg, traffic, scene, drv = set_up(
        workload, seed, root=root, device=device,
        config_overrides=config_overrides,
        traffic_overrides=traffic_overrides)
    dev = torch.device(device)
    drv.warm()
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()

    spans = trace.Spans()
    tracer = None
    if trace_on:
        for mod_name, attr, name in SPANS:
            spans.wrap(*_attr_owner(mod_name, attr), name)
        tracer = trace.Tracer(int(traffic["trace_calls"]))
    calls, failed, errors = [], 0, []
    work = 0
    if tracer:
        tracer.start()
    gc.collect()
    gc.disable()        # no collector pause of the benchmark's own lists
    t_win = time.perf_counter()
    setup_s = t_win - t_start
    k = 0
    while True:
        arg = drv.prepare(k)
        t0 = time.perf_counter()
        try:
            if tracer and tracer.active:
                with torch.profiler.record_function("hzb.call"):
                    w = drv.call(k, arg)
            else:
                w = drv.call(k, arg)
            work += w
        except Exception:             # a failed call counts, the run goes on
            failed += 1
            errors.append(traceback.format_exc())
        t1 = time.perf_counter()
        calls.append((t0, t1))
        if tracer:
            tracer.count_call()
        k += 1
        if t1 - t_win >= seconds:
            break
    window = calls[-1][1] - t_win
    gc.enable()
    parsed = None
    if tracer:
        parsed = tracer.stop()
    spans.unwrap()
    sync()
    dev_info = device_info(dev)

    drv.release()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = drv.check()
    for e in errors[:1]:
        print(e, file=sys.stderr)
    walls = np.diff(np.asarray(calls), axis=1)[:, 0]
    print(f"calls {len(calls)} in {window:.4f} s; a call's wall: min "
          f"{walls.min():.6f} median {np.median(walls):.6f} max "
          f"{walls.max():.6f} s", file=sys.stderr)

    # what a metric reader reads
    ctx = types.SimpleNamespace(
        cell=cell, config=cfg, traffic=traffic, scene=scene, seed=seed,
        calls=calls, work=work, window_s=window, setup_s=setup_s,
        failed=failed, trace=parsed, spans=spans.log, driver=drv)
    wanted = man.per_layer(cell) if trace_on else man.end_to_end(cell)
    metrics = {}
    for m in wanted:
        v = man.reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    if parsed is not None:
        dev_info["busy_s"] = trace.busy_s(parsed)
        dev_info["window_s"] = trace.window_s(parsed)

    limits = cfg["limits"]
    # a gap that is not finite (a NaN answer) is written as 1e300, which
    # JSON can carry and which fails every limit
    compared = {n: {"value": v if math.isfinite(v) else 1.0e300,
                    "limit": limits[n]} for n, v in checks.items()}
    correct = (failed == 0 and all(c["value"] <= c["limit"]
                                   for c in compared.values()))
    result = {"correct": correct, "attempted": len(calls), "failed": failed,
              "metrics": metrics, "device": dev_info}
    if parsed is not None:
        result["breakdown"] = trace.breakdown(parsed)
    result["checks"] = compared
    return result


def main(argv=None, t_start=None):
    import argparse

    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    chips = Manifest().cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"hzbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), t_start=t_start)
    bad = forbidden_modules()
    if bad:
        print("hzbench: the run loaded JAX or the JAX package: "
              + ", ".join(bad), file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        ok = "ok" if c["value"] <= c["limit"] else "FAILED"
        print(f"check {name}: {c['value']!r} limit {c['limit']!r} {ok}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0

