"""The readings behind each limit of ``correct``: the program's and the
control's, on several seeds, at a cell's own size.

    python3 hzbench/control.py --workload <name> --seeds 11 12 13 ...

For each seed: the cell's scene and program set-up, ``--calls`` calls of
its timed path, then the numbers the run compares (the program's
readings); then the control, the reference computed in bfloat16 (the
precision below the configuration's float32) put in the program's place
and judged by the same comparison.  One JSON line per seed.  The
benchmark's runs never run this.

A built-in traffic kind takes its calls from :data:`DEFAULT_CALLS` and its
control from :func:`control_readings`; a kind of its own file,
``hzbench/driver/<kind>.py`` (:meth:`hzbench.harness.Manifest.driver`),
gives both there: the integer ``CONTROL_CALLS`` and
``control_readings(drv)``, which returns the numbers of its driver's
``check()`` under the same names.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path[0] != ROOT:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from hzbench import drivers, harness, reference  # noqa: E402

DEFAULT_CALLS = {"horizon_calls": 1, "sun_batch": 2, "sun_steps": 362}


def control_readings(drv):
    """The control judged as the program's answers are: the bfloat16
    reference at the sampled cells of each call's DEM (horizon), or at
    the picked calls (sun)."""
    low = torch.bfloat16
    if isinstance(drv, drivers.HorizonCalls):
        out = {}
        for d, _ in drv.samples:
            dem = drv.dem(d)
            r = reference.horizon_reference(dem[0], dem[2], low)
            sample = {n: v.float().cpu().numpy() for n, v in r.items()}
            for n, v in drv.gaps(dem, sample).items():
                out[n] = max(out.get(n, 0.0), v)
        return out
    size = max(1, drv.steps // drv.suns[0].shape[0])
    pairs = []
    for i in range(0, len(drv.suns), size):
        suns = np.concatenate(drv.suns[i:i + size])
        c = reference.sw_dir_cor_reference(drv.scene, drv.cells, suns, low)
        pairs.append((suns, c.float().cpu().numpy()))
    return {"swdc_gap": drv.gaps(pairs)}


def readings(workload, seed, calls=None, *, device="cuda", root=harness.ROOT,
             config_overrides=None, traffic_overrides=None):
    """(program's numbers, control's numbers) of one seed."""
    man, _, _, traffic, _, drv = harness.set_up(
        workload, seed, root=root, device=device,
        config_overrides=config_overrides,
        traffic_overrides=traffic_overrides)
    mod = man.driver_file(traffic["kind"])
    if mod is None:
        default, judge = DEFAULT_CALLS[traffic["kind"]], control_readings
    else:
        default, judge = mod.CONTROL_CALLS, mod.control_readings
    n = default if calls is None else calls
    for k in range(n):
        drv.call(k, drv.prepare(k))
    drv.release()
    prog = drv.check()
    return prog, judge(drv)


def main():
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--calls", type=int, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("hzbench.control: no CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        t0 = time.perf_counter()
        prog, ctrl = readings(args.workload, seed, args.calls)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "program": prog, "control": ctrl,
                          "seconds": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
