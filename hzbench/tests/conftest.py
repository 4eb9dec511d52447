"""Small versions of the cells for runs on the CPU, where the program
runs its plain versions of the kernels."""

import pathlib
import sys
import time

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from hzbench import control, harness  # noqa: E402

TRACK = {"steps": 13, "span_deg": 360.0, "elev_deg": 30.0, "dist_m": 1.0e7,
         "turn_deg": 137.50776405}
SMALL = {
    "dhm25_hz": {"domain": {"x_min": 668000.0, "x_max": 670000.0,
                            "y_min": 172000.0, "y_max": 173500.0},
                 "dist_search_km": 7.0, "azim_num": 16, "check_blocks": 4,
                 "count_blocks": 64,
                 "bumps": {"count": 8, "sigma_cells": [20.0, 160.0],
                           "amp_m": [200.0, 1800.0],
                           "wave": {"amp_m": 120.0, "x_m": 2100.0,
                                    "y_m": 1700.0}}},
    "hemi": {"dom_width_h_m": [1000.0, 2000.0, 1000.0], "check_blocks": 16,
             "count_blocks": 64},
}
SMALL["dhm25_glacier"] = SMALL["dhm25_hz"]
SMALL["hemi_track_batch"] = SMALL["hemi_track_steps"] = SMALL["hemi"]
TRAFFIC = {
    "dhm25_glacier": {"mask": {"kind": "patches", "count": 3,
                               "radius_cells": [6.0, 12.0]}},
    "hemi_track_batch": {"track": TRACK},
    "hemi_track_steps": {"track": TRACK, "check_calls": 26},
}
CPU_CELLS = ("dhm25_hz", "dhm25_glacier", "hemi_track_batch",
             "hemi_track_steps")


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def run_small(workload, seed=20261017, seconds=0.5, trace_on=False,
              root=harness.ROOT):
    """One small run of ``workload`` on the CPU."""
    return harness.run_cell(workload, seed, seconds, trace_on,
                            t_start=time.perf_counter(), root=root,
                            device="cpu",
                            config_overrides=SMALL[workload],
                            traffic_overrides=TRAFFIC.get(workload))


def readings_small(workload, seed=20261017):
    calls = 26 if workload == "hemi_track_steps" else None
    return control.readings(workload, seed, calls, device="cpu",
                            config_overrides=SMALL[workload],
                            traffic_overrides=TRAFFIC.get(workload))
