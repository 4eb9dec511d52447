"""``correct`` on small cells on the CPU: the program passes, the control
(the reference in bfloat16 in the program's place) fails, and so does a
run whose timed path is broken underneath."""

import numpy as np
import pytest

from conftest import CPU_CELLS, readings_small, run_small


@pytest.mark.parametrize("workload", CPU_CELLS)
def test_program_passes(workload):
    res = run_small(workload)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("workload", ["dhm25_hz", "hemi_track_batch",
                                      "hemi_track_steps"])
def test_control_fails_a_limit(workload):
    from hzbench import harness
    prog, ctrl = readings_small(workload)
    man = harness.Manifest()
    limits = man.config(man.cell(workload))["limits"]
    assert all(v <= limits[n] for n, v in prog.items()), prog
    assert any(v > limits[n] for n, v in ctrl.items()), ctrl


def _altered_ratio(monkeypatch):
    """K1's plain version with one azimuth's answers altered."""
    from horayzon_tpu_torch.ops import fused_sweep
    orig = fused_sweep._ratio_plain

    def altered(*args, **kwargs):
        raw = orig(*args, **kwargs)
        raw[1] += 0.05
        return raw

    monkeypatch.setattr(fused_sweep, "_ratio_plain", altered)


def _nan_ratio(monkeypatch):
    """K1's plain version with one cell's answers not a number."""
    from horayzon_tpu_torch.ops import fused_sweep
    orig = fused_sweep._ratio_plain

    def nan(*args, **kwargs):
        raw = orig(*args, **kwargs)
        raw[:, 0, 0] = float("nan")
        return raw

    monkeypatch.setattr(fused_sweep, "_ratio_plain", nan)


def _half_batch(monkeypatch):
    """The batch's second half of the suns left out (zeros)."""
    from horayzon_tpu_torch import shadow
    orig = shadow.Terrain.sw_dir_cor_batch

    def half(self, suns):
        out = orig(self, suns[: len(suns) // 2])
        full = out.new_zeros((len(suns),) + tuple(out.shape[1:]))
        full[: out.shape[0]] = out
        return full

    monkeypatch.setattr(shadow.Terrain, "sw_dir_cor_batch", half)


def _stale_step(monkeypatch):
    """A step that leaves its buffer (the state) unchanged after the
    first."""
    from horayzon_tpu_torch import shadow
    orig = shadow.Terrain.sw_dir_cor
    seen = []

    def stale(self, sun, buffer=None):
        if not seen:
            seen.append(1)
            return orig(self, sun, buffer)
        return None

    monkeypatch.setattr(shadow.Terrain, "sw_dir_cor", stale)


def _altered_answer(monkeypatch):
    """One answer of each call altered where the batch is produced."""
    from horayzon_tpu_torch import shadow
    orig = shadow._classify

    def altered(*args, **kwargs):
        out = orig(*args, **kwargs)
        out[..., : out.shape[-1] // 2] += 0.25
        return out

    monkeypatch.setattr(shadow, "_classify", altered)


@pytest.mark.parametrize("workload,fault", [
    ("dhm25_hz", _altered_ratio), ("dhm25_glacier", _altered_ratio),
    ("dhm25_hz", _nan_ratio),
    ("hemi_track_batch", _half_batch), ("hemi_track_batch", _altered_answer),
    ("hemi_track_steps", _stale_step), ("hemi_track_steps", _altered_answer),
])
def test_broken_timed_path_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    res = run_small(workload)
    assert not res["correct"], res["checks"]
    assert all(np.isfinite(c["value"]) for c in res["checks"].values())
    assert np.isfinite(res["metrics"]["setup_s"]["value"])
