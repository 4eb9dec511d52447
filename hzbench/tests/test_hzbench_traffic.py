"""The horizon mixes as the upstream example runs them: each call builds
its own ``PlanarPipeline`` on a DEM of its own (and a mask of its own),
so no work done for one call can serve the next."""

import itertools

import numpy as np
import pytest

from conftest import SMALL, TRAFFIC
from hzbench import harness


@pytest.mark.parametrize("workload", ["dhm25_hz", "dhm25_glacier"])
def test_each_call_builds_a_pipeline_on_a_dem_of_its_own(workload,
                                                          monkeypatch):
    from horayzon_tpu_torch import models
    built, masks = [], []
    init, run = models.PlanarPipeline.__init__, models.PlanarPipeline.run

    def counting_init(self, x, y, elevation, *args, **kwargs):
        built.append(np.array(elevation))
        init(self, x, y, elevation, *args, **kwargs)

    def counting_run(self, mask=None):
        masks.append(None if mask is None else np.array(mask))
        return run(self, mask=mask)

    monkeypatch.setattr(models.PlanarPipeline, "__init__", counting_init)
    monkeypatch.setattr(models.PlanarPipeline, "run", counting_run)
    *_, drv = harness.set_up(workload, 20261018, device="cpu",
                             config_overrides=SMALL[workload],
                             traffic_overrides=TRAFFIC.get(workload))
    drv.warm()
    for k in range(3):
        drv.call(k, drv.prepare(k))
    assert len(built) == len(masks) == 4          # the warm-up's and three
    assert [d for d, _ in drv.samples] == [1, 2, 3]
    for a, b in itertools.combinations(built, 2):
        assert not np.array_equal(a, b)
    if workload == "dhm25_glacier":
        for a, b in itertools.combinations(masks, 2):
            assert not np.array_equal(a, b)
    else:
        assert masks == [None] * 4
    checks = drv.check()
    assert checks["hori_gap_deg"] == 0.0 and checks["bad_values"] == 0


def test_a_dem_is_the_same_from_the_same_seed():
    *_, drv = harness.set_up("dhm25_glacier", 7, device="cpu",
                             config_overrides=SMALL["dhm25_glacier"],
                             traffic_overrides=TRAFFIC["dhm25_glacier"])
    a, b = drv.prepare(4), drv.prepare(4)
    assert np.array_equal(a.z, b.z) and np.array_equal(a.mask, b.mask)
    assert np.array_equal(a.ii, b.ii) and a.work == b.work
