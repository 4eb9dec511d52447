"""The frozen yardstick at a small size: the schedule and the operations
of one (cell, direction) against counts by hand, the skip model's counts
against the samples the schedule holds and against the program's own
plain model of its kernels' skips."""

import numpy as np
import pytest
import torch

from conftest import SMALL, TRACK
from hzbench import reference, roofline, scenes
from hzbench import sweep as sw


def _hz_scene():
    from hzbench import harness
    man = harness.Manifest()
    cfg = dict(man.config(man.cell("dhm25_hz")), **SMALL["dhm25_hz"])
    return scenes.dhm25_like(cfg, 7, torch.device("cpu"))


def _sun_scene():
    from hzbench import harness
    man = harness.Manifest()
    cfg = dict(man.config(man.cell("hemi_track_batch")), **SMALL["hemi"])
    return scenes.hemisphere(cfg, 7, torch.device("cpu"))


def test_schedule_by_hand():
    scene = _hz_scene()
    plan = reference.horizon_plan(scene)
    # 25 m, 7 km, hori_acc 0.25: ceil(1 / tan(0.25 deg)) = 230 dense
    # steps, 16 of them with two reads; level 1 from 5800 m to 7000 m
    # every 50 m; a 280-cell halo leaves every dense step safe
    assert scene["inner_shape"] == (61, 81)
    assert (plan["n_dense"], plan["nx"], plan["ns1"]) == (230, 16, 230)
    assert plan["phases_meta"][1][:2] == (1, 25)
    assert plan["pads"] == (232, 142)
    full, d1_cost, mip_cost = roofline.schedule_ops(plan, shadow=False)
    reads = 16 * 2 + 214               # d2 two reads, d1 one
    quads = 16 + 107                   # a parabola per d2 step, per pair
    assert full == 18 * reads + 4 * 230 + 37 * quads + 11 * 25
    assert (d1_cost, mip_cost) == (18 + 4 + 37 / 2, 11)
    none_skipped = dict.fromkeys(("d1_skipped", "mip_skipped",
                                  "d1_chunks_skipped", "d1_tests",
                                  "mip_phase_tests", "mip_chunk_tests",
                                  "mip_chunk_slots"), 0.0)
    ops, _ = roofline.work(plan, none_skipped, 10, 3, False, 24)
    assert ops == 30 * full


def test_skip_counts_add_up_to_the_schedule():
    scene = _hz_scene()
    _, _, share, n = roofline.k1_bound(scene, 10 ** 6, 1)
    plan = reference.horizon_plan(scene)
    cells_dirs = 61 * 81 * 16
    assert share == 1.0
    assert n["d1_taken"] + n["d1_skipped"] == pytest.approx(
        cells_dirs * (plan["ns1"] - plan["nx"]))
    assert n["mip_taken"] + n["mip_skipped"] == pytest.approx(
        cells_dirs * 25)
    assert n["mip_phase_tests"] == pytest.approx(cells_dirs)
    assert n["d1_skipped"] > 0


def test_k1_count_matches_the_programs_skip_model():
    from horayzon_tpu_torch.ops import fused_sweep
    scene = _hz_scene()
    _, _, _, mine = roofline.k1_bound(scene, 10 ** 6, 1)
    args = fused_sweep.sweep_args(
        scene["z"], dx=scene["dx"], dy=scene["dy"], offset=scene["offset"],
        inner_shape=scene["inner_shape"], azim_num=scene["azim_num"],
        dist_search=scene["dist_search_m"], hori_acc=scene["hori_acc"])
    z_org, z_inner, levels, trig, plan, outer = args[:6]
    pooled, pool_min0 = fused_sweep.skip_inputs(levels, plan)
    got = dict.fromkeys(("d1_taken", "d1_skipped", "mip_taken",
                         "mip_skipped"), 0)
    phase = {}

    def hook(ev):
        if ev.get("masked") or "cand_max" in ev:
            return None
        _, skip = fused_sweep.warp_skip_plain(ev, pooled, pool_min0, plan,
                                              z_org)
        n = ev["n"]
        if ev["kind"] == "d1":
            got["d1_taken"] += n * int((~skip).sum())
            got["d1_skipped"] += n * int(skip.sum())
        elif ev["kind"] == "mip_phase":
            phase["skip"] = skip
            got["mip_skipped"] += n * int(skip.sum())
            if n <= sw.MIP_CHUNK:
                got["mip_taken"] += n * int((~skip).sum())
        else:
            live = ~phase["skip"]
            got["mip_taken"] += n * int((live & ~skip).sum())
            got["mip_skipped"] += n * int((live & skip).sum())
        return skip

    fused_sweep.sweep_plain(z_inner, levels, plan, outer, trig.shape[0],
                            fused_sweep._horizon_rows(z_org, trig, plan),
                            chunk_hook=hook)
    for k, v in got.items():
        assert mine[k] == pytest.approx(v), k


def test_k2_count_matches_the_programs_skip_model():
    from horayzon_tpu_torch.ops import shadow_sweep
    scene = _sun_scene()
    suns = scenes.sun_track(TRACK, 3, 0)
    _, _, share, mine = roofline.k2_bound(scene, suns, 10 ** 6, 1)
    assert share == 1.0
    (o0, o1), (in0, in1) = scene["offset"], scene["inner_shape"]
    z = scene["z"]
    z_inner = z[o0:o0 + in0, o1:o1 + in1]
    z_org = z_inner + float(np.float32(reference.SHADOW_RAY_LIFT))
    table, _ = shadow_sweep.shadow_sun_table(suns, scene["center"],
                                             scene["dx"], scene["dy"])
    args = shadow_sweep.metric_args(z, z_org, z_inner, table,
                                    offset=scene["offset"],
                                    inner_shape=scene["inner_shape"],
                                    dx=scene["dx"], dy=scene["dy"])
    _, got = shadow_sweep.metric_model(*args, scene["grid_origin"],
                                       exact_metric=False)
    for k in ("d1_taken", "d1_skipped", "mip_taken", "mip_skipped"):
        assert mine[k] == pytest.approx(got[k]), k
    assert mine["d1_skipped"] + mine["mip_skipped"] > 0


def test_reference_metric_is_the_programs_plain_metric():
    from horayzon_tpu_torch.ops import shadow_sweep
    scene = _sun_scene()
    suns = scenes.sun_track(TRACK, 4, 1)
    plan = {"inner_shape": scene["inner_shape"], "offset": scene["offset"]}
    nb0, nb1 = sw.block_grid(scene["inner_shape"])
    cells = sw.cells_of_blocks(np.arange(nb0 * nb1), plan, "cpu")
    metric, _, _ = reference.shadow_metric(scene, cells, suns)
    (o0, o1), (in0, in1) = scene["offset"], scene["inner_shape"]
    z = scene["z"]
    z_inner = z[o0:o0 + in0, o1:o1 + in1]
    z_org = z_inner + float(np.float32(reference.SHADOW_RAY_LIFT))
    table, _ = shadow_sweep.shadow_sun_table(suns, scene["center"],
                                             scene["dx"], scene["dy"])
    want = shadow_sweep.shadow_metric_plain(
        z, z_org, z_inner, table, offset=scene["offset"],
        inner_shape=scene["inner_shape"], dx=scene["dx"], dy=scene["dy"],
        grid_origin=scene["grid_origin"])
    assert torch.equal(metric, want[:, cells.ii, cells.jj])
