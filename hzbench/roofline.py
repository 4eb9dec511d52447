"""The frozen yardstick of the sweep kernels K1 and K2: the work these
inputs need, counted by the benchmark's own sweep and skip model
(:mod:`hzbench.sweep`), never by a kernel's counters, and the least time
one H100 could do it in.

The float32 operations per (cell, direction) are those of
``chip_smoke.py::sweep_bound`` at commit c632955, counted from
``csrc/horizon_sweep.cu``: 18 per bilinear read, 4 per point candidate,
37 (K1) or 28 (K2) per parabola with its coefficients, 11 per mip sample,
15 for K2's ray slope; a skipped d1 chunk costs the re-read of h1 (18),
each skip test its fixed part and 9 (K1) or 10 (K2) per sample slot a
lane forms (a lane forms one of 32).  Every input is read and every
output written once.  Peaks: NVIDIA's data sheet of the H100 SXM at its
700 W limit.
"""

import numpy as np

from hzbench import reference as ref
from hzbench import sweep as sw

PEAK_F32_OPS = 67.0e12
PEAK_HBM_BYTES = 3.35e12
D1_TEST_OPS = {False: 47, True: 49}
MIP_TEST_OPS = {False: 15, True: 17}
MIP_SLOT_OPS = {False: 9, True: 10}


def schedule_ops(plan, shadow):
    """Float32 operations of one (cell, direction) over the whole
    schedule, and the operations a skipped d1 sample and mip sample would
    have cost."""
    nx, ns1, n_dense = plan["nx"], plan["ns1"], plan["n_dense"]
    n_mip = sum(ph[1] for ph in plan["phases_meta"][1:])
    quads = nx + sum((hi - lo + 1) // 2
                     for lo, hi in ((nx, ns1), (ns1, n_dense)) if hi > lo)
    quad_ops = 28 if shadow else 37
    full = (18 * (nx + n_dense) + 4 * n_dense + quad_ops * quads
            + 11 * n_mip + (15 if shadow else 0))
    return full, 18 + 4 + quad_ops / 2, 11


def level_bytes(plan, outer_shape):
    """Bytes of the padded levels and their pooled companions."""
    total = 0
    h, w = outer_shape
    for lvl, pad in enumerate(plan["pads"]):
        hl, wl = h, w
        for _ in range(lvl):
            hl, wl = (hl + 1) // 2, (wl + 1) // 2
        hp, wp = hl + 2 * pad, wl + 2 * pad
        total += 4 * (hp * wp + (-(-hp // 8)) * (-(-wp // 8)))
    h0 = h + 2 * plan["pads"][0]
    w0 = w + 2 * plan["pads"][0]
    return total + 4 * (-(-h0 // 8)) * (-(-w0 // 8))


def work(plan, counts, n_cells, n_dirs, shadow, table_bytes):
    """(ops, bytes) of one launch over ``n_cells`` x ``n_dirs``, from the
    skip model's ``counts`` (summed over the whole launch)."""
    full, d1_cost, mip_cost = schedule_ops(plan, shadow)
    ops = float(n_cells) * n_dirs * full
    ops -= counts["d1_skipped"] * d1_cost + counts["mip_skipped"] * mip_cost
    ops += 18 * counts["d1_chunks_skipped"]
    ops += D1_TEST_OPS[shadow] * counts["d1_tests"]
    ops += MIP_TEST_OPS[shadow] * (counts["mip_phase_tests"]
                                   + counts["mip_chunk_tests"])
    ops += MIP_SLOT_OPS[shadow] * counts["mip_chunk_slots"] / 32.0
    moved = (level_bytes(plan, plan["outer_shape"]) + 8 * n_cells
             + table_bytes + plan["steps"].nbytes + 4 * n_cells * n_dirs)
    return ops, moved


def bound_s(ops, moved):
    """(seconds, "operations" or "bytes"): the least time of the work."""
    t_o, t_b = ops / PEAK_F32_OPS, moved / PEAK_HBM_BYTES
    return max(t_o, t_b), ("operations" if t_o >= t_b else "bytes")


def _sampled_counts(plan, n_blocks, rng, inner_shape, run, dir_chunk):
    """Run ``run(cells, d0, d1) -> counts`` over a sample of blocks in
    chunks of directions; return the counts scaled to the whole inner
    block and the sampled share of its cells."""
    blocks = sw.sample_blocks(inner_shape, n_blocks, rng)
    total = {}
    cells = sw.cells_of_blocks(blocks, plan, run.device)
    for d0 in range(0, run.n_dirs, dir_chunk):
        for key, v in run(cells, d0, min(d0 + dir_chunk,
                                         run.n_dirs)).items():
            total[key] = total.get(key, 0.0) + v
    share = float(cells.weight.sum()) / (inner_shape[0] * inner_shape[1])
    return {k: v / share for k, v in total.items()}, share


def k1_bound(scene, n_blocks, seed, dir_chunk=30):
    """K1 on the planar scene: (bound seconds, bound by, sampled share,
    counts)."""
    plan = ref.horizon_plan(scene)
    z = scene["z"]
    levels = sw.padded_levels(z, plan["pads"])
    pool, pmin = sw.pooled(levels, plan["pads"][0])
    trig = sw.trig_table(scene["azim_num"])

    class Run:
        device = z.device
        n_dirs = scene["azim_num"]

        def __call__(self, cells, d0, d1):
            z_inner = z[cells.rows, cells.cols]
            z_org = z_inner + float(np.float32(ref.HORIZON_RAY_LIFT))
            mode = sw.horizon_mode(plan, z_org, trig[d0:d1])
            hook = sw.SkipCount(cells, plan, pool, pmin, z_org, mode[:2])
            sw.sweep_cells(cells, levels, plan, z_inner, mode, hook=hook)
            return hook.n

    counts, share = _sampled_counts(plan, n_blocks,
                                    np.random.default_rng(seed),
                                    scene["inner_shape"], Run(), dir_chunk)
    n_cells = scene["inner_shape"][0] * scene["inner_shape"][1]
    ops, moved = work(plan, counts, n_cells, scene["azim_num"], False,
                      trig.nbytes)
    return bound_s(ops, moved) + (share, counts)


def k2_bound(scene, suns, n_blocks, seed, dir_chunk=46):
    """K2's sign-exact arm (what ``Terrain``'s queries run) on the
    scene's track ``suns``: as :func:`k1_bound`."""
    plan = ref.shadow_plan(scene)
    z = scene["z"]
    levels = sw.padded_levels(z, plan["pads"])
    pool, pmin = sw.pooled(levels, plan["pads"][0])
    suns = np.asarray(suns, dtype=np.float32)

    class Run:
        device = z.device
        n_dirs = suns.shape[0]

        def __call__(self, cells, d0, d1):
            def hook(plan_, levels_, z_org, table, m):
                return sw.SkipCount(cells, plan, pool, pmin, z_org,
                                    (table[:, 5].astype(np.float32),
                                     table[:, 6].astype(np.float32)),
                                    m=m, sign_exact=True)

            _, _, h = ref.shadow_metric(scene, cells, suns[d0:d1],
                                        hook=hook)
            return h.n

    counts, share = _sampled_counts(plan, n_blocks,
                                    np.random.default_rng(seed),
                                    scene["inner_shape"], Run(), dir_chunk)
    n_cells = scene["inner_shape"][0] * scene["inner_shape"][1]
    ops, moved = work(plan, counts, n_cells, suns.shape[0], True,
                      suns.shape[0] * 32)
    return bound_s(ops, moved) + (share, counts)

