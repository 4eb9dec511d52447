# Copyright (c) 2026
# MIT License
"""Distance-sample schedule of the horizon sweep (NumPy only).

Copy of the schedule part of :mod:`horayzon_tpu.ops.sweep` (``Phase``,
``Schedule``, ``build_schedule``, ``default_rel_err``,
``mark_safe_phases``).  Copied, not imported, because importing
``horayzon_tpu`` loads JAX; ``tests/test_torch_schedule.py`` holds the
copies equal to the originals, so the port and the reference march the
same samples.  The sweep engine itself lives in :mod:`.fused_sweep`.
"""

import dataclasses
import math

import numpy as np

#: Scan-unroll factor of the reference's XLA sweep: interior dense-phase
#: boundaries of :func:`mark_safe_phases` fall on its multiples.
UNROLL = 8


@dataclasses.dataclass(frozen=True)
class Phase:
    """One constant-mip-level marching phase.

    kind: 'd2' — level-0 near field, two reads per step (midpoint +
          endpoint; per-interval exact parabola);
          'd1' — level-0, one read per step (trailing-window parabola);
          'mip' — coarse-level point samples.
    """
    level: int          # mip level
    pad: int            # padding (in level cells) applied to this level
    num: int            # number of samples
    kind: str = "mip"
    #: True when every sample of the phase provably stays inside the real
    #: heightfield for all inner cells (halo wide enough) — the per-sample
    #: in-domain masks can then be skipped.
    safe: bool = False

    def key(self):
        return (self.kind, self.level, self.pad, self.num, self.safe)


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Distance-sample schedule shared by all azimuths."""
    phases: tuple               # tuple of Phase
    s_values: tuple             # tuple of np.ndarray (one per phase) [metre]
    step: float                 # base step [metre]
    dist: float                 # search distance [metre]

    @property
    def num_levels(self):
        return max(p.level for p in self.phases) + 1

    @property
    def pads(self):
        pads = [0] * self.num_levels
        for p in self.phases:
            pads[p.level] = max(pads[p.level], p.pad)
        return tuple(pads)

    @property
    def num_samples(self):
        return sum(2 * p.num if p.kind == "d2" else p.num
                   for p in self.phases)

    def meta(self):
        """Hashable static description."""
        return tuple(p.key() for p in self.phases)


def build_schedule(step, dist_search, rel_err, max_level=10, near_exact=16):
    """Build the marching schedule.

    Parameters
    ----------
    step : float
        Base sample spacing = finest grid spacing [metre].
    dist_search : float
        Horizon search distance [metre].
    rel_err : float
        Far-field relative-footprint error budget: the dense (exact) phase
        runs to ``step / rel_err``, after which each phase doubles the step
        and the mip level.
    max_level : int
        Maximum mip level to use.
    near_exact : int
        Number of leading dense steps evaluated with two reads per step
        (per-interval exact parabolas) — the strongly angle-sensitive near
        field; the remaining dense steps use one read per step.
    """
    if dist_search <= 0.0:
        raise ValueError("dist_search must be positive")
    rel_err = float(np.clip(rel_err, 1.0e-4, 0.2))
    n_dense = int(math.ceil(1.0 / rel_err))

    phases = []
    s_arrays = []
    # Dense phases at native resolution: sample points step, 2*step, ...
    n0 = min(n_dense, int(math.ceil(dist_search / step)))
    s = np.arange(1, n0 + 1, dtype=np.float64) * step
    s_end = float(s[-1])
    pad0 = int(math.ceil(s_end / step)) + 2
    n2 = min(near_exact, n0)
    phases.append(Phase(level=0, pad=pad0, num=n2, kind="d2"))
    s_arrays.append(s[:n2].astype(np.float32))
    if n0 > n2:
        phases.append(Phase(level=0, pad=pad0, num=n0 - n2, kind="d1"))
        s_arrays.append(s[n2:].astype(np.float32))

    level = 1
    while s_end < dist_search - 1.0e-6:
        lvl = min(level, max_level)
        step_l = step * (2 ** level)
        if lvl == max_level or level >= 60:
            s_cap = dist_search
        else:
            s_cap = min(dist_search, n_dense * step_l)
        s = np.arange(s_end + step_l, s_cap + 0.5 * step_l, step_l,
                      dtype=np.float64)
        if len(s) == 0:
            s = np.array([s_cap], dtype=np.float64)
        s = np.minimum(s, dist_search)
        s_end = float(s[-1])
        pad = int(math.ceil(s_end / (step * 2 ** lvl))) + 2
        phases.append(Phase(level=lvl, pad=pad, num=len(s), kind="mip"))
        s_arrays.append(s.astype(np.float32))
        if lvl == max_level:
            break
        level += 1

    return Schedule(phases=tuple(phases), s_values=tuple(s_arrays),
                    step=float(step), dist=float(dist_search))


def default_rel_err(hori_acc_deg):
    """Far-field error budget matching the reference ``hori_acc`` contract."""
    return math.tan(math.radians(max(hori_acc_deg, 0.02)))


def mark_safe_phases(schedule, halo_cells):
    """Split/flag dense phases whose samples provably stay inside the grid.

    ``halo_cells``: minimum distance (in cells) from any inner cell to the
    outer-grid edge.  Samples with ``s/step + 2 <= halo_cells`` cannot read
    outside the real heightfield for any inner cell, so their in-domain
    masks are skipped (``Phase.safe``).  Dense phases straddling the
    boundary are split in two.
    """
    s_safe = (halo_cells - 2) * schedule.step
    phases = []
    s_arrays = []
    for ph, s in zip(schedule.phases, schedule.s_values):
        if ph.kind not in ("d1", "d2"):
            phases.append(ph)
            s_arrays.append(s)
            continue
        n_safe = int(np.searchsorted(s, s_safe, side="right"))
        # Interior dense-phase boundaries must fall on UNROLL multiples:
        # the scan tables pad trailing samples by duplication, which would
        # otherwise corrupt the parabola history entering the next phase.
        n_safe = (n_safe // UNROLL) * UNROLL
        if n_safe == len(s):
            phases.append(dataclasses.replace(ph, safe=True))
            s_arrays.append(s)
        elif n_safe == 0:
            phases.append(ph)
            s_arrays.append(s)
        else:
            phases.append(dataclasses.replace(ph, num=n_safe, safe=True))
            s_arrays.append(s[:n_safe])
            phases.append(dataclasses.replace(ph, num=len(s) - n_safe))
            s_arrays.append(s[n_safe:])
    return Schedule(phases=tuple(phases), s_values=tuple(s_arrays),
                    step=schedule.step, dist=schedule.dist)
