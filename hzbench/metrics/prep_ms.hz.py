"""prep_ms.hz [ms]: per call, the host time from the entry of
PlanarPipeline.run to the entry of fused_sweep.horizon_sweep_fused, the
mean over the window's calls (the benchmark's spans around the two)."""


def read(ctx):
    runs = [s for s in ctx.spans if s[0] == "pipeline.run"]
    sweeps = [s for s in ctx.spans
              if s[0] == "fused_sweep.horizon_sweep_fused"]
    preps = []
    for _, r0, r1 in runs:
        inner = [s0 for _, s0, _ in sweeps if r0 <= s0 <= r1]
        if inner:
            preps.append(min(inner) - r0)
    if not preps:
        return None
    return sum(preps) / len(preps) * 1e3
