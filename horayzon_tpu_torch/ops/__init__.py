# Copyright (c) 2026
# MIT License
"""Sweep schedule, max-mip pyramid, the fused horizon sweep (kernel K1), its
winner-replay backward (kernel K3), the fused shadow sweep (kernel K2, with
its mask variant), the multires far field (a combined fine + coarse
pyramid under the same kernels), the reference's XLA engines in plain
torch (the marching sweep, the log-doubling shadow scan), the
per-location horizon sweep, the read-floor microbenchmark (kernel K5),
atmospheric refraction, and the geometry (kernel G1) and planarisation of
curved meshes."""

from horayzon_tpu_torch.ops import (fused_sweep, geometry, locations, mip,
                                    multires, planarize, read_floor,
                                    refraction, replay, shadow_scan,
                                    shadow_sweep, sweep)

__all__ = ["fused_sweep", "geometry", "locations", "mip", "multires",
           "planarize", "read_floor", "refraction", "replay", "shadow_scan",
           "shadow_sweep", "sweep"]
