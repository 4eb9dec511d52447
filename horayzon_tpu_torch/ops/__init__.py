# Copyright (c) 2026
# MIT License
"""Sweep schedule, max-mip pyramid, the fused horizon sweep (kernel K1) and
its winner-replay backward (kernel K3)."""

from horayzon_tpu_torch.ops import fused_sweep, mip, replay, sweep

__all__ = ["fused_sweep", "mip", "replay", "sweep"]
