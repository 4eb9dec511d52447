# Copyright (c) 2026
# MIT License
"""Sweep schedule, max-mip pyramid and the fused horizon sweep (kernel K1)."""

from horayzon_tpu_torch.ops import fused_sweep, mip, sweep

__all__ = ["fused_sweep", "mip", "sweep"]
