# Copyright (c) 2026
# MIT License
"""End-to-end pipelines over the port's kernels."""

from horayzon_tpu_torch.models.pipeline import PlanarPipeline

__all__ = ["PlanarPipeline"]
