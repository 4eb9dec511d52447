# Copyright (c) 2026
# MIT License
"""End-to-end pipelines over the port's kernels: the planar and curved
terrain parameters and the terrain fit through the horizon gradient."""

from horayzon_tpu_torch.models.pipeline import CurvedPipeline, PlanarPipeline
from horayzon_tpu_torch.models.terrain_fit import TerrainFit

__all__ = ["CurvedPipeline", "PlanarPipeline", "TerrainFit"]
