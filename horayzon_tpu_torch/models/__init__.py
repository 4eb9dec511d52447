# Copyright (c) 2026
# MIT License
"""End-to-end pipelines over the port's kernels: the planar terrain
parameters and the terrain fit through the horizon gradient."""

from horayzon_tpu_torch.models.pipeline import PlanarPipeline
from horayzon_tpu_torch.models.terrain_fit import TerrainFit

__all__ = ["PlanarPipeline", "TerrainFit"]
