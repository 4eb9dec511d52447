# Copyright (c) 2026
# MIT License
"""horayzon_tpu_torch: the PyTorch / CUDA port of horayzon_tpu.

Terrain horizon, sky view factor and slope on an NVIDIA Hopper card (H100).
This package imports torch and numpy and never JAX; ``horayzon_tpu`` stays
the reference it is tested against.  Ported so far: the planar gridded
horizon (kernel K1, ``csrc/horizon_sweep.cu``) and what derives from it
(:class:`horayzon_tpu_torch.models.PlanarPipeline`).  ROADMAP.md lists
what is still to port.
"""

from horayzon_tpu_torch import auxiliary, horizon, terrain, topo_param
from horayzon_tpu_torch import models, ops
from horayzon_tpu_torch.horizon import azimuth_angles, horizon_gridded

__all__ = ["auxiliary", "horizon", "terrain", "topo_param", "models", "ops",
           "azimuth_angles", "horizon_gridded"]
