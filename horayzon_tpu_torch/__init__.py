# Copyright (c) 2026
# MIT License
"""horayzon_tpu_torch: the PyTorch / CUDA port of horayzon_tpu.

Terrain horizon, sky view factor and slope on an NVIDIA Hopper card (H100).
This package imports torch and numpy and never JAX; ``horayzon_tpu`` stays
the reference it is tested against.  Ported so far: the planar gridded
horizon (kernel K1, ``csrc/horizon_sweep.cu``) and what derives from it
(:class:`horayzon_tpu_torch.models.PlanarPipeline`), with masks (K1's mask
variant) and on curved grids (its tilt-ramp variant,
:class:`horayzon_tpu_torch.models.CurvedPipeline`), its gradient (K1's
argmax variant and K3), shadow maps and ``sw_dir_cor``
(:class:`horayzon_tpu_torch.shadow.Terrain`, kernel K2, the shadow mode of
the same source) on planar and curved meshes, per-location horizons
(:func:`horizon_locations`), the topographic parameters, and the
reference's XLA engines in plain torch (``engine="sweep"``, non-default
vectors, ``Terrain(engine="sweep"/"scan")``), and the sharded entries over
a mesh of devices on ``torch.distributed`` (:mod:`horayzon_tpu_torch.
parallel`, the shard variants of the kernels).  ROADMAP.md lists what is
still to port.
"""

from horayzon_tpu_torch import (auxiliary, direction, horizon, regrid,
                                shadow, sun_position, terrain, topo_param,
                                transform)
from horayzon_tpu_torch import models, ops
from horayzon_tpu_torch.horizon import (azimuth_angles, horizon_gridded,
                                        horizon_locations)

__all__ = ["auxiliary", "direction", "horizon", "regrid", "shadow",
           "sun_position", "terrain", "topo_param", "transform", "models",
           "ops", "azimuth_angles", "horizon_gridded", "horizon_locations"]
