# Copyright (c) 2026
# MIT License
"""Meshes of shard slots and the sharded sweep entry points (counterpart
of :mod:`horayzon_tpu.parallel`), on ``torch.distributed``."""

from horayzon_tpu_torch.parallel import distributed
from horayzon_tpu_torch.parallel import mesh
from horayzon_tpu_torch.parallel import shard
from horayzon_tpu_torch.parallel.distributed import init_distributed
from horayzon_tpu_torch.parallel.mesh import AXIS_AZIM, AXIS_TILE, make_mesh
from horayzon_tpu_torch.parallel.shard import (
    horizon_sweep_fused_sharded, horizon_sweep_multires_fused_sharded,
    horizon_sweep_sharded, shadow_metric_fused_sharded,
    shadow_metric_sharded)
