# Copyright (c) 2026
# MIT License
"""Host-side utilities: output writers, profiling and the streaming
runners (counterpart of :mod:`horayzon_tpu.utils`)."""

from horayzon_tpu_torch.utils import output, profiling, streaming

__all__ = ["output", "profiling", "streaming"]
