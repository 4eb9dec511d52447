# Copyright (c) 2026
# MIT License
"""Host-side utilities: output writers, profiling and the streaming
runners (counterpart of :mod:`horayzon_tpu.utils`).

``streaming`` is imported on first use: it imports the ops, and the ops
import ``profiling``, so importing it here would close a cycle."""

import importlib

from horayzon_tpu_torch.utils import output, profiling

__all__ = ["output", "profiling", "streaming"]


def __getattr__(name):
    if name == "streaming":
        return importlib.import_module(f"{__name__}.streaming")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
