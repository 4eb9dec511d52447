# Copyright (c) 2026
# MIT License
"""Native (C++) host-side helpers: fast DEM parsing and a CPU reference
ray-marcher used for validation.  Built lazily via ``build.py``; all
functionality has pure-NumPy fallbacks.

Copy of :mod:`horayzon_tpu.native` with its imports pointed at this package
(importing ``horayzon_tpu`` loads JAX); ``tests/test_torch_host_modules.py``
holds it equal to the original.
"""
