"""The benchmark of horayzon_tpu_torch on one NVIDIA H100: see
``run.py`` for the command and ``harness.py`` for what a run does."""
