# Copyright (c) 2026
# MIT License
"""Helpers shared by the port's example workflows (``examples/torch/``):
the ``--device`` and ``--out`` flags, the printed checks that end a run
with a nonzero exit when they fail, and the optional figures of
``examples/plots_util.py``.  Imports torch and numpy, never JAX.

Importing it puts the repository root on ``sys.path``, so the scripts run
without an install.
"""

import os
import sys

import torch

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

#: Where the scripts write their results unless ``--out`` says otherwise
#: (``build/`` is listed in ``.gitignore``).
DEFAULT_OUT = os.path.join(REPO, "build", "examples")


def add_common_args(ap):
    """Add ``--device`` (default ``cuda``) and ``--out`` to ``ap``."""
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (the card, default) or cpu")
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="output directory")


def device(name):
    """``torch.device(name)``; raises SystemExit for a CUDA device when
    none is available (no fallback to the CPU)."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: no CUDA device available "
                         f"(pass --device cpu to run the plain versions)")
    return dev


def check(cond, what):
    """Print the check; exit with status 1 if it failed."""
    print(("check ok: " if cond else "CHECK FAILED: ") + what)
    if not cond:
        raise SystemExit(1)


def numpy(t):
    """A tensor on any device as a NumPy array."""
    return t.detach().cpu().numpy()


def plots_util():
    """``examples/plots_util.py`` (numpy and matplotlib), for ``--plot``."""
    sys.path.insert(0, os.path.join(REPO, "examples"))
    import plots_util as mod
    return mod
