# Copyright (c) 2026
# MIT License
"""Local-build helper for the native C++ helpers (fastdem, bvhbase).

Copy of :mod:`horayzon_tpu.native.buildlib` with its imports pointed at this
package (importing ``horayzon_tpu`` loads JAX);
``tests/test_torch_host_modules.py`` holds it equal to the original.

Shared objects are never shipped (``*.so`` is gitignored): they are built
with ``-march=native`` and a binary from another machine could SIGILL or,
worse, silently measure a different microarchitecture — invalidating the
measured-CPU baseline (BASELINE.md).  Reuse is gated on a sidecar marker
holding the SHA-256 of the source *and* a local-build flag, not on mtimes
(which depend on checkout order on fresh clones).
"""

import hashlib
import os
import subprocess


class NativeBuildError(RuntimeError):
    pass


def _src_digest(src):
    with open(src, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


def ensure_built(src, so, extra_flags=()):
    """Build ``so`` from ``src`` unless a locally-built, source-matching
    binary already exists (per the sidecar ``<so>.build`` marker)."""
    marker = so + ".build"
    digest = _src_digest(src)
    if os.path.isfile(so) and os.path.isfile(marker):
        try:
            with open(marker, "r", encoding="ascii") as fh:
                if fh.read().strip() == digest:
                    return so
        except OSError:
            pass
    cmd = ["g++", "-O3", "-march=native", "-std=c++17", "-shared",
           "-fPIC", "-pthread", *extra_flags, src, "-o", so]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except (subprocess.CalledProcessError, FileNotFoundError) as exc:
        msg = getattr(exc, "stderr", str(exc))
        raise NativeBuildError(
            f"building {os.path.basename(src)} failed: {msg}") from exc
    with open(marker, "w", encoding="ascii") as fh:
        fh.write(digest + "\n")
    return so
