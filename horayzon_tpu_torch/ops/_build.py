# Copyright (c) 2026
# MIT License
"""Build ``csrc/*.cu`` with nvcc on first use and load it with ctypes.

Each source is compiled into a shared library with a plain C interface
under ``build/kernels/`` beside the package (listed in ``.gitignore``).
The library name carries a hash of the source and the flags, so an edited
source is rebuilt and a stale library is never loaded.  Nothing here runs
at import: nvcc exists only on machines with the CUDA toolkit.
"""

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

CSRC_DIR = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"

#: Hopper only (the ``a`` keeps wgmma/setmaxnreg available); no FMA
#: contraction and no fast math, so the kernels round like the reference.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

_LOADED = {}
#: ptxas report and seconds of each build made in this process, by name.
BUILD_LOG = {}


def _nvcc():
    path = shutil.which("nvcc")
    if path is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = os.path.join(home, "bin", "nvcc")
        path = cand if os.path.exists(cand) else None
    if path is None:
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME: the "
                           "CUDA kernels of horayzon_tpu_torch need the CUDA "
                           "toolkit")
    return path


def library_path(name):
    """Path of the built library for ``csrc/<name>.cu`` (may not exist)."""
    src = CSRC_DIR / f"{name}.cu"
    if not src.is_file():
        raise FileNotFoundError(f"kernel source {src} is missing")
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(name):
    """Compile ``csrc/<name>.cu`` unless its library exists; return its
    path.  Raises RuntimeError with nvcc's output if the build fails."""
    return build_all([name])[0]


def build_all(names):
    """:func:`build` for several sources, one nvcc process each, all
    started together; returns their library paths in ``names`` order."""
    jobs = []
    try:
        for name in names:
            out = library_path(name)
            if out.is_file():
                jobs.append((name, out, None, None, None))
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
                   str(CSRC_DIR / f"{name}.cu")]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
            jobs.append((name, out, tmp, proc, time.perf_counter()))
        for name, out, tmp, proc, t0 in jobs:
            if proc is None:
                continue
            _, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed to build {name}.cu "
                                   f"(exit {proc.returncode}):\n{err}")
            os.replace(tmp, out)
            BUILD_LOG[name] = (time.perf_counter() - t0, err)
    finally:
        for _, _, tmp, proc, _ in jobs:
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
            if tmp is not None and os.path.exists(tmp):
                os.unlink(tmp)
    return [out for _, out, _, _, _ in jobs]


def load(name):
    """The ctypes library of ``csrc/<name>.cu``, built on first use."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _LOADED[name] = lib
    return lib
