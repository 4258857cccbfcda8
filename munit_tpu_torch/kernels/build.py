"""Builds the port's CUDA sources with nvcc and loads them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and becomes its own shared
library, ``build/kernels/<name>-<hash>/lib<name>.so`` at the root of the
checkout (``build/`` is git-ignored). The hash covers the source and the
compiler flags, so an edited source is rebuilt at its next use and an
unchanged one is built once. Nothing is built at import: the first call that
launches a kernel builds its library, and ``build_all`` builds every source
at once, one nvcc process each, started together.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("norms",)
# sm_90a: Hopper, with its architecture-specific instructions enabled.
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-lineinfo", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (nvcc); set CUDA_HOME")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{key}" / f"lib{name}.so"


def _start(name: str):
    """Start nvcc for one source; None if its library is already built."""
    lib = library_path(name)
    if lib.exists():
        return None
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    log = open(lib.parent / "nvcc.log", "w")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return cmd, tmp, lib, log, subprocess.Popen(
        cmd, stdout=log, stderr=subprocess.STDOUT)


def _finish(job) -> None:
    cmd, tmp, lib, log, proc = job
    rc = proc.wait()
    log.close()
    if rc != 0:
        text = (lib.parent / "nvcc.log").read_text()
        raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{text}")
    os.replace(tmp, lib)  # atomic: a concurrent build never sees a torn file


def build_all(names=SOURCES) -> dict:
    """Build every source in parallel; returns {name: library path}."""
    jobs = [_start(n) for n in names]
    for job in jobs:
        if job is not None:
            _finish(job)
    return {n: library_path(n) for n in names}


def compiler_log(name: str) -> str:
    """nvcc's output of the last build of ``name`` (registers, spills)."""
    log = library_path(name).parent / "nvcc.log"
    return log.read_text() if log.exists() else ""


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build ``name`` if needed and load it (once per process)."""
    job = _start(name)
    if job is not None:
        _finish(job)
    return ctypes.CDLL(str(library_path(name)))
