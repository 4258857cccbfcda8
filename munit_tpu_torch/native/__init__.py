"""ctypes bindings for the native image ops (``imageops.cpp``): the port's
copy of ``munit_tpu/native``.

The first use builds ``build/native/<hash>/libmunit_imageops.so`` at the
root of the checkout (``build/`` is git-ignored) with the JAX package's g++
flags; the hash covers the source and the flags, so an edited source is
rebuilt once. Nothing is built at import. Where no ``g++`` is installed,
``available()`` is False and the transforms take the PIL path, as the JAX
package does; a ``g++`` that fails on the source raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "imageops.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
# munit_tpu/native/__init__.py's flags, so both packages compute alike
GXX_FLAGS = ("-O3", "-ffast-math", "-funroll-loops", "-march=native",
             "-shared", "-fPIC")

_lib = None
_missing = False
_lock = threading.Lock()


def library_path() -> Path:
    key = hashlib.sha256(SRC.read_bytes()
                         + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / key / "libmunit_imageops.so"


def _build(lib: Path) -> None:
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    out = subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)],
                         capture_output=True, text=True, timeout=120)
    if out.returncode != 0:
        raise RuntimeError(f"g++ failed on {SRC}:\n{out.stderr}")
    os.replace(tmp, lib)   # atomic: a concurrent build never sees a torn file


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built at the first call; None without g++."""
    global _lib, _missing
    with _lock:
        if _lib is not None or _missing:
            return _lib
        lib_path = library_path()
        if not lib_path.exists():
            if shutil.which("g++") is None:
                _missing = True
                return None
            _build(lib_path)
        lib = ctypes.CDLL(str(lib_path))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        f32p = ctypes.POINTER(ctypes.c_float)
        i32p = ctypes.POINTER(ctypes.c_int)
        lib.mt_transform.argtypes = [u8p] + [ctypes.c_int] * 10 + [f32p]
        lib.mt_transform.restype = ctypes.c_int
        lib.mt_resized_dims.argtypes = [ctypes.c_int, ctypes.c_int,
                                        ctypes.c_int, i32p, i32p]
        lib.mt_resized_dims.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    """True when the native library is built and loaded (the transforms
    then take it); False on a machine without g++."""
    return get_lib() is not None


def resized_dims(h: int, w: int, new_size: int) -> Tuple[int, int]:
    lib = get_lib()
    rh, rw = ctypes.c_int(), ctypes.c_int()
    lib.mt_resized_dims(h, w, new_size, ctypes.byref(rh), ctypes.byref(rw))
    return rh.value, rw.value


def fused_transform(src: np.ndarray, flip: bool, new_size: int,
                    crop_i: int, crop_j: int, crop_h: int, crop_w: int,
                    normalize: bool = True) -> np.ndarray:
    """uint8 HWC → float32 crop HWC in one native pass."""
    lib = get_lib()
    src = np.ascontiguousarray(src, dtype=np.uint8)
    h, w = src.shape[:2]
    c = 1 if src.ndim == 2 else src.shape[2]
    out = np.empty((crop_h, crop_w, c), np.float32)
    rc = lib.mt_transform(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w, c,
        int(flip), new_size, crop_i, crop_j, crop_h, crop_w, int(normalize),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc != 0:
        raise ValueError(f"mt_transform failed: {rc}")
    return out

