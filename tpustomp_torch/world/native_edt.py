"""ctypes bindings to the native C++ EDT (``native/edt.cpp``, shared with the
JAX package, read in place).

At first use the source is compiled with g++ into ``tpustomp_torch/_build/``
under a name that carries a hash of the source and flags, so an edited
source is never served by a stale build. Host work, never in the device
loop. Without a compiler (or without the source) `available()` is False and
world/edt.py takes its next route.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
_SOURCE = _PKG.parent / "native" / "edt.cpp"
_BUILD_DIR = _PKG / "_build"
_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-pthread")
_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> Path | None:
    if not _SOURCE.exists():
        return None
    digest = hashlib.sha256(_SOURCE.read_bytes()
                            + " ".join(_FLAGS).encode()).hexdigest()[:16]
    out = _BUILD_DIR / f"libedt_{digest}.so"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *_FLAGS, str(_SOURCE), "-o", tmp], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, out)        # atomic: concurrent builds never race
        return out
    except (subprocess.SubprocessError, OSError):
        return None
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = _build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        lib.edt_sq_3d.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_double),
            ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.edt_sq_3d.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def edt_sq(seed: np.ndarray) -> np.ndarray:
    """Exact squared EDT (voxel² units) to the nearest True voxel. [X,Y,Z]."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native EDT library unavailable")
    seed = np.ascontiguousarray(seed, np.uint8)
    out = np.empty(seed.shape, np.float64)
    lib.edt_sq_3d(seed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                  out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                  *map(int, seed.shape))
    out[out >= 1e29] = np.inf
    return out
