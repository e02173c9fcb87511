"""ctypes bindings for the native geometry core (native/geom.cpp).

Compiled lazily with g++ on first use into native/build/ (not committed),
and rebuilt whenever geom.cpp is newer than the library; every entry point
has a numpy fallback in `utils.sets`, so the package works even without a
toolchain.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_ROOT = pathlib.Path(__file__).resolve().parents[1]
_SRC = _ROOT / "native" / "geom.cpp"
_LIB_PATH = _ROOT / "native" / "build" / "libbp_geom.so"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _compile() -> bool:
    """Build into a private file, then move it into place in one step, so
    concurrent processes never load a half-written library."""
    _LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
    tmp = _LIB_PATH.with_name(f"{_LIB_PATH.name}.{os.getpid()}.tmp")
    cmd = [
        "g++", "-O3", "-shared", "-fPIC", "-std=c++17",
        str(_SRC), "-o", str(tmp),
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB_PATH)
        return True
    except Exception:
        tmp.unlink(missing_ok=True)
        return False


def _stale() -> bool:
    """No library yet, or one built before the last edit of its source."""
    if not _LIB_PATH.exists():
        return True
    return _SRC.exists() and _SRC.stat().st_mtime > _LIB_PATH.stat().st_mtime


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if _stale() and (not _SRC.exists() or not _compile()):
            return None
        try:
            lib = ctypes.CDLL(str(_LIB_PATH))
        except OSError:
            return None
        lib.bp_polytope_vertices.restype = ctypes.c_int
        lib.bp_polytope_vertices.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.c_int, ctypes.c_double,
            ctypes.POINTER(ctypes.c_double), ctypes.c_int,
        ]
        lib.bp_reduce_ineqs.restype = ctypes.c_int
        lib.bp_reduce_ineqs.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.c_int, ctypes.c_double, ctypes.c_double,
            ctypes.POINTER(ctypes.c_uint8),
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _as_c(arr):
    arr = np.ascontiguousarray(arr, dtype=np.float64)
    return arr, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def polytope_vertices(a_set, b_set, tol: float = 1e-7) -> np.ndarray:
    lib = _load()
    if lib is None:
        raise RuntimeError("native geom core unavailable")
    a, a_p = _as_c(np.asarray(a_set).reshape(-1, 3))
    b, b_p = _as_c(np.asarray(b_set).reshape(-1))
    m = b.shape[0]
    cap = 2048
    out = np.empty((cap, 3), dtype=np.float64)
    n = lib.bp_polytope_vertices(
        a_p, b_p, m, tol, out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), cap
    )
    if n < 0:
        raise RuntimeError("vertex buffer overflow")
    return out[:n].copy()


def reduce_ineqs(a_set, b_set) -> Tuple[np.ndarray, np.ndarray]:
    lib = _load()
    if lib is None:
        raise RuntimeError("native geom core unavailable")
    a, a_p = _as_c(np.asarray(a_set).reshape(-1, 3))
    b, b_p = _as_c(np.asarray(b_set).reshape(-1))
    m = b.shape[0]
    keep = np.zeros(m, dtype=np.uint8)
    n = lib.bp_reduce_ineqs(
        a_p, b_p, m, 1e-7, 1e-6, keep.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    )
    if n < 0:
        raise RuntimeError("vertex buffer overflow")
    mask = keep.astype(bool)
    return a[mask].copy(), b[mask].copy()
