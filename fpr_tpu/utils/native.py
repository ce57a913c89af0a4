"""ctypes bindings to the native C++ runtime library (native/).

Builds libfpr_native.so with make on first use (g++, plain C ABI +
ctypes; the library is not committed).  Everything has a pure-Python/numpy
fallback, so the native library is an acceleration/validation layer, never
a hard dependency.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import uuid
from pathlib import Path

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_LIB_PATH = _NATIVE_DIR / "libfpr_native.so"
_lib = None
_build_failed = False


def get_lib():
    """The loaded library, building it if necessary; None if unavailable."""
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    try:
        if not _LIB_PATH.exists():
            # build under a unique name, then rename into place: several
            # processes (test workers) may build at once, and none may load
            # a half-written library
            tmp = _NATIVE_DIR / f".build-{uuid.uuid4().hex}.so"
            try:
                subprocess.run(
                    ["make", "-s", f"OUT={tmp.name}"], cwd=_NATIVE_DIR,
                    check=True, capture_output=True,
                )
                os.replace(tmp, _LIB_PATH)
            finally:
                tmp.unlink(missing_ok=True)
        lib = ctypes.CDLL(str(_LIB_PATH))
        c_double_p = ctypes.POINTER(ctypes.c_double)
        c_int32_p = ctypes.POINTER(ctypes.c_int32)
        lib.fio_probe.argtypes = [ctypes.c_char_p, c_int32_p, c_int32_p]
        lib.fio_probe.restype = ctypes.c_int
        lib.fio_read.argtypes = [ctypes.c_char_p, c_double_p, ctypes.c_int32, ctypes.c_int32]
        lib.fio_read.restype = ctypes.c_int
        lib.fio_write.argtypes = [ctypes.c_char_p, c_double_p, ctypes.c_int32, ctypes.c_int32]
        lib.fio_write.restype = ctypes.c_int
        lib.oracle_residual2d.argtypes = [
            c_double_p, c_double_p, ctypes.c_double, ctypes.c_double,
            ctypes.c_int32, ctypes.c_int32, c_double_p,
        ]
        lib.oracle_jacobi2d.argtypes = [
            c_double_p, c_double_p, ctypes.c_double, ctypes.c_double,
            ctypes.c_double, ctypes.c_int32, ctypes.c_int32, c_double_p,
        ]
        lib.oracle_jacobi2d.restype = ctypes.c_double
        lib.oracle_dual_time3d.argtypes = [
            c_double_p, c_double_p, ctypes.c_double, ctypes.c_double,
            ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, c_double_p,
        ]
        lib.oracle_dual_time3d.restype = ctypes.c_double
        _lib = lib
    except Exception:
        _build_failed = True
    return _lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def load_fortran_native(path) -> np.ndarray | None:
    lib = get_lib()
    if lib is None:
        return None
    nx = ctypes.c_int32()
    ny = ctypes.c_int32()
    if lib.fio_probe(str(path).encode(), ctypes.byref(nx), ctypes.byref(ny)):
        raise IOError(f"cannot read header of {path}")
    out = np.empty((ny.value, nx.value), dtype=np.float64)
    if lib.fio_read(str(path).encode(), _ptr(out), nx, ny):
        raise IOError(f"short read in {path}")
    return out


def save_fortran_native(path, arr: np.ndarray) -> bool:
    lib = get_lib()
    if lib is None:
        return False
    a = np.ascontiguousarray(arr, dtype=np.float64)
    ny, nx = a.shape
    if lib.fio_write(str(path).encode(), _ptr(a), nx, ny):
        raise IOError(f"cannot write {path}")
    return True


def oracle_residual2d(u, f, h, c):
    lib = get_lib()
    assert lib is not None
    u = np.ascontiguousarray(u, np.float64)
    f = np.ascontiguousarray(f, np.float64)
    res = np.empty_like(u)
    ny, nx = u.shape
    lib.oracle_residual2d(_ptr(u), _ptr(f), h, c, ny, nx, _ptr(res))
    return res


def oracle_jacobi2d(u, f, h, c, alpha=0.8):
    lib = get_lib()
    assert lib is not None
    u = np.ascontiguousarray(u, np.float64).copy()
    f = np.ascontiguousarray(f, np.float64)
    scratch = np.empty_like(u)
    ny, nx = u.shape
    sumsq = lib.oracle_jacobi2d(_ptr(u), _ptr(f), h, c, alpha, ny, nx, _ptr(scratch))
    return u, sumsq


def oracle_dual_time3d(ht, htau, dt, dtau, dx, dy, dz, D):
    lib = get_lib()
    assert lib is not None
    ht = np.ascontiguousarray(ht, np.float64)
    htau = np.ascontiguousarray(htau, np.float64)
    out = np.empty_like(htau)
    nz, ny, nx = ht.shape
    sumsq = lib.oracle_dual_time3d(
        _ptr(ht), _ptr(htau), dt, dtau, dx, dy, dz, D, nz, ny, nx, _ptr(out)
    )
    return out, sumsq
