"""ctypes binding to the native C++ runtime (``native/libltm_native.so``).

The port's own binding to the same library ``ltm.io.native`` loads; only
the host voxel grid is bound so far.  Auto-builds via ``make`` on first use
when a toolchain is available; without the library, callers fall back to
NumPy (first point per voxel instead of the native centroid).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

__all__ = ["get_lib", "available", "voxel_downsample_native"]

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libltm_native.so")
_lib: Optional[ctypes.CDLL] = None
_tried = False
_load_lock = threading.Lock()


def _configure(lib: ctypes.CDLL) -> ctypes.CDLL:
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.ltm_voxel_downsample.argtypes = [f32p, ctypes.c_long, ctypes.c_float, f32p, ctypes.c_long]
    lib.ltm_voxel_downsample.restype = ctypes.c_long
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    # locked first load: concurrent callers (the session-build thread pool)
    # must never see _tried=True with _lib still unset — that would route
    # some scans through the NumPy fallback, whose first-point-per-voxel
    # semantics differ from the native centroid
    with _load_lock:
        if _lib is not None or _tried:
            return _lib
        if not os.path.exists(_LIB_PATH):
            try:
                subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                               capture_output=True, timeout=120)
            except (OSError, subprocess.SubprocessError):
                _tried = True
                return None
        try:
            _lib = _configure(ctypes.CDLL(_LIB_PATH))
        except OSError:
            _lib = None
        _tried = True
    return _lib


def available() -> bool:
    return get_lib() is not None


def voxel_downsample_native(xyz: np.ndarray, voxel: float, capacity: Optional[int] = None) -> Optional[np.ndarray]:
    lib = get_lib()
    if lib is None:
        return None
    xyz = np.ascontiguousarray(xyz[:, :3], np.float32)
    cap = capacity or len(xyz)
    out = np.empty((cap, 3), np.float32)
    got = lib.ltm_voxel_downsample(xyz, len(xyz), voxel, out, cap)
    return out[:got] if got >= 0 else None
