"""ctypes binding to the native C++ runtime (``native/libltm_native.so``).

The port's own binding to the same library ``ltm.io.native`` loads: the PCD,
KITTI ``.bin`` and pose readers, the PCD writer and the host voxel grid.
Auto-builds via ``make`` on first use when a toolchain is available, with
the Makefile's own compiler, ``g++``, whatever ``CXX`` the environment
sets: a compiler that links libstdc++ statically into the library gives
iostreams that crash (the PCD writer segfaulted in such a build).  Every
entry point has a pure-Python fallback in ``ltm_torch.io.pcd``/``poses``
(the voxel grid's NumPy fallback keeps the first point per voxel instead of
the native centroid).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

__all__ = ["get_lib", "available", "read_pcd_native", "write_pcd_native",
           "read_kitti_bin_native", "read_poses_native", "voxel_downsample_native"]

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libltm_native.so")
_lib: Optional[ctypes.CDLL] = None
_tried = False
_load_lock = threading.Lock()


def _configure(lib: ctypes.CDLL) -> ctypes.CDLL:
    c_char_p, c_long = ctypes.c_char_p, ctypes.c_long
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.ltm_pcd_num_points.argtypes = [c_char_p]
    lib.ltm_pcd_num_points.restype = c_long
    lib.ltm_read_pcd.argtypes = [c_char_p, f32p, c_long]
    lib.ltm_read_pcd.restype = c_long
    lib.ltm_write_pcd.argtypes = [c_char_p, f32p, c_long, ctypes.c_int]
    lib.ltm_write_pcd.restype = ctypes.c_int
    lib.ltm_read_kitti_bin.argtypes = [c_char_p, f32p, c_long]
    lib.ltm_read_kitti_bin.restype = c_long
    lib.ltm_read_poses.argtypes = [c_char_p, f64p, c_long]
    lib.ltm_read_poses.restype = c_long
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
                subprocess.run(["make", "-C", _NATIVE_DIR, "CXX=g++"], check=True,
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


def read_pcd_native(path: str) -> Optional[np.ndarray]:
    """(N, 4) x, y, z, intensity of a binary or ascii PCD, or None (no
    library, or a format it does not read: binary_compressed)."""
    lib = get_lib()
    if lib is None:
        return None
    n = lib.ltm_pcd_num_points(path.encode())
    if n < 0:
        return None
    out = np.empty((n, 4), np.float32)
    got = lib.ltm_read_pcd(path.encode(), out, n)
    return out[:got] if got >= 0 else None


def write_pcd_native(path: str, xyzi: np.ndarray, binary: bool = True) -> bool:
    lib = get_lib()
    if lib is None:
        return False
    xyzi = np.ascontiguousarray(xyzi, np.float32)
    return lib.ltm_write_pcd(path.encode(), xyzi, len(xyzi), 1 if binary else 0) == 0


def read_kitti_bin_native(path: str) -> Optional[np.ndarray]:
    lib = get_lib()
    if lib is None:
        return None
    size = os.path.getsize(path) // 16
    out = np.empty((size, 4), np.float32)
    got = lib.ltm_read_kitti_bin(path.encode(), out, size)
    return out[:got] if got >= 0 else None


def read_poses_native(path: str) -> Optional[np.ndarray]:
    """(N, 4, 4) float64 poses of a file of 12- or 16-value lines, or None."""
    lib = get_lib()
    if lib is None:
        return None
    with open(path) as f:
        n_lines = sum(1 for line in f if line.strip())
    out = np.empty((n_lines, 4, 4), np.float64)
    got = lib.ltm_read_poses(path.encode(), out.reshape(-1, 16), n_lines)
    return out[:got] if got >= 0 else None


def voxel_downsample_native(xyz: np.ndarray, voxel: float, capacity: Optional[int] = None) -> Optional[np.ndarray]:
    lib = get_lib()
    if lib is None:
        return None
    xyz = np.ascontiguousarray(xyz[:, :3], np.float32)
    cap = capacity or len(xyz)
    out = np.empty((cap, 3), np.float32)
    got = lib.ltm_voxel_downsample(xyz, len(xyz), voxel, out, cap)
    return out[:got] if got >= 0 else None
