"""Build and load the port's hand-written CUDA kernels.

Each ``ltm_torch/csrc/<name>.cu`` is compiled on first use by ``nvcc`` into
its own shared library with a plain C interface,
``<repo>/build/kernels/lib<name>_<hash>.so``, and loaded with ``ctypes``.
The hash covers the source and the flags, so an edited kernel rebuilds and
an unchanged one loads at once.  ``build_all`` starts one ``nvcc`` per
source, all together.  Nothing is built or imported when this module is
imported: the CPU tests import every module of the port.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List

__all__ = ["build_all", "load_kernel", "kernel_sources", "NVCC_FLAGS"]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def kernel_sources() -> List[str]:
    """Names of the kernel sources under ``csrc/`` (without ``.cu``)."""
    return sorted(f[:-3] for f in os.listdir(_SRC_DIR) if f.endswith(".cu"))


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit "
                           "(set CUDA_HOME or put nvcc on PATH)")
    return path


def _lib_path(name: str) -> str:
    with open(os.path.join(_SRC_DIR, name + ".cu"), "rb") as f:
        h = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}_{h}.so")


def build_all() -> Dict[str, str]:
    """Compile every kernel source whose library is missing, one ``nvcc``
    per source, all started together.  Returns {name: compiler output}
    (the ``-Xptxas -v`` register and shared-memory report)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in kernel_sources():
        lib = _lib_path(name)
        if os.path.exists(lib):
            continue
        tmp = f"{lib}.tmp{os.getpid()}"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(_SRC_DIR, name + ".cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, lib)
    logs = {}
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{out}")
            continue
        os.replace(tmp, lib)   # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load_kernel(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = _lib_path(name)
            if not os.path.exists(path):
                build_all()
            lib = ctypes.CDLL(path)
            _loaded[name] = lib
    return lib
