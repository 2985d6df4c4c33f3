"""Scan Context descriptor (.scd) text file I/O (the port's copy of
``ltm.io.scd``): rows of space-separated numbers, 3 decimal places
(reference ``saveSCD``/``readSCD``, ``ltslam/src/utility.cpp:212-246``)."""

from __future__ import annotations

import numpy as np

__all__ = ["read_scd", "write_scd"]


def read_scd(path: str) -> np.ndarray:
    return np.loadtxt(path, dtype=np.float64, ndmin=2)


def write_scd(path: str, desc: np.ndarray, precision: int = 3) -> None:
    np.savetxt(path, np.asarray(desc), fmt=f"%.{precision}f", delimiter=" ")
