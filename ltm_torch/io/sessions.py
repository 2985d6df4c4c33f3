"""Session directory file naming (the port's part of ``ltm.io.sessions``).

File names start with the integer keyframe index (the reference splits on
',' and stoi's the prefix, ``ltslam/src/Session.cpp:153-161``).  Loading a
whole session directory (pose graph, Scan Context descriptors) comes with
LT-SLAM.
"""

from __future__ import annotations

import os
import re
from typing import List

__all__ = ["indexed_files"]

_IDX_RE = re.compile(r"^(\d+)")


def _file_index(name: str) -> int:
    """Leading-integer index of a scan/SCD filename (handles 'idx,stamp.ext')."""
    m = _IDX_RE.match(name.split(",")[0])
    if not m:
        raise ValueError(f"cannot parse keyframe index from {name!r}")
    return int(m.group(1))


def indexed_files(directory: str, suffix: str) -> List[str]:
    """Files in ``directory`` with ``suffix``, sorted by leading index."""
    names = [n for n in os.listdir(directory) if n.endswith(suffix)]
    names.sort(key=_file_index)
    return [os.path.join(directory, n) for n in names]
