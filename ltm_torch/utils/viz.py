"""Range-image visualization: JET-colormapped PNG dumps (stdlib only).

The reference publishes scan/map/diff range images as ROS topics with a JET
colormap for rviz (``convertColorMappedImg``,
``ltremovert/include/removert/utility.h:114-127``; ``pubRangeImg``,
``ltremovert/src/utility.cpp:248-256``).  Headless equivalent: write the
same colormapped images as PNGs next to the pipeline artifacts.  The
port's copy of ``ltm.utils.viz``.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

__all__ = ["jet_colormap", "write_png", "save_range_image_png", "write_rimg_index"]


def jet_colormap(x: np.ndarray) -> np.ndarray:
    """x in [0, 1] -> (..., 3) uint8 JET-style RGB."""
    x = np.clip(np.asarray(x, np.float64), 0.0, 1.0)

    def ch(v):
        return np.clip(1.5 - np.abs(v), 0.0, 1.0)

    r = ch(4.0 * x - 3.0)
    g = ch(4.0 * x - 2.0)
    b = ch(4.0 * x - 1.0)
    return (np.stack([r, g, b], axis=-1) * 255).astype(np.uint8)


def write_png(path: str, rgb: np.ndarray) -> None:
    """Minimal RGB8 PNG encoder (no external deps)."""
    rgb = np.asarray(rgb, np.uint8)
    h, w = rgb.shape[:2]
    raw = b"".join(b"\x00" + rgb[i].tobytes() for i in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        c = tag + data
        return struct.pack(">I", len(data)) + c + struct.pack(">I", zlib.crc32(c))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    png = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
           + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)


def save_range_image_png(path: str, img: np.ndarray, vmin: float = 0.0,
                         vmax: float = 20.0, no_point: float = 10000.0) -> None:
    """Colormapped range image (empty pixels black), reference color axis
    defaults (``rimg_color_min/max`` in ``params_ltmapper.yaml``)."""
    img = np.asarray(img, np.float64)
    norm = (img - vmin) / max(vmax - vmin, 1e-9)
    rgb = jet_colormap(norm)
    rgb[img >= no_point] = 0
    write_png(path, rgb)


def write_rimg_index(path: str, rows) -> None:
    """Browsable HTML index over the dumped range-image PNGs — the
    file-based analog of the reference's live rviz image topics
    (``ltremovert/src/Removerter.cpp:54-71``).  ``rows`` is an iterable of
    (keyframe_index, scan_name)."""
    parts = [
        "<!doctype html><meta charset='utf-8'><title>ltm range images</title>",
        "<style>body{font-family:sans-serif;background:#111;color:#ddd}"
        "img{width:100%;image-rendering:pixelated;margin:2px 0}"
        "h2{margin:18px 0 4px}</style>",
        "<h1>removert range images</h1>",
    ]
    for k, name in rows:
        parts.append(f"<h2>keyframe {k} — {name}</h2>")
        for kind in ("scan", "map", "diff"):
            parts.append(f"<div>{kind}</div><img src='rimg_{kind}_{k:04d}.png'>")
    with open(path, "w") as f:
        f.write("\n".join(parts))
