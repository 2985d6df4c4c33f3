"""PCD (Point Cloud Data) file I/O, PCL-compatible.

Supports the formats the reference produces/consumes:
  * ``DATA binary`` — what ``pcl::io::savePCDFileBinary`` writes (all scan and
    map artifacts, e.g. ``ltremovert/src/Removerter.cpp:232,1517``);
  * ``DATA ascii``;
  * KITTI ``.bin`` raw float32 x,y,z,intensity (reference ``readBin``,
    ``ltremovert/src/utility.cpp:6-26``).

A native C++ fast path (``ltm_torch.io.native``) is used for binary and
ascii files and KITTI ``.bin`` when the shared library is built; the
pure-Python path (with its own LZF decoder for ``binary_compressed``) is
the fallback and the correctness reference.  The port's copy of
``ltm.io.pcd``.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ltm_torch.io import native

__all__ = ["read_pcd", "write_pcd", "read_kitti_bin", "write_kitti_bin"]

_TYPE_MAP = {("F", 4): "f4", ("F", 8): "f8", ("I", 1): "i1", ("I", 2): "i2", ("I", 4): "i4",
             ("U", 1): "u1", ("U", 2): "u2", ("U", 4): "u4"}


def _parse_header(data: bytes):
    fields, sizes, types, counts = [], [], [], []
    width = height = points = None
    fmt = None
    offset = 0
    lines = []
    start = 0
    while True:
        end = data.find(b"\n", start)
        if end < 0:
            raise ValueError("unterminated PCD header")
        line = data[start:end].decode("ascii", "replace").strip()
        start = end + 1
        lines.append(line)
        if not line or line.startswith("#"):
            continue
        key, *vals = line.split()
        key = key.upper()
        if key == "FIELDS":
            fields = vals
        elif key == "SIZE":
            sizes = [int(v) for v in vals]
        elif key == "TYPE":
            types = vals
        elif key == "COUNT":
            counts = [int(v) for v in vals]
        elif key == "WIDTH":
            width = int(vals[0])
        elif key == "HEIGHT":
            height = int(vals[0])
        elif key == "POINTS":
            points = int(vals[0])
        elif key == "DATA":
            fmt = vals[0].lower()
            offset = start
            break
    if points is None:
        points = (width or 0) * (height or 1)
    if not counts:
        counts = [1] * len(fields)
    return fields, sizes, types, counts, points, fmt, offset


def read_pcd(path: str, want_intensity: bool = True) -> np.ndarray:
    """Read a PCD file -> (N, 4) float32 [x, y, z, intensity] (or (N,3))."""
    if native.available():
        out = native.read_pcd_native(path)
        if out is not None:
            return out if want_intensity else out[:, :3]

    with open(path, "rb") as f:
        data = f.read()
    fields, sizes, types, counts, points, fmt, offset = _parse_header(data)

    np_fields = []
    for name, size, typ, count in zip(fields, sizes, types, counts):
        base = _TYPE_MAP.get((typ.upper(), size))
        if base is None:
            raise ValueError(f"unsupported PCD field type {typ}{size}")
        if count == 1:
            np_fields.append((name, "<" + base))
        else:
            np_fields.append((name, "<" + base, (count,)))
    dtype = np.dtype(np_fields)

    if fmt == "binary":
        arr = np.frombuffer(data, dtype=dtype, count=points, offset=offset)
    elif fmt == "ascii":
        text = data[offset:].decode("ascii", "replace")
        flat = np.array(text.split(), dtype=np.float64)
        ncols = sum(counts)
        flat = flat.reshape(points, ncols)
        arr = np.zeros(points, dtype=dtype)
        col = 0
        for name, count in zip(fields, counts):
            if count == 1:
                arr[name] = flat[:, col]
            else:
                arr[name] = flat[:, col : col + count]
            col += count
    elif fmt == "binary_compressed":
        arr = _read_binary_compressed(data, offset, dtype, fields, counts, points)
    else:
        raise ValueError(f"unsupported PCD DATA format: {fmt}")

    out_cols = ["x", "y", "z"] + (["intensity"] if want_intensity and "intensity" in fields else [])
    out = np.empty((points, len(out_cols)), np.float32)
    for i, name in enumerate(out_cols):
        out[:, i] = arr[name].astype(np.float32)
    return out


def _read_binary_compressed(data, offset, dtype, fields, counts, points):
    """PCL binary_compressed: LZF-compressed, SoA field layout."""
    import struct

    comp_size, uncomp_size = struct.unpack_from("<II", data, offset)
    comp = data[offset + 8 : offset + 8 + comp_size]
    raw = _lzf_decompress(comp, uncomp_size)
    arr = np.zeros(points, dtype=dtype)
    pos = 0
    for name, count in zip(fields, counts):
        sub = dtype[name]
        nbytes = sub.itemsize * points
        field_data = np.frombuffer(raw[pos : pos + nbytes], dtype=sub.base if sub.shape else sub)
        if sub.shape:
            field_data = field_data.reshape(points, *sub.shape)
        arr[name] = field_data
        pos += nbytes
    return arr


def _lzf_decompress(data: bytes, expected: int) -> bytes:
    """Minimal LZF decompressor (PCL uses liblzf for binary_compressed)."""
    out = bytearray()
    i = 0
    n = len(data)
    while i < n:
        ctrl = data[i]
        i += 1
        if ctrl < 32:
            length = ctrl + 1
            out += data[i : i + length]
            i += length
        else:
            length = ctrl >> 5
            if length == 7:
                length += data[i]
                i += 1
            ref = len(out) - ((ctrl & 0x1F) << 8) - data[i] - 1
            i += 1
            for _ in range(length + 2):
                out.append(out[ref])
                ref += 1
    if len(out) != expected:
        raise ValueError(f"LZF: expected {expected} bytes, got {len(out)}")
    return bytes(out)


def write_pcd(path: str, xyz: np.ndarray, intensity: Optional[np.ndarray] = None,
              binary: bool = True) -> None:
    """Write [x, y, z, intensity] float32 PCD (PCL savePCDFileBinary layout)."""
    xyz = np.asarray(xyz, np.float32)
    if xyz.ndim == 2 and xyz.shape[1] == 4 and intensity is None:
        intensity = xyz[:, 3]
        xyz = xyz[:, :3]
    n = xyz.shape[0]
    if intensity is None:
        intensity = np.zeros((n,), np.float32)
    intensity = np.asarray(intensity, np.float32).reshape(n)

    if native.available():
        body = np.concatenate([xyz, intensity[:, None]], axis=1)
        if native.write_pcd_native(path, body, binary=binary):
            return

    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        "FIELDS x y z intensity\n"
        "SIZE 4 4 4 4\n"
        "TYPE F F F F\n"
        "COUNT 1 1 1 1\n"
        f"WIDTH {n}\n"
        "HEIGHT 1\n"
        "VIEWPOINT 0 0 0 1 0 0 0\n"
        f"POINTS {n}\n"
        f"DATA {'binary' if binary else 'ascii'}\n"
    )
    body = np.empty((n, 4), np.float32)
    body[:, :3] = xyz
    body[:, 3] = intensity
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if binary:
            f.write(body.tobytes())
        else:
            np.savetxt(f, body, fmt="%.8g")


def read_kitti_bin(path: str) -> np.ndarray:
    """KITTI velodyne .bin -> (N, 4) float32 [x, y, z, intensity]."""
    if native.available():
        out = native.read_kitti_bin_native(path)
        if out is not None:
            return out
    raw = np.fromfile(path, dtype=np.float32)
    return raw.reshape(-1, 4)


def write_kitti_bin(path: str, xyzi: np.ndarray) -> None:
    np.asarray(xyzi, np.float32).reshape(-1, 4).tofile(path)
