"""The port's file I/O (``ltm_torch.io``, ``RemovertInput.from_dirs``) vs
``ltm.io``: each package reads what the other writes, on the native path
and on the pure-Python one."""

import os
import struct

import numpy as np
import pytest
import torch

from ltm.io import pcd as j_pcd
from ltm.io import poses as j_poses
from ltm.removert import RemovertInput as JRemovertInput
from ltm_torch.io import native
from ltm_torch.io import pcd as t_pcd
from ltm_torch.io import poses as t_poses
from ltm_torch.io.sessions import indexed_files
from ltm_torch.removert import RemovertInput

torch.set_num_threads(1)


@pytest.fixture(params=["native", "python"])
def io_path(request, monkeypatch):
    """Run the port's readers and writers on the native library (when it
    is built) or on their pure-Python fallbacks."""
    if request.param == "python":
        monkeypatch.setattr(native, "available", lambda: False)
    elif not native.available():
        pytest.skip("native/libltm_native.so is not built")
    return request.param


def _cloud(rng, n=300):
    return np.concatenate([rng.uniform(-50, 50, (n, 3)), rng.uniform(0, 1, (n, 1))],
                          1).astype(np.float32)


def _lzf_literals(raw: bytes) -> bytes:
    """LZF stream of ``raw``: a back-reference wherever the previous 16
    bytes repeat (a point record repeated), literals elsewhere."""
    out, i = bytearray(), 0
    while i < len(raw):
        if i >= 16 and raw[i:i + 16] == raw[i - 16:i]:
            # length 16 = 7 + 7 + 2: ctrl (7 << 5 | off_hi), extra 7, off_lo
            off = 16 - 1
            out += bytes([(7 << 5) | (off >> 8), 16 - 2 - 7, off & 0xFF])
            i += 16
            continue
        j = i
        while j < len(raw) and j - i < 32 and not (j >= 16 and raw[j:j + 16] == raw[j - 16:j]):
            j += 1
        out += bytes([j - i - 1]) + raw[i:j]
        i = j
    return bytes(out)


def _write_binary_compressed(path, xyzi):
    n = len(xyzi)
    raw = b"".join(np.ascontiguousarray(xyzi[:, c]).tobytes() for c in range(4))   # SoA
    comp = _lzf_literals(raw)
    header = ("VERSION 0.7\nFIELDS x y z intensity\nSIZE 4 4 4 4\nTYPE F F F F\n"
              f"COUNT 1 1 1 1\nWIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\n"
              "DATA binary_compressed\n")
    with open(path, "wb") as f:
        f.write(header.encode() + struct.pack("<II", len(comp), len(raw)) + comp)


@pytest.mark.parametrize("binary", [True, False], ids=["binary", "ascii"])
def test_pcd_round_trips_with_ltm(tmp_path, rng, io_path, binary):
    pts = _cloud(rng)
    j_pcd.write_pcd(str(tmp_path / "a.pcd"), pts, binary=binary)
    t_pcd.write_pcd(str(tmp_path / "b.pcd"), pts, binary=binary)
    for name in ("a.pcd", "b.pcd"):
        got = t_pcd.read_pcd(str(tmp_path / name))
        ref = j_pcd.read_pcd(str(tmp_path / name))
        np.testing.assert_array_equal(got, ref)
        if binary:
            np.testing.assert_array_equal(got, pts)
        else:
            np.testing.assert_allclose(got, pts, rtol=1e-7)


def test_pcd_binary_compressed_matches_ltm(tmp_path, rng, io_path):
    pts = _cloud(rng, 200)
    pts[50:60] = pts[49]            # repeated records: the stream has back-references
    path = str(tmp_path / "c.pcd")
    _write_binary_compressed(path, pts)
    got = t_pcd.read_pcd(path)
    np.testing.assert_array_equal(got, pts)
    np.testing.assert_array_equal(got, j_pcd.read_pcd(path))


def test_kitti_bin_and_poses_round_trip(tmp_path, rng, io_path):
    pts = _cloud(rng)
    j_pcd.write_kitti_bin(str(tmp_path / "a.bin"), pts)
    t_pcd.write_kitti_bin(str(tmp_path / "b.bin"), pts)
    for name in ("a.bin", "b.bin"):
        np.testing.assert_array_equal(t_pcd.read_kitti_bin(str(tmp_path / name)), pts)
        np.testing.assert_array_equal(j_pcd.read_kitti_bin(str(tmp_path / name)), pts)
    T = np.tile(np.eye(4), (5, 1, 1))
    T[:, :3, :4] = rng.normal(size=(5, 3, 4))
    j_poses.write_kitti_poses(str(tmp_path / "a.txt"), T)
    t_poses.write_kitti_poses(str(tmp_path / "b.txt"), T)
    for name in ("a.txt", "b.txt"):
        np.testing.assert_array_equal(t_poses.read_kitti_poses(str(tmp_path / name)), T)
        np.testing.assert_array_equal(j_poses.read_kitti_poses(str(tmp_path / name)), T)


def test_from_dirs_matches_ltm(tmp_path, rng, io_path):
    """Names sort by their leading index: '10.pcd' after '2.pcd'."""
    scans = tmp_path / "scans"
    scans.mkdir()
    idx = [0, 1, 2, 10, 11]
    clouds = {i: _cloud(rng, 50 + i) for i in idx}
    for i in idx:
        j_pcd.write_pcd(str(scans / f"{i}.pcd"), clouds[i])
    T = np.tile(np.eye(4), (len(idx), 1, 1))
    T[:, :3, 3] = rng.normal(size=(len(idx), 3))
    j_poses.write_kitti_poses(str(tmp_path / "poses.txt"), T)
    got = RemovertInput.from_dirs(str(scans), str(tmp_path / "poses.txt"))
    ref = JRemovertInput.from_dirs(str(scans), str(tmp_path / "poses.txt"))
    assert got.names == ref.names == [f"{i}.pcd" for i in idx]
    for a, b, i in zip(got.scans, ref.scans, idx):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, clouds[i])
    np.testing.assert_array_equal(got.poses, ref.poses)
    assert [os.path.basename(p) for p in indexed_files(str(scans), ".pcd")] == got.names
    j_poses.write_kitti_poses(str(tmp_path / "short.txt"), T[:3])
    with pytest.raises(ValueError, match="5 scans vs 3 poses"):
        RemovertInput.from_dirs(str(scans), str(tmp_path / "short.txt"))
