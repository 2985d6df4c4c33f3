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


def _same_session(a, b):
    assert a.name == b.name
    np.testing.assert_array_equal(a.node_ids, b.node_ids)
    np.testing.assert_array_equal(a.poses, b.poses)
    for x, y in zip(a.edges, b.edges):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert len(a.scans) == len(b.scans)
    for x, y in zip(a.scans, b.scans):
        np.testing.assert_array_equal(x, y)
    if a.descriptors is None or b.descriptors is None:
        assert a.descriptors is None and b.descriptors is None
    else:
        np.testing.assert_array_equal(a.descriptors, b.descriptors)


@pytest.mark.parametrize("writer", ["ltm", "port"])
def test_session_dirs_round_trip_with_ltm(tmp_path, writer):
    """A session directory (g2o, SCDs, Scans) written by either package loads
    identically in both, with and without node truncation."""
    from ltm.io import sessions as j_sessions
    from ltm.io.synthetic import make_two_sessions as j_make
    from ltm_torch.io import sessions as t_sessions
    from ltm_torch.slam.convert import session_from_data

    data = j_make(num_keyframes=10, num_cars=4, num_changed=2, max_scan_points=400, seed=2)["query"].data
    data.descriptors = np.random.default_rng(0).uniform(0, 5, (10, 20, 60)).astype(np.float32)
    d = str(tmp_path / "02")
    if writer == "ltm":
        j_sessions.write_session_dir(d, data)
    else:
        t_sessions.write_session_dir(d, session_from_data(data))
    for max_nodes in (None, 6):
        ref = j_sessions.load_session_dir(d, max_nodes=max_nodes)
        got = t_sessions.load_session_dir(d, max_nodes=max_nodes)
        _same_session(ref, got)
    assert got.num_nodes == 6 and len(got.edges[0]) > 0


def test_g2o_round_trips_with_ltm(tmp_path, rng):
    from ltm.io import g2o as j_g2o
    from ltm_torch.io import g2o as t_g2o
    from ltm_torch.io import scd as t_scd
    from ltm.io import scd as j_scd

    g = t_g2o.G2oGraph(node_ids=[0, 1, 2], node_poses=[np.eye(4)] * 3,
                       edge_from=[0, 1], edge_to=[1, 2], edge_rel=[np.eye(4)] * 2)
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    g.node_poses[1] = t_g2o._pose_from([1.0, -2.0, 0.5], q)
    t_g2o.write_g2o(str(tmp_path / "a.g2o"), g)
    ref = j_g2o.read_g2o(str(tmp_path / "a.g2o"))
    got = t_g2o.read_g2o(str(tmp_path / "a.g2o"))
    np.testing.assert_array_equal(got.poses_array(), ref.poses_array())
    np.testing.assert_allclose(got.poses_array()[1], g.node_poses[1], atol=1e-12)
    for x, y in zip(got.edges_arrays(), ref.edges_arrays()):
        np.testing.assert_array_equal(x, y)
    desc = rng.uniform(0, 9, (20, 60))
    t_scd.write_scd(str(tmp_path / "a.scd"), desc)
    np.testing.assert_array_equal(t_scd.read_scd(str(tmp_path / "a.scd")),
                                  j_scd.read_scd(str(tmp_path / "a.scd")))


@pytest.mark.parametrize("kw", [dict(seed=11, num_keyframes=6, max_scan_points=800, scan_range=70.0,
                                     odom_noise=5e-4),
                                dict(seed=3, num_keyframes=5, num_cars=10, max_scan_points=500)])
def test_synthetic_sessions_match_ltm(kw):
    """The port's ParkingLot generator gives ltm's sessions for a seed."""
    from ltm.io.synthetic import make_two_sessions as j_make
    from ltm_torch.io.synthetic import make_two_sessions as t_make

    ref, got = j_make(**kw), t_make(**kw)
    for key in ("central", "query"):
        _same_session(ref[key].data, got[key].data)
        np.testing.assert_array_equal(ref[key].site_poses, got[key].site_poses)
        for x, y in zip(ref[key].scan_labels, got[key].scan_labels):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(ref["anchor_query"], got["anchor_query"])
