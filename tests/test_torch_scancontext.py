"""Scan Context retrieval of the port against ``ltm`` (under ``jit``) and the
f64 reference oracle, on the CPU:

  * ``make_descriptors`` bit-equal (0 bins differ on these fixtures);
  * ``sc_distance_matrix`` within 1e-5, and the same best shift;
  * the loop index and yaw sets of ``detect_loops_between_sessions`` /
    ``detect_loops_intra_session`` equal to ``ltm``'s, and the accepted
    loop set equal to the oracle's (``tests/ref_oracle_slam.py`` through
    the vectorized twin of ``tests/test_reference_oracle_slam.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltm.io.synthetic import make_two_sessions
from ltm.kernels import polar_bin as jpb
from ltm.retrieval import scancontext as jsc
from ltm_torch.kernels import polar_bin as tpb
from ltm_torch.retrieval import scancontext as tsc

from test_reference_oracle_slam import _bundle, detect_loops_vec

torch.set_num_threads(1)


def pad(scans, cap=None):
    cap = cap or 1 << int(max(len(s) for s in scans) - 1).bit_length()
    xyz = np.zeros((len(scans), cap, 3), np.float32)
    msk = np.zeros((len(scans), cap), bool)
    for i, s in enumerate(scans):
        xyz[i, :len(s)] = s[:, :3]
        msk[i, :len(s)] = True
    return xyz, msk


@pytest.fixture(scope="module")
def descs():
    """Descriptors of the pipeline fixture (24 kf x 4 000 pts, seed 3) by both
    packages: central (target) and query (source)."""
    b = make_two_sessions(num_keyframes=24, num_cars=10, num_changed=4,
                          max_scan_points=4000, seed=3)
    out = {}
    for key in ("central", "query"):
        xyz, msk = pad(b[key].data.scans)
        out[key] = (np.asarray(jpb.make_descriptors(jnp.asarray(xyz), jnp.asarray(msk))),
                    tpb.make_descriptors(torch.from_numpy(xyz), torch.from_numpy(msk)).numpy())
    return out


def test_descriptors_bit_equal(descs):
    for key, (ref, got) in descs.items():
        assert int((ref != got).sum()) == 0, key
        assert (ref > 0).sum() > 100


def test_descriptors_random_points_bit_equal(rng):
    """Points over the whole polar grid, beyond max_radius and masked."""
    xyz = rng.uniform(-90, 90, (6, 4096, 3)).astype(np.float32)
    msk = rng.uniform(size=(6, 4096)) > 0.2
    ref = np.asarray(jpb.make_descriptors(jnp.asarray(xyz), jnp.asarray(msk)))
    got = tpb.make_descriptors(torch.from_numpy(xyz), torch.from_numpy(msk)).numpy()
    assert int((ref != got).sum()) == 0


@pytest.mark.parametrize("full", [False, True])
def test_sc_distance_matrix(descs, full):
    q, t = descs["query"][0], descs["central"][0]
    d_ref, s_ref = (np.asarray(x) for x in jsc.sc_distance_matrix(
        jnp.asarray(q), jnp.asarray(t), full_shift_search=full))
    d, s = tsc.sc_distance_matrix(torch.from_numpy(q), torch.from_numpy(t), full_shift_search=full)
    np.testing.assert_allclose(d.numpy(), d_ref, atol=1e-5)
    assert s.dtype == torch.int32
    np.testing.assert_array_equal(s.numpy(), s_ref)


def test_loops_between_sessions_match_ltm(descs):
    q, t = descs["query"][0], descs["central"][0]
    qm = np.ones(len(q), bool)
    tm = np.ones(len(t), bool)
    tm[-3:] = False                               # a masked target tail
    ref = [np.asarray(x) for x in jsc.detect_loops_between_sessions(
        jnp.asarray(q), jnp.asarray(qm), jnp.asarray(t), jnp.asarray(tm))]
    got = [x.numpy() for x in tsc.detect_loops_between_sessions(
        *(torch.from_numpy(a) for a in (q, qm, t, tm)))]
    assert (ref[0] >= 0).sum() >= 4
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[2], ref[2])
    np.testing.assert_allclose(got[1], ref[1], atol=1e-5)


@pytest.mark.parametrize("exclude", [4, 8])
def test_loops_intra_session_match_ltm(descs, exclude):
    d = descs["query"][0]
    valid = np.ones(len(d), bool)
    valid[10] = False
    ref = [np.asarray(x) for x in jsc.detect_loops_intra_session(
        jnp.asarray(d), jnp.asarray(valid), dist_threshold=0.45, num_exclude_recent=exclude)]
    got = [x.numpy() for x in tsc.detect_loops_intra_session(
        torch.from_numpy(d), torch.from_numpy(valid), dist_threshold=0.45,
        num_exclude_recent=exclude)]
    assert (ref[0] >= 0).sum() >= 1
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[2], ref[2])
    np.testing.assert_allclose(got[1], ref[1], atol=1e-5)


def test_retrieval_matches_oracle():
    """The port's accepted loop pairs, misses and shifts equal the reference
    algorithm's (f64 oracle) on a bench-generator survey (150 kf)."""
    b = _bundle(150, 4000)
    src = [s[:, :3] for s in b["query"].data.scans]
    tgt = [s[:, :3] for s in b["central"].data.scans]
    o_pairs, o_miss, o_shifts = detect_loops_vec(src, tgt)
    (t_xyz, t_msk), (q_xyz, q_msk) = pad(tgt), pad(src)
    t_desc = tpb.make_descriptors(torch.from_numpy(t_xyz), torch.from_numpy(t_msk))
    q_desc = tpb.make_descriptors(torch.from_numpy(q_xyz), torch.from_numpy(q_msk))
    loop_idx, _, yaw = tsc.detect_loops_between_sessions(
        q_desc, torch.ones(len(src), dtype=torch.bool), t_desc, torch.ones(len(tgt), dtype=torch.bool))
    loop_idx, yaw = loop_idx.numpy(), yaw.numpy()
    pairs = [(int(loop_idx[q]), q) for q in range(len(src)) if loop_idx[q] >= 0]
    misses = [q for q in range(len(src)) if loop_idx[q] < 0]
    assert len(o_pairs) > 100 and len(o_miss) > 0
    assert pairs == o_pairs
    assert misses == o_miss
    shift = np.rint(yaw / (2 * np.pi / 60)).astype(int) % 60
    for _, q in o_pairs:
        assert shift[q] == o_shifts[q], q
