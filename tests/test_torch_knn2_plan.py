"""The CUDA 2-NN kernel's Python side on the CPU: its launch plan, and its
compaction, write-back and target-split route rebuilt from plain versions
(``_compact_plain`` for the compaction kernel, ``knn2_sqdists_plain`` on
each split, then ``_merge_plain`` for the merge kernel), which must equal
the whole call bit for bit, and ``ltm``'s XLA 2-NN to one ulp.

The kernels themselves need the card: ``chip_smoke.py`` holds the split and
unsplit routes against ``knn2_sqdists_plain`` there at 0 ulps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltm.kernels import knn as jknn
from ltm_torch.kernels.knn2 import _R, _THREADS, _TILE, _plan, _split_len, knn2_sqdists_plain

torch.set_num_threads(1)

BIG = np.float32(1e30)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _compact_plain(query_mask, target_xyz, target_mask, m_pad: int, out):
    """What the compaction kernel computes: ``(qidx, t4)``, the rows of the
    valid queries in order (int32), and the valid targets in order as
    ``(m_pad, 4)`` float32 rows ``(x, y, z, 0)``, padded with ``+inf``
    points, whose distance to any query is ``+inf``; the invalid queries'
    rows of ``out`` are set to 1e30 (the scan writes the others)."""
    out[~query_mask] = 1e30
    t4 = torch.full((m_pad, 4), torch.inf, dtype=torch.float32)
    t4[:, 3] = 0.0
    valid = target_xyz[target_mask]
    t4[:valid.shape[0], :3] = valid
    return torch.nonzero(query_mask).squeeze(1).to(torch.int32), t4


def _merge_plain(part):
    """What the merge kernel computes: ``(splits, n, 2)`` partial top-2s to
    the ``(n, 2)`` two smallest of each query's ``2·splits`` values."""
    rows = part.permute(1, 0, 2).reshape(part.shape[1], -1)
    return torch.sort(rows, dim=1).values[:, :2]


def _split_route(q, qm, t, tm, splits, tile):
    """The kernel's split route with plain parts: compact, 2-NN of the valid
    queries against each chunk of compacted targets, merge, write back."""
    n_valid, m_valid = int(qm.sum()), int(tm.sum())
    if n_valid == 0 or m_valid == 0:
        return torch.full((q.shape[0], 2), 1e30, dtype=torch.float32)
    out = torch.empty((q.shape[0], 2), dtype=torch.float32)
    chunk = _split_len(m_valid, splits, tile)
    qidx, t4 = _compact_plain(qm, t, tm, splits * chunk, out)
    qv = q[qidx.long()]
    real = torch.arange(splits * chunk) < m_valid          # padding rows are not targets
    part = torch.stack([
        knn2_sqdists_plain(qv, torch.ones(n_valid, dtype=torch.bool),
                           t4[s * chunk:(s + 1) * chunk, :3].contiguous(),
                           real[s * chunk:(s + 1) * chunk])
        for s in range(splits)])
    out[qidx.long()] = _merge_plain(part)
    return out


def _push2_reference(values):
    """The merge kernel's update, one value at a time."""
    b1 = b2 = BIG
    for v in values:
        if v < b2:
            if v < b1:
                b1, b2 = v, b1
            else:
                b2 = v
    return b1, b2


# ---- the launch plan -----------------------------------------------------

PLAN_CASES = [(1, 1), (7, 5000), (1000, 513), (1024, 512), (13_107, 240_000),
              (400_000, 700_000), (1_081_344, 1_000_000), (2_000_000, 10), (1, 1_000_000)]


@pytest.mark.parametrize("sms,ctas_per_sm", [(132, 4), (132, 6), (8, 2)])
@pytest.mark.parametrize("n_valid,m_valid", PLAN_CASES)
def test_plan_splits_only_under_two_waves(n_valid, m_valid, sms, ctas_per_sm):
    splits = _plan(n_valid, m_valid, sms, ctas_per_sm)
    q_ctas = -(-n_valid // (_R * _THREADS))
    tiles = -(-m_valid // _TILE)
    assert (splits > 1) == (q_ctas < 2 * sms * ctas_per_sm and tiles > 1)
    chunk = _split_len(m_valid, splits)
    assert chunk % _TILE == 0 and splits * chunk >= m_valid
    assert (splits - 1) * chunk < m_valid          # the last split holds a valid target
    assert 1 <= splits <= tiles


def test_plan_random_sizes_never_leave_a_split_empty(rng):
    for n_valid, m_valid, sms, ctas in zip(rng.integers(1, 3_000_000, 200),
                                           rng.integers(1, 3_000_000, 200),
                                           rng.integers(1, 200, 200), rng.integers(1, 9, 200)):
        splits = _plan(int(n_valid), int(m_valid), int(sms), int(ctas))
        chunk = _split_len(int(m_valid), splits)
        assert (splits - 1) * chunk < m_valid <= splits * chunk


# ---- compaction and write-back --------------------------------------------

def test_compact_and_write_back(rng):
    q = rng.normal(size=(300, 3)).astype(np.float32)
    t = rng.normal(size=(500, 3)).astype(np.float32)
    qm, tm = rng.uniform(size=300) > 0.3, rng.uniform(size=500) > 0.6
    qt, qmt, tt, tmt = _t(q, qm, t, tm)
    m_pad = 512
    out = torch.full((300, 2), np.nan)
    qidx, t4 = _compact_plain(qmt, tt, tmt, m_pad, out)
    assert qidx.dtype == torch.int32
    np.testing.assert_array_equal(qidx.numpy(), np.flatnonzero(qm))
    assert t4.shape == (m_pad, 4)
    np.testing.assert_array_equal(t4[:tm.sum(), :3].numpy(), t[tm])
    assert np.all(np.isinf(t4[tm.sum():, :3].numpy())) and np.all(t4[:, 3].numpy() == 0)
    # the scan writes the valid rows through qidx; the compaction wrote the rest
    rows = torch.from_numpy(rng.uniform(size=(qm.sum(), 2)).astype(np.float32))
    out[qidx.long()] = rows
    assert np.all(out.numpy()[~qm] == BIG)
    np.testing.assert_array_equal(out.numpy()[qm], rows.numpy())


def test_compact_no_valid_query():
    out = torch.empty((5, 2))
    qidx, t4 = _compact_plain(torch.zeros(5, dtype=torch.bool), torch.ones(3, 3),
                              torch.ones(3, dtype=torch.bool), 4, out)
    assert qidx.shape == (0,) and t4.shape == (4, 4)
    assert np.all(out.numpy() == BIG)


# ---- the merge --------------------------------------------------------------

def test_merge_plain_is_the_kernels_update(rng):
    # values on a coarse grid, so ties within and across splits are common
    part = np.sort(rng.integers(0, 6, size=(5, 40, 2)).astype(np.float32), axis=2)
    part[1, ::3] = BIG                      # splits with fewer than two targets
    part[2, ::4, 1] = BIG
    got = _merge_plain(torch.from_numpy(part)).numpy()
    want = np.array([_push2_reference(part[:, i].reshape(-1)) for i in range(40)])
    np.testing.assert_array_equal(got, want)


# ---- the split route equals the whole call ----------------------------------

def _masked_case(rng, n=700, m=1500):
    q = rng.normal(size=(n, 3)).astype(np.float32) * 5
    t = rng.normal(size=(m, 3)).astype(np.float32) * 5
    qm = rng.uniform(size=n) > 0.1
    return q, qm, t, rng.uniform(size=m) > 0.2


@pytest.mark.parametrize("splits,tile", [(1, 512), (3, 512), (5, 64), (40, 8), (64, 32)])
def test_split_route_equals_whole_call(rng, splits, tile):
    q, qm, t, tm = _masked_case(rng)
    args = _t(q, qm, t, tm)
    whole = knn2_sqdists_plain(*args).numpy()
    got = _split_route(*args, splits, tile).numpy()
    np.testing.assert_array_equal(got, whole)
    # and the XLA 2-NN of ltm, to the one ulp the plain version keeps
    ref = np.asarray(jknn.knn_sqdists(*[jnp.asarray(a) for a in (q, qm, t, tm)], k=2, tile=256))
    assert np.all(np.abs(got[qm] - ref[qm]) <= np.spacing(np.maximum(got[qm], ref[qm])))
    assert np.all(got[~qm] == BIG)


def test_split_route_duplicates_across_a_boundary():
    # the nearest target is duplicated at compacted positions 3 and 4, the
    # two sides of a split boundary (9 valid targets, tile 4, three splits
    # of one tile each); both count
    t = np.full((10, 3), 50.0, np.float32)
    t[[3, 5]] = [1.0, 0.0, 0.0]
    tm = np.ones(10, bool)
    tm[4] = False                           # compaction moves row 5 to position 4
    q = np.zeros((3, 3), np.float32)
    got = _split_route(*_t(q, np.ones(3, bool), t, tm), 3, 4).numpy()
    np.testing.assert_array_equal(got, np.ones((3, 2), np.float32))
    np.testing.assert_array_equal(got, knn2_sqdists_plain(*_t(q, np.ones(3, bool), t, tm)).numpy())


def test_split_route_split_without_valid_target(rng):
    # 6 valid targets in chunks of 4 over 3 splits: the last split is padding only
    q, qm, t, _ = _masked_case(rng, 50, 40)
    tm = np.zeros(40, bool)
    tm[rng.choice(40, 6, replace=False)] = True
    args = _t(q, qm, t, tm)
    got = _split_route(*args, 3, 4).numpy()
    np.testing.assert_array_equal(got, knn2_sqdists_plain(*args).numpy())


@pytest.mark.parametrize("n_targets", [0, 1])
def test_split_route_pads_fewer_than_two_targets(rng, n_targets):
    q, qm, t, _ = _masked_case(rng, 60, 30)
    tm = np.zeros(30, bool)
    tm[:n_targets] = True
    args = _t(q, qm, t, tm)
    got = _split_route(*args, 2, 8).numpy()
    np.testing.assert_array_equal(got, knn2_sqdists_plain(*args).numpy())
    assert np.all(got[:, 1] == BIG)
    assert np.all((got[qm, 0] < BIG) == bool(n_targets))
