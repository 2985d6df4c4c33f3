"""The port's chunked block 2-NN (the plain version of the CUDA scan, the
path CPU tensors take) vs ``ltm``'s jitted ``chunk_knn_sqdists``, on the
cases of tests/test_chunk_knn.py plus an all-invalid query set.

Both packages get the same seeded NumPy inputs and the same block layout
(built by ``ltm``).  ``chunk_overflow`` and ``order`` must be identical, and
every row of a chunk that did not overflow must hold the same bits.  The
rows of an overflowed chunk differ by design: ``ltm`` scores the nearest
``k_blocks`` blocks, the port writes NaN for the caller to re-resolve.
The CUDA scan itself needs the card: ``chip_smoke.py`` holds it against
the plain version there, bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltm.kernels.blocks import build_block_map
from ltm.kernels.chunk_knn import chunk_knn_sqdists as j_chunk_knn
from ltm_torch.kernels.blocks import BlockMap
from ltm_torch.kernels.chunk_knn import _SEG, chunk_knn_avg_sqdist, chunk_knn_sqdists

torch.set_num_threads(1)


def _bm(pts, mask, cell, n_blocks, cap):
    bm, overflow = build_block_map(jnp.asarray(pts), jnp.asarray(mask), cell, n_blocks, cap)
    assert int(overflow) == 0
    return bm


def _port_bm(bm):
    return BlockMap(*(torch.from_numpy(np.array(getattr(bm, f))) for f in BlockMap._fields))


def _case(name, rng):
    """(q, qm, ltm BlockMap, extra or None, kwargs) of a named case."""
    if name == "masked":
        t = rng.uniform(-30, 30, size=(5000, 3)).astype(np.float32)
        q = rng.uniform(-32, 32, size=(1777, 3)).astype(np.float32)
        qm = np.ones(1777, bool)
        qm[[7, 500, 1776]] = False
        return q, qm, _bm(t, rng.uniform(size=5000) > 0.2, 8.0, 2048, 64), None, \
            dict(clamp_radius=2.0, chunk=256, k_blocks=2048, sort_cell=8.0)
    if name == "thresholds":
        t = rng.uniform(-10, 10, size=(3000, 3)).astype(np.float32)
        q = t + rng.normal(scale=0.4, size=t.shape).astype(np.float32)
        return q, np.ones(len(q), bool), _bm(t, np.ones(len(t), bool), 5.0, 512, 64), None, \
            dict(clamp_radius=1.5, chunk=128, k_blocks=512, sort_cell=5.0)
    if name == "target_extra":
        t = rng.uniform(-20, 20, size=(4000, 3)).astype(np.float32)
        bm = _bm(t, np.ones(len(t), bool), 8.0, 2048, 64)
        extra = rng.uniform(size=bm.num_blocks * bm.block_capacity) > 0.5
        q = rng.uniform(-20, 20, size=(900, 3)).astype(np.float32)
        return q, np.ones(900, bool), bm, extra, \
            dict(clamp_radius=2.0, chunk=128, k_blocks=2048, sort_cell=8.0)
    if name == "overflow":
        t = rng.uniform(-40, 40, size=(8000, 3)).astype(np.float32)
        q = rng.uniform(-40, 40, size=(512, 3)).astype(np.float32)
        return q, np.ones(512, bool), _bm(t, np.ones(len(t), bool), 4.0, 16384, 16), None, \
            dict(clamp_radius=2.0, chunk=512, k_blocks=4, sort_cell=1000.0)
    if name == "km_offset":
        off = np.array([2000.0, 500.0, 0.0], np.float32)
        t = rng.uniform(-12, 12, size=(3000, 3)).astype(np.float32) + off
        q = t[:1500] + rng.normal(scale=0.25, size=(1500, 3)).astype(np.float32)
        return q, np.ones(1500, bool), _bm(t, np.ones(3000, bool), 6.0, 1024, 64), None, \
            dict(clamp_radius=2.0, chunk=128, k_blocks=512, sort_cell=6.0)
    if name == "no_valid_query":
        t = rng.uniform(-10, 10, size=(2000, 3)).astype(np.float32)
        q = rng.uniform(-10, 10, size=(700, 3)).astype(np.float32)
        return q, np.zeros(700, bool), _bm(t, np.ones(2000, bool), 5.0, 512, 64), None, \
            dict(clamp_radius=1.5, chunk=128, k_blocks=64, sort_cell=5.0)
    if name == "long_list":
        # dense small blocks, one sort cell: every chunk lists hundreds of
        # blocks, many work items of the kernel route each
        t = rng.uniform(-5, 5, size=(12000, 3)).astype(np.float32)
        q = rng.uniform(-5, 5, size=(300, 3)).astype(np.float32)
        return q, np.ones(300, bool), _bm(t, np.ones(12000, bool), 2.0, 2048, 16), None, \
            dict(clamp_radius=2.0, chunk=128, k_blocks=2048, sort_cell=20.0)
    if name == "odd_capacity":
        # 100 slots a block, which the card's route takes too
        t = rng.uniform(-20, 20, size=(4000, 3)).astype(np.float32)
        bm = _bm(t, rng.uniform(size=4000) > 0.1, 6.0, 256, 100)
        extra = rng.uniform(size=bm.num_blocks * bm.block_capacity) > 0.3
        q = rng.uniform(-21, 21, size=(800, 3)).astype(np.float32)
        return q, rng.uniform(size=800) > 0.1, bm, extra, \
            dict(clamp_radius=2.0, chunk=128, k_blocks=256, sort_cell=6.0)
    raise KeyError(name)


CASES = ["masked", "thresholds", "target_extra", "overflow", "km_offset", "no_valid_query",
         "long_list", "odd_capacity"]


@pytest.mark.parametrize("name", CASES)
def test_plain_matches_ltm(rng, name):
    q, qm, bm, extra, kw = _case(name, rng)
    ref = j_chunk_knn(jnp.asarray(q), jnp.asarray(qm), bm,
                      None if extra is None else jnp.asarray(extra), **kw)
    got = chunk_knn_sqdists(torch.from_numpy(q), torch.from_numpy(qm), _port_bm(bm),
                            None if extra is None else torch.from_numpy(extra), **kw)
    over, order = np.asarray(ref.chunk_overflow), np.asarray(ref.order)
    np.testing.assert_array_equal(got.chunk_overflow.numpy(), over)
    np.testing.assert_array_equal(got.order.numpy(), order)
    assert got.order.dtype == torch.int32 and got.chunk_overflow.dtype == torch.int32
    chunk = kw["chunk"]
    ok_pos = np.flatnonzero(np.repeat(over == 0, chunk)[:len(q)])
    rows = order[ok_pos]
    np.testing.assert_array_equal(got.sqdists.numpy()[rows].view(np.int32),
                                  np.asarray(ref.sqdists)[rows].view(np.int32))
    assert np.all(got.sqdists.numpy()[~qm] == np.float32(1e30))
    bad_rows = np.setdiff1d(order, rows)
    assert np.all(np.isnan(got.sqdists.numpy()[bad_rows][qm[bad_rows]]))
    if name == "overflow":
        assert (over > 0).sum() == 1 and len(bad_rows) > 0
    else:
        assert over.sum() == 0
    if name == "long_list":   # every chunk lists many segments' worth of blocks
        assert np.all(j_chunk_knn(jnp.asarray(q), jnp.asarray(qm), bm, None,
                                  **dict(kw, k_blocks=1)).chunk_overflow >= 20 * _SEG)


def test_avg_is_mean_of_sqdists(rng):
    q, qm, bm, _, kw = _case("masked", rng)
    args = (torch.from_numpy(q), torch.from_numpy(qm), _port_bm(bm), None)
    avg, total = chunk_knn_avg_sqdist(*args, **kw)
    np.testing.assert_array_equal(avg.numpy(), chunk_knn_sqdists(*args, **kw).sqdists.mean(-1).numpy())
    assert int(total) == 0


def test_duplicate_targets_count_twice():
    """A target duplicated in two slots is both nearest neighbours."""
    t = np.array([[1.0, 0, 0], [1.0, 0, 0], [5.0, 0, 0]] * 40, np.float32)
    bm = _bm(t, np.ones(len(t), bool), 8.0, 16, 64)
    q = np.zeros((8, 3), np.float32)
    got = chunk_knn_sqdists(torch.from_numpy(q), torch.ones(8, dtype=torch.bool), _port_bm(bm),
                            None, clamp_radius=3.0, chunk=8, k_blocks=16, sort_cell=4.0)
    np.testing.assert_array_equal(got.sqdists.numpy(), np.ones((8, 2), np.float32))
