"""The ICP 1-NN (K5b) on the CPU: its plain version against ``ltm``, and the
kernel's launch plan and split/merge rule.

  * ``nn_sqdist_argmin_plain`` against ``ltm``'s ``nn_sqdist_argmin`` under
    ``jit``, a lane at a time: indices equal except at counted near-ties
    (both picks within 1e-5 m² of each other, as ``tests/test_torch_icp.py``
    allows), distances within 1e-6 relative where the indices agree (the
    re-score's sum of squares is XLA's on one side); several seeds, lane
    counts and tiles, a km offset, duplicated targets (the lowest index
    wins), a lane without a valid target (index 0, 1e30), invalid queries;
  * its result does not depend on ``tile``, bit for bit, and a lane's does
    not depend on its batch;
  * ``nn_sqdist_argmin`` takes the plain version on CPU tensors;
  * the kernel's launch plan (``nn_argmin._plan``) and its split route: the
    selection cut into the plan's target chunks and folded by the merge
    kernel's rule (splits in order, a later one taken only when strictly
    smaller) equals the selection over all targets, indices and distances,
    for every split count.

The kernel itself needs the card: ``tests/test_torch_card.py`` (marked
``card``) and ``chip_smoke.py`` hold it to the plain version there.
"""

import jax
import numpy as np
import pytest
import torch

from ltm.kernels.knn import nn_sqdist_argmin as j_nn
from ltm_torch.kernels import nn_argmin
from ltm_torch.kernels.knn import _nn_centred, nn_sqdist_argmin, nn_sqdist_argmin_plain
from ltm_torch.kernels.knn2 import _split_len

torch.set_num_threads(1)

BIG = np.float32(1e30)
NEAR_TIE = 1e-5


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _cloud(rng, lanes, n, m, offset=0.0, extent=20.0):
    """Targets in a box, queries near some of them, both masked."""
    t = (rng.uniform(-extent, extent, (lanes, m, 3)) + offset).astype(np.float32)
    q = (t[:, rng.integers(0, m, n)] + rng.normal(scale=0.05, size=(lanes, n, 3))).astype(np.float32)
    return q, rng.uniform(size=(lanes, n)) > 0.1, t, rng.uniform(size=(lanes, m)) > 0.2


_j_nn = jax.jit(j_nn, static_argnames=("tile",))


def _ltm_lanes(q, qm, t, tm, tile):
    """``ltm``'s 1-NN under ``jit``, a lane at a time."""
    out = [_j_nn(q[b], qm[b], t[b], tm[b], tile=tile) for b in range(q.shape[0])]
    return (np.stack([np.asarray(o[0]) for o in out]), np.stack([np.asarray(o[1]) for o in out]))


def _near_ties(q, t, tm, i, i_ref):
    """Lanes/rows where the picks differ; each must be a valid target within
    NEAR_TIE of the other pick (exact distances in float64)."""
    lane, row = np.nonzero(i != i_ref)
    e = ((q[lane, row].astype(np.float64) - t[lane, i[lane, row]]) ** 2).sum(-1)
    e_ref = ((q[lane, row].astype(np.float64) - t[lane, i_ref[lane, row]]) ** 2).sum(-1)
    assert np.all(tm[lane, i[lane, row]])
    assert np.all(np.abs(e - e_ref) <= NEAR_TIE)
    return len(lane)


def _check_against_ltm(q, qm, t, tm, tile, max_ties=3):
    d, i = (x.numpy() for x in nn_sqdist_argmin_plain(*_t(q, qm, t, tm), tile=tile))
    d_ref, i_ref = _ltm_lanes(q, qm, t, tm, tile)
    ties = _near_ties(q, t, tm, i, i_ref)
    agree = i == i_ref
    np.testing.assert_allclose(d[agree], d_ref[agree], rtol=1e-6)
    assert np.all(d[~qm] == BIG) and np.all(d_ref[~qm] == BIG)
    assert ties <= max_ties
    return d, i, ties


@pytest.mark.parametrize("seed,lanes,tile", [(0, 1, 1024), (1, 3, 4096), (2, 2, 300),
                                             (3, 4, 8192)])
def test_plain_matches_ltm(seed, lanes, tile):
    rng = np.random.default_rng(seed)
    _check_against_ltm(*_cloud(rng, lanes, 900, 2500), tile)


@pytest.mark.parametrize("offset", [1000.0, -3000.0])
def test_plain_matches_ltm_km_offset(offset):
    """Centring on the target box keeps the matmul form's cancellation small
    a few km from the origin."""
    rng = np.random.default_rng(7)
    _check_against_ltm(*_cloud(rng, 2, 800, 2000, offset=offset), 512)


def test_duplicated_targets_lowest_index_wins():
    rng = np.random.default_rng(4)
    q, qm, t, tm = _cloud(rng, 2, 600, 1000)
    t[:, 1::2] = t[:, 0::2]
    tm[:] = True
    tm[:, 0] = False                 # the first copy of pair 0 is invalid: its second one wins
    _, i, _ = _check_against_ltm(q, qm, t, tm, 256)
    pair0 = (i // 2 == 0)
    assert np.all(i[pair0] == 1) and np.all(i[~pair0] % 2 == 0)


def test_lane_without_valid_target_and_invalid_queries():
    rng = np.random.default_rng(5)
    q, qm, t, tm = _cloud(rng, 3, 500, 800)
    tm[1] = False
    qm[2] = False
    d, i, _ = _check_against_ltm(q, qm, t, tm, 256)
    assert np.all(i[1] == 0) and np.all(d[1] == BIG)
    assert np.all(d[2] == BIG)
    # an invalid query's index is computed as for a valid one (ICP gathers it at weight 0)
    qm_all = np.ones_like(qm)
    _, i_all = nn_sqdist_argmin_plain(*_t(q, qm_all, t, tm), tile=256)
    np.testing.assert_array_equal(i[2], i_all.numpy()[2])


def test_result_independent_of_tile_and_batch():
    rng = np.random.default_rng(6)
    args = _t(*_cloud(rng, 3, 700, 3000))
    d0, i0 = nn_sqdist_argmin_plain(*args, tile=3000)
    for tile in (64, 1000, 4096):
        d, i = nn_sqdist_argmin_plain(*args, tile=tile)
        assert torch.equal(d, d0) and torch.equal(i, i0)
    for b in range(3):
        d, i = nn_sqdist_argmin_plain(*(x[b:b + 1] for x in args), tile=512)
        assert torch.equal(d[0], d0[b]) and torch.equal(i[0], i0[b])


def test_entry_point_takes_plain_on_cpu(monkeypatch):
    def refuse(*_):
        raise AssertionError("the kernel route ran on CPU tensors")

    monkeypatch.setattr("ltm_torch.kernels.knn.nn_argmin_select", refuse)
    rng = np.random.default_rng(8)
    args = _t(*_cloud(rng, 2, 300, 500))
    got = nn_sqdist_argmin(*args, tile=128)
    want = nn_sqdist_argmin_plain(*args, tile=128)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(RuntimeError, match="CUDA"):
        nn_argmin.nn_argmin_select(*_nn_centred(args[0], args[2], args[3]))


# ---- the launch plan and the split route ------------------------------------------

PLAN_CASES = [(1, 1, 1), (32, 4096, 32768), (32, 4096, 8192), (8, 4096, 32768),
              (1, 4096, 32768), (1, 2000, 5000), (300, 4096, 32768), (64, 100_000, 10)]


@pytest.mark.parametrize("sms,ctas_per_sm", [(132, 4), (132, 5), (8, 2)])
@pytest.mark.parametrize("lanes,n,m", PLAN_CASES)
def test_plan_splits_only_under_two_waves(lanes, n, m, sms, ctas_per_sm):
    splits = nn_argmin._plan(lanes, n, m, sms, ctas_per_sm)
    q_ctas = lanes * -(-n // (nn_argmin._R * nn_argmin._THREADS))
    tiles = -(-m // nn_argmin._TILE)
    assert (splits > 1) == (q_ctas < 2 * sms * ctas_per_sm and tiles > 1)
    chunk = _split_len(m, splits, nn_argmin._TILE)
    assert chunk % nn_argmin._TILE == 0 and splits * chunk >= m
    assert (splits - 1) * chunk < m                # no split is padding only
    assert 1 <= splits <= tiles


@pytest.mark.parametrize("ctas_per_sm", [4, 8, 12])
def test_plan_farm_largest_call_fills_the_card(ctas_per_sm):
    # 32 lanes x 4 096 queries: fewer CTAs than two waves of 132 SMs
    splits = nn_argmin._plan(32, 4096, 32768, 132, ctas_per_sm)
    q_ctas = 32 * 4096 // (nn_argmin._R * nn_argmin._THREADS)
    assert q_ctas < 2 * 132 * ctas_per_sm
    assert splits > 1 and q_ctas * splits >= 132 * ctas_per_sm


def _selection(q, qm, t, tm):
    """The (lanes, n, m) clamped distances the selection ranks: the plain
    version's own centring and matmul form over all targets at once."""
    q_c, q2, t_c, t2 = _nn_centred(q, t, tm)
    d2 = torch.baddbmm(q2[..., None] + t2[..., None, :], q_c, t_c.transpose(-1, -2),
                       alpha=-2.0).clamp_(min=0.0)
    return d2


def _first_min(d2):
    d, i = torch.min(d2, -1)
    none = ~(d < BIG)
    return torch.where(none, torch.tensor(BIG), d), torch.where(none, 0, i)


def _merge_rule(part_d, part_i):
    """The merge kernel on (splits, ...) partials: the splits in order from
    (1e30, 0), a later one taken only when strictly smaller."""
    best_d = torch.full(part_d.shape[1:], BIG)
    best_i = torch.zeros(part_i.shape[1:], dtype=part_i.dtype)
    for d, i in zip(part_d, part_i):
        take = d < best_d
        best_d, best_i = torch.where(take, d, best_d), torch.where(take, i, best_i)
    return best_d, best_i


def _split_route(d2, splits, tile):
    """The kernel's target splits on a distance matrix: each split's first
    minimum over its chunk (padding past m has +inf distances), then the
    merge."""
    m = d2.shape[-1]
    chunk = _split_len(m, splits, tile)
    pad = torch.full(d2.shape[:-1] + (splits * chunk - m,), torch.inf)
    full = torch.cat([d2, pad], -1)
    parts = [_first_min(full[..., s * chunk:(s + 1) * chunk]) for s in range(splits)]
    part_d = torch.stack([p[0] for p in parts])
    part_i = torch.stack([p[1] + s * chunk * (p[0] < BIG) for s, p in enumerate(parts)])
    return _merge_rule(part_d, part_i)


@pytest.mark.parametrize("splits,tile", [(1, 512), (2, 512), (5, 64), (13, 32), (40, 8)])
def test_split_route_equals_whole_selection(splits, tile):
    rng = np.random.default_rng(9)
    q, qm, t, tm = _cloud(rng, 3, 400, 1100)
    tm[1, :700] = False                      # a lane whose early splits hold no valid target
    tm[2] = False                            # a lane with none
    args = _t(q, qm, t, tm)
    d2 = _selection(*args)
    whole = _first_min(d2)
    got = _split_route(d2, splits, tile)
    assert torch.equal(got[0], whole[0]) and torch.equal(got[1], whole[1])
    # the whole selection is the plain version's pick, wherever it found one
    _, i_plain = nn_sqdist_argmin_plain(*args, tile=tile * 7)
    assert torch.equal(whole[1], i_plain)
    assert torch.all(whole[1][2] == 0) and torch.all(whole[0][2] == BIG)


def test_split_route_ties_across_a_boundary():
    # the nearest target twice, at the last entry of one split and the first
    # of the next; and a clamped 0 in several splits: the lowest index wins
    q = np.zeros((1, 4, 3), np.float32)
    q[0, 1] = [5.0, 5.0, 5.0]
    t = np.full((1, 40, 3), 30.0, np.float32)
    t[0, [7, 8]] = [1.0, 0.0, 0.0]
    t[0, [13, 22, 31]] = q[0, 1]
    args = _t(q, np.ones((1, 4), bool), t, np.ones((1, 40), bool))
    d2 = _selection(*args)
    for splits in (1, 2, 3, 5):
        d, i = _split_route(d2, splits, 8)
        assert int(i[0, 0]) == 7 and int(i[0, 1]) == 13
    _, i_plain = nn_sqdist_argmin_plain(*args, tile=8)
    assert int(i_plain[0, 0]) == 7 and int(i_plain[0, 1]) == 13


def test_merge_rule_takes_strictly_smaller(rng):
    # values on a coarse grid: ties across splits are common
    part_d = torch.from_numpy(rng.integers(0, 4, size=(6, 50)).astype(np.float32))
    part_d[2, ::3] = float(BIG)
    part_i = torch.arange(6)[:, None] * 100 + torch.from_numpy(rng.integers(0, 100, (6, 50)))
    d, i = _merge_rule(part_d, part_i)
    want = part_d.min(0)
    assert torch.equal(d, want.values)
    first = torch.argmax((part_d == want.values).int(), 0)     # the first split at the minimum
    assert torch.equal(i, part_i[first, torch.arange(50)])
