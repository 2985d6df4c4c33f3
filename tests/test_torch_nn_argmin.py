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
    for every split count;
  * the kernel's cull (``nn_argmin.prunable``, its plain mirror) never
    skips a tile that holds a valid target whose plain selection value is
    at or below the query's best: random clouds, near-ties, duplicate
    points, invalid targets, km-offset coordinates;
  * the kernel's visit (each warp's tiles nearest first, the cull, the
    lexicographic ``(value, index)`` update) modelled on the plain
    selection values, in that order and in random orders, gives the
    index-order selection's picks;
  * the kernel's fused centring (the lane box from its tiles' boxes) and
    re-score, written out in float32 with the sum order of the device it
    models, give ``_nn_centred``'s and ``_nn_rescore``'s bits on the CPU.

The kernel itself needs the card: ``tests/test_torch_card.py`` (marked
``card``) and ``chip_smoke.py`` hold it to the plain version there.
"""

import jax
import numpy as np
import pytest
import torch

from ltm.kernels.knn import nn_sqdist_argmin as j_nn
from ltm_torch.kernels import nn_argmin
from ltm_torch.kernels.knn import (_bbox_mid, _nn_centred, _nn_rescore, nn_sqdist_argmin,
                                   nn_sqdist_argmin_plain)
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
        nn_argmin.nn_argmin_select(*args)


# ---- the launch plan and the split route ------------------------------------------

PLAN_CASES = [(1, 1, 1), (32, 4096, 32768), (32, 4096, 8192), (8, 4096, 32768),
              (1, 4096, 32768), (1, 2000, 5000), (300, 4096, 32768), (64, 100_000, 10),
              (300, 4096, 200_000)]


@pytest.mark.parametrize("sms", [132, 114, 8])
@pytest.mark.parametrize("lanes,n,m", PLAN_CASES)
def test_plan_splits_only_under_two_waves(lanes, n, m, sms):
    splits = nn_argmin._plan(lanes, n, m, sms)
    q_ctas = lanes * -(-n // (nn_argmin._R * nn_argmin._THREADS))
    tiles = -(-m // nn_argmin._TILE)
    # two waves of half the SMs: below one query CTA an SM
    assert (splits > 1) == ((q_ctas < sms and tiles > 1) or tiles > nn_argmin._MAX_TILES)
    chunk = _split_len(m, splits, nn_argmin._TILE)
    assert chunk % nn_argmin._TILE == 0 and splits * chunk >= m
    assert chunk // nn_argmin._TILE <= nn_argmin._MAX_TILES   # a split's boxes fit the CTA
    assert (splits - 1) * chunk < m                # no split is padding only
    assert 1 <= splits <= tiles


@pytest.mark.parametrize("sms", [132, 114, 200])
def test_plan_farm_largest_call_fills_the_card(sms):
    # 32 lanes x 4 096 queries: a query CTA for every SM and more, so the
    # targets stay whole; 2 lanes would split them
    splits = nn_argmin._plan(32, 4096, 32768, sms)
    q_ctas = 32 * 4096 // (nn_argmin._R * nn_argmin._THREADS)
    assert q_ctas >= sms and splits == 1
    few = nn_argmin._plan(2, 4096, 32768, sms)
    assert few > 1 and 2 * 8 * few >= sms


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


# ---- the kernel's cull, visit order and fused centring, modelled ---------------------

TILE = nn_argmin._TILE


def _tile_boxes(t, tm):
    """The pack pass's boxes: (lanes, tiles, 2, 3) lo and hi of each tile's
    valid targets (+inf, -inf for a tile without one), tiles of ``TILE``."""
    lanes, m = tm.shape
    tiles = -(-m // TILE)
    pad = tiles * TILE - m
    tt = torch.cat([t, torch.zeros(lanes, pad, 3)], 1).reshape(lanes, tiles, TILE, 3)
    ok = torch.cat([tm, torch.zeros(lanes, pad, dtype=torch.bool)], 1).reshape(lanes, tiles, TILE)
    lo = torch.where(ok[..., None], tt, torch.inf).amin(-2)
    hi = torch.where(ok[..., None], tt, -torch.inf).amax(-2)
    return torch.stack([lo, hi], -2)


def _centred_box(box, mid):
    """A tile's box centred as the kernel centres it (each corner rounded;
    every side +inf for a tile without a valid target)."""
    if not bool(torch.isfinite(box[0]).all()):
        return torch.full((3,), torch.inf), torch.full((3,), torch.inf)
    return box[0] - mid, box[1] - mid


def _cull_cases():
    rng = np.random.default_rng(11)
    q, qm, t, tm = _cloud(rng, 2, 400, 3000)
    yield "random", q, qm, t, tm
    q, qm, t, tm = _cloud(rng, 2, 400, 3000, offset=2500.0, extent=60.0)
    yield "km_offset", q, qm, t, tm
    q, qm, t, tm = _cloud(rng, 1, 300, 2048)
    t[:, 1::2] = t[:, 0::2]                       # duplicate points
    q[:, :150] = t[:, rng.integers(0, 2048, 150)]   # queries on targets: clamped zeros
    yield "duplicates", q, qm, t, tm
    q, qm, t, tm = _cloud(rng, 1, 300, 2048)
    t[:, 512:768] = t[:, 256:512] + np.float32(1e-4)   # near-ties a tile apart
    tm[:, 1024:1536] = False                      # whole tiles of invalid targets
    yield "near_ties_invalid", q, qm, t, tm


@pytest.mark.parametrize("case", ["random", "km_offset", "duplicates", "near_ties_invalid"])
def test_cull_mirror_never_skips_a_tile_at_the_best(case):
    """For each query and tile, three bests: the least plain selection
    value among the tile's valid targets (the tile holds a target at the
    best: it must not be skipped), the query's final best, and 4× it;
    wherever the mirror skips, every valid target of the tile lies strictly
    above the best.  A tile of invalid targets alone is always skipped,
    which cannot change a pick: ``(1e30, j)`` never precedes ``(1e30, 0)``."""
    q, qm, t, tm = next(c[1:] for c in _cull_cases() if c[0] == case)
    args = _t(q, qm, t, tm)
    q_c, _, _, _ = _nn_centred(args[0], args[2], args[3])
    mid = _bbox_mid(args[2], args[3])
    sel = _selection(*args)                                     # (lanes, n, m)
    sel = torch.where(args[3][:, None, :], sel, torch.inf)      # valid targets only
    boxes = _tile_boxes(args[2], args[3])
    final = sel.min(-1).values
    skipped = held = 0
    for b in range(q.shape[0]):
        for k in range(boxes.shape[1]):
            lo, hi = _centred_box(boxes[b, k], mid[b])
            in_tile = sel[b, :, k * TILE:(k + 1) * TILE].min(-1).values
            if not bool(torch.isfinite(lo).all()):
                assert bool(nn_argmin.prunable(q_c[b], lo, hi, torch.full_like(final[b], 1e30)).all())
                continue
            assert not bool(nn_argmin.prunable(q_c[b], lo, hi, in_tile).any())
            for best in (final[b], 4 * final[b]):
                cut = nn_argmin.prunable(q_c[b], lo, hi, best)
                assert bool((in_tile[cut] > best[cut]).all())
                skipped += int(cut.sum())
                held += int((~cut).sum())
    assert skipped > 0 and held > 0


def _kernel_visit(sel, q_c, boxes_c, order_of, group=128):
    """The kernel's selection modelled on the values ``sel`` (lanes, n, m,
    clamped; +inf past a tile's end): per group of ``group`` queries, the
    tiles in ``order_of(group's queries, lane)`` order, a tile skipped when
    the mirror proves it for every query of the group, inside a tile the
    targets in index order, the least (value, index) kept from (1e30, 0)."""
    lanes, n, m = sel.shape
    best_d = torch.full((lanes, n), BIG)
    best_i = torch.zeros((lanes, n), dtype=torch.int64)
    for b in range(lanes):
        for g0 in range(0, n, group):
            rows = slice(g0, min(n, g0 + group))
            bd, bi = best_d[b, rows], best_i[b, rows]
            for k in order_of(q_c[b, rows], b):
                lo, hi = boxes_c[b][k]
                if bool(nn_argmin.prunable(q_c[b, rows], lo, hi, bd).all()):
                    continue
                for j in range(k * TILE, min(m, (k + 1) * TILE)):
                    d = sel[b, rows, j]
                    take = (d <= bd) & ((d < bd) | (j < bi))
                    bd, bi = torch.where(take, d, bd), torch.where(take, j, bi)
            best_d[b, rows], best_i[b, rows] = bd, bi
    return best_d, best_i


@pytest.mark.parametrize("order", ["nearest_first", "random", "reversed"])
def test_kernel_visit_gives_index_order_picks(order):
    """Nearest tile first (the box-to-box gap, the index on ties), a random
    order and the reverse, each with the cull, give the index-order
    selection's picks and values (duplicates and clamped zeros included:
    the lowest index wins)."""
    rng = np.random.default_rng(12)
    q, qm, t, tm = _cloud(rng, 2, 200, 1500)
    t[:, 700:760] = t[:, 100:160]                 # duplicates in another tile
    q[:, :40] = t[:, 100:140]                     # queries on them: clamped zeros
    tm[1, 256:512] = False                        # a tile of invalid targets
    args = _t(q, qm, t, tm)
    q_c = _nn_centred(args[0], args[2], args[3])[0]
    mid = _bbox_mid(args[2], args[3])
    sel = _selection(*args)
    boxes = _tile_boxes(args[2], args[3])
    boxes_c = [[_centred_box(boxes[b, k], mid[b]) for k in range(boxes.shape[1])]
               for b in range(2)]
    tiles = boxes.shape[1]
    perm = np.random.default_rng(3).permutation(tiles)

    def order_of(qc, b):
        if order == "random":
            return perm
        if order == "reversed":
            return range(tiles - 1, -1, -1)
        qlo, qhi = qc.amin(0), qc.amax(0)
        keys = []
        for k in range(tiles):
            lo, hi = boxes_c[b][k]
            g = torch.clamp(torch.maximum(lo - qhi, qlo - hi), min=0.0)
            keys.append((float((g * g).sum()), k))
        return [k for _, k in sorted(keys)]

    got_d, got_i = _kernel_visit(sel, q_c, boxes_c, order_of)
    want_d, want_i = _first_min(sel)
    assert torch.equal(got_i, want_i) and torch.equal(got_d, want_d)
    assert int((sel[0, :40] == 0).sum(-1).max()) >= 2     # clamped zeros tie


def _sumsq(x, order):
    """A sum of three float32 squares in ``order``: "012" ((x² + y²) + z²,
    torch's CPU reduction) or "021" ((x² + z²) + y², torch's CUDA reduction
    over a last axis of three, the kernel's)."""
    s = x * x
    a, b, c = (s[..., int(i)] for i in order)
    return (a + b) + c


def _fused_model(q, qm, t, tm, pick, order):
    """The kernel's centring (the lane box from the tiles' boxes, its
    midpoint as torch forms it) and re-score of ``pick``, float32 op by op."""
    boxes = _tile_boxes(t, tm)
    lo, hi = boxes[..., 0, :].amin(1), boxes[..., 1, :].amax(1)
    mid = torch.where(torch.isfinite(lo), torch.tensor(0.5, dtype=torch.float32) * (lo + hi), 0.0)
    q_c, t_c = q - mid[:, None], t - mid[:, None]
    q2 = _sumsq(q_c, order)
    t2 = torch.where(tm, _sumsq(t_c, order), BIG)
    sel = torch.gather(t, 1, torch.clamp(pick, max=t.shape[1] - 1)[..., None].expand(q.shape))
    return q_c, q2, t_c, t2, _sumsq(q - sel, order)


@pytest.mark.parametrize("offset", [0.0, 1500.0])
def test_fused_centring_and_rescore_model_matches_torch_ops(offset):
    """On the CPU, with the CPU's sum order: the centred points, both
    squared norms and the re-score of the plain pick, bit for bit; lanes
    without a valid target (mid 0) included.  On the card the kernel sums
    in torch's CUDA order (x² + z²) + y² (probed on the card), and the
    card's comparison holds its distances to the plain version's bits."""
    rng = np.random.default_rng(13)
    q, qm, t, tm = _cloud(rng, 3, 700, 1300, offset=offset)
    tm[2] = False
    args = _t(q, qm, t, tm)
    want = _nn_centred(args[0], args[2], args[3])
    _, pick = nn_sqdist_argmin_plain(*args, tile=512)
    *got, rescored = _fused_model(*args, pick, "012")
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    d_plain, _ = _nn_rescore(args[0], args[1], args[2], torch.zeros_like(rescored), pick)
    assert torch.equal(torch.where(args[1], rescored, BIG), d_plain)
    # the two orders differ somewhere: the kernel's is not the CPU's
    assert not torch.equal(_sumsq(args[0], "012"), _sumsq(args[0], "021"))


def _key(d, i):
    return (float(d), int(i))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_ctas_sharing_picks_give_index_order_picks(seed):
    """The kernel's target splits on one query block: each split a CTA over
    its chunk of tiles, nearest first, that adopts the shared pick of a
    query where it is less than its own (then tests the cull again) before
    scoring a tile and publishes its picks (``atomicMin`` on the
    (value, index) key) after it; the CTAs' tiles interleaved in a random
    order.  The final shared picks are the index-order selection's, for
    every interleaving."""
    rng = np.random.default_rng(20 + seed)
    q, qm, t, tm = _cloud(rng, 1, 128, 2600)
    t[:, 1800:1900] = t[:, 300:400]               # duplicates in another split
    q[:, :30] = t[:, 300:330]
    args = _t(q, qm, t, tm)
    q_c = _nn_centred(args[0], args[2], args[3])[0][0]
    mid = _bbox_mid(args[2], args[3])[0]
    sel = _selection(*args)[0]                    # (n, m)
    boxes = _tile_boxes(args[2], args[3])[0]
    tiles = boxes.shape[0]
    boxes_c = [_centred_box(boxes[k], mid) for k in range(tiles)]
    splits = 4
    chunk = -(-tiles // splits)
    n = q.shape[1]
    shared = [(float(BIG), 0)] * n
    state = []
    for sp in range(splits):
        ks = list(range(sp * chunk, min(tiles, (sp + 1) * chunk)))
        qlo, qhi = q_c.amin(0), q_c.amax(0)

        def gap(k):
            lo, hi = boxes_c[k]
            g = torch.clamp(torch.maximum(lo - qhi, qlo - hi), min=0.0)
            return (float((g * g).sum()), k)
        state.append({"order": [k for _, k in sorted(map(gap, ks))],
                      "bd": torch.full((n,), BIG), "bi": torch.zeros(n, dtype=torch.int64)})
    steps = [sp for sp in range(splits) for _ in state[sp]["order"]]
    rng.shuffle(steps)
    for sp in steps:
        st = state[sp]
        k = st["order"].pop(0)
        lo, hi = boxes_c[k]
        if bool(nn_argmin.prunable(q_c, lo, hi, st["bd"]).all()):
            continue
        for r in range(n):                        # adopt the shared pick where it is less
            if shared[r] < _key(st["bd"][r], st["bi"][r]):
                st["bd"][r], st["bi"][r] = shared[r]
        if bool(nn_argmin.prunable(q_c, lo, hi, st["bd"]).all()):
            continue
        bd, bi = st["bd"], st["bi"]
        for j in range(k * TILE, min(t.shape[1], (k + 1) * TILE)):
            d = sel[:, j]
            take = (d <= bd) & ((d < bd) | (j < bi))
            bd, bi = torch.where(take, d, bd), torch.where(take, j, bi)
        st["bd"], st["bi"] = bd, bi
        shared = [min(shared[r], _key(bd[r], bi[r])) for r in range(n)]
    want_d, want_i = _first_min(sel[None])
    assert [i for _, i in shared] == want_i[0].tolist()
    assert torch.equal(torch.tensor([d for d, _ in shared], dtype=torch.float32), want_d[0])
