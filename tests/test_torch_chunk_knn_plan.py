"""The chunk kNN kernels' own steps on the CPU, through their plain
versions: the super-block bounds and the two-level cull (exactly the blocks
of the one-level test, with the kernel's count of tests), the work-item
plan (every listed block of every chunk scored once), the packed top-2
merge (order-independent, duplicates and 1e30 kept), the wrapper's checks
of the block arrays (any capacity), and the whole kernel route rebuilt
from them, which must equal ``chunk_knn_sqdists_plain`` bit for bit.

The kernels themselves need the card: ``chip_smoke.py`` holds them against
``chunk_knn_sqdists_plain`` there at 0 ulps.
"""

import itertools

import numpy as np
import pytest
import torch

from ltm_torch.kernels.blocks import BlockMap, build_block_map_with_slots
from ltm_torch.kernels.chunk_knn import (
    _SEG,
    _SLAB,
    _block_bounds,
    _block_hits,
    _chunk_balls,
    _cull_two_level,
    _prep_sorted_chunks,
    _super_bounds,
    _target_arrays,
    _work_items,
    chunk_knn_sqdists_plain,
)
from ltm_torch.kernels.projection import sumsq3

torch.set_num_threads(1)

BIG = np.float32(1e30)


def _layout(pts, mask, cell, cap):
    t, tm = torch.from_numpy(pts), torch.from_numpy(mask)
    need = max(-(-int(mask.sum()) * 2 // cap), 1)
    bm, ov, _ = build_block_map_with_slots(t, tm, cell, 1 << (need - 1).bit_length(), cap)
    assert ov == 0
    return bm


def _scene(name, rng):
    """(q, qm, bm, extra, kwargs) of a named scene."""
    if name == "uniform":
        t = rng.uniform(-30, 30, (6000, 3)).astype(np.float32)
        q = rng.uniform(-32, 32, (1500, 3)).astype(np.float32)
        return q, rng.uniform(size=1500) > 0.1, _layout(t, rng.uniform(size=6000) > 0.2, 8.0, 32), \
            None, dict(clamp_radius=2.0, chunk=128, k_blocks=400, sort_cell=8.0)
    if name == "clusters":
        c = rng.uniform(-100, 100, (6, 3))
        t = (c[rng.integers(0, 6, 5000)] + rng.normal(0, 3, (5000, 3))).astype(np.float32)
        q = (c[rng.integers(0, 6, 900)] + rng.normal(0, 4, (900, 3))).astype(np.float32)
        bm = _layout(t, np.ones(5000, bool), 6.0, 16)
        extra = rng.uniform(size=bm.mask.numel()) > 0.4
        return q, np.ones(900, bool), bm, torch.from_numpy(extra), \
            dict(clamp_radius=1.5, chunk=64, k_blocks=120, sort_cell=4.0)
    if name == "km_offset":
        t = (rng.uniform(-12, 12, (4000, 3)) + [2000.0, 500.0, 0.0]).astype(np.float32)
        q = (t[:1200] + rng.normal(0, 0.25, (1200, 3))).astype(np.float32)
        return q, rng.uniform(size=1200) > 0.2, _layout(t, np.ones(4000, bool), 6.0, 32), None, \
            dict(clamp_radius=2.0, chunk=300, k_blocks=64, sort_cell=6.0)
    if name == "odd_capacity":
        # 201 slots a block: two pieces of the scoring's staging, the second
        # of 73 slots, each block at another alignment
        t = rng.uniform(-20, 20, (6000, 3)).astype(np.float32)
        q = rng.uniform(-21, 21, (700, 3)).astype(np.float32)
        bm = _layout(t, rng.uniform(size=6000) > 0.1, 5.0, 201)
        extra = rng.uniform(size=bm.mask.numel()) > 0.3
        return q, rng.uniform(size=700) > 0.1, bm, torch.from_numpy(extra), \
            dict(clamp_radius=2.0, chunk=128, k_blocks=40, sort_cell=5.0)
    raise KeyError(name)


def _balls(q, qm, bm, extra, kw):
    _, bval, blo, bhi = _block_bounds(bm, extra)
    qx, qmc, _ = _prep_sorted_chunks(torch.from_numpy(q), torch.from_numpy(qm), kw["chunk"],
                                     kw["sort_cell"])
    cnt, center, reach = _chunk_balls(qx, qmc, kw["clamp_radius"])
    return cnt, center, reach, bval, blo, bhi


# ---- the super-block bounds and the two-level cull ------------------------------

@pytest.mark.parametrize("group", [1, 4, 32, 33])
@pytest.mark.parametrize("name", ["uniform", "clusters", "km_offset"])
def test_two_level_cull_lists_the_one_level_blocks(rng, name, group):
    q, qm, bm, extra, kw = _scene(name, rng)
    cnt, center, reach, bval, blo, bhi = _balls(q, qm, bm, extra, kw)
    hit, tests = _cull_two_level(center, reach, bval, blo, bhi, group)
    torch.testing.assert_close(hit, _block_hits(center, reach, bval, blo, bhi), rtol=0, atol=0)
    n_super = -(-bm.num_blocks // group)
    assert torch.all(tests >= n_super) and torch.all(tests <= n_super + group * n_super)
    if group == 32:   # the kernel's size: the cull skips most blocks
        active = cnt > 0
        assert float(tests[active].double().mean()) < 0.6 * bm.num_blocks


def test_super_bounds_contain_their_blocks(rng):
    q, qm, bm, extra, kw = _scene("clusters", rng)
    _, bval, blo, bhi = _block_bounds(bm, extra)
    sval, slo, shi = _super_bounds(bval, blo, bhi, 32)
    owner = torch.arange(bm.num_blocks) // 32
    assert torch.equal(sval, torch.zeros_like(sval).index_put_((owner,), bval, accumulate=True))
    v = bval
    assert torch.all(slo[owner[v]] <= blo[v]) and torch.all(shi[owner[v]] >= bhi[v])
    # each bound is attained by one of its blocks
    for s in torch.nonzero(sval).squeeze(1).tolist()[:20]:
        m = v & (owner == s)
        assert torch.equal(slo[s], blo[m].amin(0)) and torch.equal(shi[s], bhi[m].amax(0))


def _boxes(n, far=1000.0):
    """n valid unit boxes far from the origin."""
    lo = torch.full((n, 3), far)
    return torch.ones(n, dtype=torch.bool), lo, lo + 1.0


def test_cull_block_exactly_at_reach_inside_a_super_block():
    bval, blo, bhi = _boxes(64)
    blo[37] = torch.tensor([2.0, -1.0, -1.0])          # gap exactly 2 = reach
    bhi[37] = torch.tensor([3.0, 1.0, 1.0])
    blo[38] = torch.tensor([np.nextafter(np.float32(2.0), np.float32(3.0)), -1.0, -1.0])
    bhi[38] = torch.tensor([3.0, 1.0, 1.0])            # one ulp beyond
    center, reach = torch.zeros((1, 3)), torch.tensor([2.0])
    hit, tests = _cull_two_level(center, reach, bval, blo, bhi, 32)
    assert torch.nonzero(hit[0]).squeeze(1).tolist() == [37]
    assert torch.equal(hit, _block_hits(center, reach, bval, blo, bhi))
    assert tests.tolist() == [2 + 32]


def test_cull_empty_super_block_and_a_block_emptied_by_target_extra():
    # 3 super-blocks of 4 blocks x 16 slots: super 1 holds no valid point,
    # block 9 (super 2) is near the center but target_extra empties it
    xyz = torch.full((12, 16, 3), 500.0)
    mask = torch.ones((12, 16), dtype=torch.bool)
    mask[4:8] = False
    xyz[4:8] = 0.0                                     # invalid slots at the center
    xyz[9] = torch.tensor([0.5, 0.0, 0.0])
    xyz[2] = torch.tensor([1.0, 0.0, 0.0])
    extra = torch.ones(12 * 16, dtype=torch.bool)
    extra[9 * 16:10 * 16] = False
    bm = BlockMap(xyz, mask, *([torch.zeros(1)] * 5))
    _, bval, blo, bhi = _block_bounds(bm, extra)
    sval, _, _ = _super_bounds(bval, blo, bhi, 4)
    assert sval.tolist() == [True, False, True]
    center, reach = torch.zeros((1, 3)), torch.tensor([1.5])
    hit, tests = _cull_two_level(center, reach, bval, blo, bhi, 4)
    assert torch.nonzero(hit[0]).squeeze(1).tolist() == [2]
    assert torch.equal(hit, _block_hits(center, reach, bval, blo, bhi))
    assert tests.tolist() == [3 + 4]                   # super 2's bound holds block 8 only
    hit_all, _ = _cull_two_level(center, reach, *_block_bounds(bm, None)[1:], 4)
    assert 9 in torch.nonzero(hit_all[0]).squeeze(1).tolist()


# ---- the work-item plan ----------------------------------------------------------

@pytest.mark.parametrize("chunk", [8, 256, 300, 1024])
def test_work_items_cover_every_listed_block_once(chunk):
    listed = torch.tensor([0, 1, _SEG, _SEG + 1, 3 * _SEG, 2 * _SEG - 1, 0, 5])
    items = _work_items(listed, chunk)
    slabs = -(-chunk // _SLAB)
    seen = {}
    for c, s, g in items.tolist():
        assert 0 <= s < slabs and g * _SEG < listed[c]
        for qi in range(s * _SLAB, min((s + 1) * _SLAB, chunk)):
            for b in range(g * _SEG, min((g + 1) * _SEG, int(listed[c]))):
                seen[c, qi, b] = seen.get((c, qi, b), 0) + 1
    want = {(c, qi, b) for c in range(len(listed)) for qi in range(chunk)
            for b in range(int(listed[c]))}
    assert set(seen) == want and set(seen.values()) == {1}
    segs = (listed + _SEG - 1) // _SEG
    assert items.shape[0] == int(segs.sum()) * slabs


def test_work_items_no_listed_block():
    assert _work_items(torch.zeros(5, dtype=torch.int32), 256).shape == (0, 3)


# ---- the packed top-2 merge --------------------------------------------------------

def _push2(d, b1, b2):
    """The kernels' branch-free top-2 update: an equal value goes to slot 2."""
    return torch.minimum(b1, d), torch.minimum(b2, torch.maximum(b1, d))


def _pack2(b1, b2):
    """float32 (b1 <= b2) -> int64 words, b2's bits high and b1's low, as
    the scoring packs a query's partial top 2."""
    low = b1.contiguous().view(torch.int32).long() & 0xFFFFFFFF
    return (b2.contiguous().view(torch.int32).long() << 32) | low


def _unpack2(w):
    """The inverse of :func:`_pack2`."""
    return ((w & 0xFFFFFFFF).to(torch.int32).view(torch.float32),
            (w >> 32).to(torch.int32).view(torch.float32))


def _merge_packed(w, b1, b2):
    """A packed word after the scoring's atomic fold of (b1, b2) into it."""
    o1, o2 = _unpack2(w)
    o1, o2 = _push2(b1, o1, o2)
    return _pack2(*_push2(b2, o1, o2))


def _fold(parts):
    w = _pack2(torch.tensor([BIG]), torch.tensor([BIG]))
    for b1, b2 in parts:
        w = _merge_packed(w, torch.tensor([b1]), torch.tensor([b2]))
    return tuple(float(x) for x in _unpack2(w))


def test_packed_merge_is_order_independent(rng):
    for _ in range(30):
        k = int(rng.integers(1, 6))
        # a coarse grid of values, so ties within and across parts are common
        parts = [tuple(sorted(rng.integers(0, 4, 2).astype(np.float32))) for _ in range(k)]
        parts = [(b1, BIG) if rng.uniform() < 0.2 else (b1, b2) for b1, b2 in parts]
        want = tuple(sorted([BIG, BIG] + [v for p in parts for v in p])[:2])
        for perm in itertools.permutations(parts):
            assert _fold(perm) == want


def test_packed_merge_keeps_duplicates_and_1e30():
    assert _fold([(1.0, BIG), (1.0, BIG)]) == (1.0, 1.0)
    assert _fold([(2.0, 2.0), (2.0, 3.0)]) == (2.0, 2.0)
    assert _fold([(BIG, BIG), (BIG, BIG)]) == (float(BIG), float(BIG))
    assert _fold([(0.0, BIG)]) == (0.0, float(BIG))


def test_pack_round_trip(rng):
    b = torch.from_numpy(np.sort(rng.uniform(0, 1e4, (100, 2)).astype(np.float32), 1))
    b[::7, 1] = float(BIG)
    o1, o2 = _unpack2(_pack2(b[:, 0], b[:, 1]))
    assert torch.equal(o1, b[:, 0]) and torch.equal(o2, b[:, 1])


# ---- the block arrays the kernels read ----------------------------------------------

@pytest.mark.parametrize("cap", [5, 100, 201])
def test_target_arrays_take_any_capacity(rng, cap):
    """The scoring stages the 16-byte units around a block's slots, so the
    wrapper takes any capacity and a ``target_extra`` at any byte offset."""
    xyz = torch.from_numpy(rng.normal(size=(6, cap, 3)).astype(np.float32))
    bm = BlockMap(xyz, torch.ones((6, cap), dtype=torch.bool), *([torch.zeros(1)] * 5))
    extra = torch.from_numpy(rng.uniform(size=6 * cap + 3) > 0.5)[3:]   # odd byte offset
    txyz, tmask, textra = _target_arrays(bm, extra)
    assert txyz.shape == (6, cap, 3) and tmask.shape == (6, cap)
    assert torch.equal(textra, extra)
    with pytest.raises(ValueError):
        _target_arrays(bm, extra[1:])                  # one entry short


# ---- the kernel route from its plain steps ----------------------------------------

def _route_plain(q, qm, bm, extra, clamp_radius, chunk, k_blocks, sort_cell, seg, slab):
    """The kernels' route with plain steps: sort, the two-level cull, the
    work items of ``seg`` blocks and ``slab`` queries, a top 2 an item that
    starts at (r², r²) (so it is clamped), the row write of a one-segment
    chunk and the packed merge of the others."""
    qt, qmt = torch.from_numpy(q), torch.from_numpy(qm)
    n = q.shape[0]
    t_mask, bval, blo, bhi = _block_bounds(bm, extra)
    qx, qmc, order = _prep_sorted_chunks(qt, qmt, chunk, sort_cell)
    cnt, center, reach = _chunk_balls(qx, qmc, clamp_radius)
    hit, _ = _cull_two_level(center, reach, bval, blo, bhi)
    n_int = hit.sum(1) * (cnt > 0)
    over = n_int > k_blocks
    listed = torch.where(over, 0, n_int)
    r2 = torch.tensor(clamp_radius * clamp_radius, dtype=torch.float32)
    rows = torch.full((qx.shape[0] * chunk, 2), BIG)
    rows[(over[:, None] & qmc).reshape(-1)] = torch.nan
    rows[((listed == 0)[:, None] & qmc & ~over[:, None]).reshape(-1)] = torch.minimum(
        torch.tensor(BIG), r2)
    packed = _pack2(r2.expand(rows.shape[0]), r2.expand(rows.shape[0]))
    for c, s, g in _work_items(listed, chunk, seg, slab).tolist():
        blocks = torch.nonzero(hit[c]).squeeze(1)[g * seg:(g + 1) * seg]
        cand = bm.xyz[blocks][t_mask[blocks]]
        pos = torch.arange(s * slab, min((s + 1) * slab, chunk))
        pos = pos[qmc[c, pos]]
        d2 = sumsq3(qx[c, pos][:, None, :] - cand[None])
        d2 = torch.cat([d2, r2.expand(pos.shape[0], 2)], 1)
        best = torch.topk(d2, 2, dim=1, largest=False).values
        p = c * chunk + pos
        if listed[c] > seg:
            packed[p] = _merge_packed(packed[p], best[:, 0], best[:, 1])
        else:
            rows[p] = best
    multi = torch.repeat_interleave(listed > seg, chunk) & qmc.reshape(-1)
    rows[multi] = torch.stack(_unpack2(packed[multi]), 1)
    out = torch.empty((n, 2))
    out[order] = rows[:n]
    return out, torch.clamp(n_int - k_blocks, min=0).int(), order.int()


@pytest.mark.parametrize("seg,slab", [(1, 256), (3, 32), (_SEG, _SLAB), (1000, 64)])
@pytest.mark.parametrize("name", ["uniform", "clusters", "km_offset", "odd_capacity"])
def test_route_from_plain_steps_equals_the_whole_call(rng, name, seg, slab):
    q, qm, bm, extra, kw = _scene(name, rng)
    if name == "uniform":
        kw = dict(kw, k_blocks=60)    # some chunks overflow
    got, over, order = _route_plain(q, qm, bm, extra, seg=seg, slab=slab, **kw)
    ref = chunk_knn_sqdists_plain(torch.from_numpy(q), torch.from_numpy(qm), bm, extra, **kw)
    assert torch.equal(over, ref.chunk_overflow) and torch.equal(order, ref.order)
    np.testing.assert_array_equal(got.numpy().view(np.int32), ref.sqdists.numpy().view(np.int32))
    if name == "uniform":
        assert int((over > 0).sum()) > 0
