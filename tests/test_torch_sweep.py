"""ltm_torch.kernels.sweep on the CPU: the plain mirror of the sweep kernels
K2 and K3 (batched block selection, every keyframe's image at offset
``k·n_pix``, one scatter-min a pass, the decoded gather rule, keyframe
chunks) against the per-keyframe loops of ``ltm_torch.kernels.blocks``
(``*_plain``), bit for bit, and against ``ltm``'s jitted sweeps within
``test_torch_blocks.py``'s rule (masks equal but at points whose local
range or pixel rounds differently, or that share a pixel with one).  Then
the edge cases the card checks (``chip_smoke.py``), the wrappers' argument
checks, and the batched selection against ``_select_blocks``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltm.kernels import blocks as jb
from ltm_torch.dist.removert import _pad_poses_far
from ltm_torch.kernels import blocks as tb
from ltm_torch.kernels import projection as tp
from ltm_torch.kernels import sweep
from test_torch_blocks import _affected, _assert_only_affected, sessions  # noqa: F401

torch.set_num_threads(1)

FOV = (50.0, 360.0)
SHAPE = tp.rimg_shape(FOV, 2.5)
PROJ = tp.rimg_shape(FOV, 3.0)
SCALE = float(2 ** 27) / 256.0


def _equal(a, b):
    """Bit-equal results: masks, or (mask, float32 images)."""
    if isinstance(a, tuple):
        assert a[1].shape == b[1].shape and a[1].dtype == b[1].dtype
        np.testing.assert_array_equal(a[1].view(torch.int32).numpy(),
                                      b[1].view(torch.int32).numpy())
        a, b = a[0], b[0]
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(a.numpy(), b.numpy())


# ---- against ltm's jitted sweeps ----------------------------------------------

@pytest.fixture(scope="module")
def ltm_images(sessions):  # noqa: F811
    """ltm's winner images of the session's map, which both packages read
    as the source images of the strong-weak sweeps."""
    js, _, _ = sessions
    K = js.num_keyframes
    _, ij = jb.block_fused_visibility_images(js.bm, js.map_mask, js.poses_inv[:K], js.poses[:K],
                                             FOV, SHAPE, PROJ, k_blocks=js.bm.num_blocks,
                                             max_range=400.0, scale=SCALE)
    return np.array(ij)


def _target(js):
    """A target set shifted off the imaged surfaces (both diff signs flag
    points), as a block map of either package."""
    rng = np.random.default_rng(3)
    xyz = np.asarray(js.map_xyz)
    txyz = xyz + rng.normal(0, 0.4, xyz.shape).astype(np.float32)
    tmask = np.asarray(js.map_mask) & (rng.uniform(size=len(txyz)) < 0.5)
    bj, _, _ = jb.build_block_map_with_slots(jnp.asarray(txyz), jnp.asarray(tmask), 25.0,
                                             js.bm.num_blocks, 256)
    bt = tb.BlockMap(*(torch.from_numpy(np.array(f)) for f in bj))
    return bj, bt


@pytest.mark.parametrize("name,reverse", [
    ("forward", False), ("forward", True), ("vs_images", False), ("vs_images", True),
    ("presel", False), ("presel", True), ("fused", False)])
def test_mirror_against_ltm_and_plain(sessions, ltm_images, name, reverse):  # noqa: F811
    """Each of the four sweeps through the mirror: bit-equal to the
    per-keyframe plain version, and to ``ltm`` but at affected points."""
    js, ts, _ = sessions
    K = js.num_keyframes
    nb = js.bm.num_blocks
    pinv, poses = ts.poses_inv[:K], ts.poses[:K]
    j_args = (js.poses_inv[:K], js.poses[:K], FOV)
    shapes = [SHAPE]
    if name == "forward":
        # the shifted target map against the session's scans
        bj, bt = _target(js)
        kw = dict(k_blocks=nb, max_range=200.0, diff_threshold=0.1, reverse=reverse)
        args = (bt, ts.scans_xyz[:K], ts.scans_mask[:K], pinv, poses, FOV, SHAPE)
        ref = jb.block_sweep_discrepancy(bj, js.scans_xyz[:K], js.scans_mask[:K], *j_args,
                                         SHAPE, **kw)
        got = sweep.block_sweep_discrepancy(*args, **kw)
        plain = tb.block_sweep_discrepancy_plain(*args, **kw)
        xyz = np.asarray(bj.xyz).reshape(-1, 3)
    elif name == "fused":
        kw = dict(k_blocks=nb, max_range=400.0, scale=SCALE)
        args = (ts.bm, ts.map_mask, pinv, poses, FOV, SHAPE, PROJ)
        ref = jb.block_fused_visibility_images(js.bm, js.map_mask, *j_args, SHAPE, PROJ, **kw)
        got = sweep.block_fused_visibility_images(*args, **kw)
        plain = tb.block_fused_visibility_images_plain(*args, **kw)
        _equal(got, plain)
        xyz = np.asarray(js.bm.xyz).reshape(-1, 3)
        aff = _affected(xyz, np.asarray(js.poses_inv), K, [SHAPE, PROJ])
        _assert_only_affected(ref[0], got[0], aff)
        assert (np.asarray(ref[1]) != got[1].numpy()).sum() <= 2 * aff.sum()
        return
    else:
        bj, bt = _target(js)
        imgs = torch.from_numpy(ltm_images)
        kw = dict(diff_threshold=0.1, reverse=reverse)
        if name == "vs_images":
            kw.update(k_blocks=nb, max_range=600.0)
            args = (bt, bt.mask.reshape(-1), imgs, pinv, poses, FOV, SHAPE)
            ref = jb.block_sweep_discrepancy_vs_images(bj, bj.mask.reshape(-1), ltm_images,
                                                       *j_args, SHAPE, **kw)
            got = sweep.block_sweep_discrepancy_vs_images(*args, **kw)
            plain = tb.block_sweep_discrepancy_vs_images_plain(*args, **kw)
        else:
            # every occupied block, in a shuffled list padded with invalid entries
            occ = np.flatnonzero(np.asarray(bj.block_valid))
            rng = np.random.default_rng(7)
            k_sel = len(occ) + 37
            sel = np.zeros((K, k_sel), np.int32)
            val = np.zeros((K, k_sel), bool)
            for k in range(K):
                sel[k, :len(occ)] = rng.permutation(occ)
                val[k, :len(occ)] = True
            args = (bt, bt.mask.reshape(-1), imgs, pinv, torch.from_numpy(sel).long(),
                    torch.from_numpy(val), FOV, SHAPE)
            ref = jb.block_sweep_discrepancy_vs_images_presel(
                bj, bj.mask.reshape(-1), ltm_images, js.poses_inv[:K], jnp.asarray(sel),
                jnp.asarray(val), FOV, SHAPE, **kw)
            got = sweep.block_sweep_discrepancy_vs_images_presel(*args, **kw)
            plain = tb.block_sweep_discrepancy_vs_images_presel_plain(*args, **kw)
        xyz = np.asarray(bj.xyz).reshape(-1, 3)
    _equal(got, plain)
    _assert_only_affected(ref, got, _affected(xyz, np.asarray(js.poses_inv), K, shapes))


# ---- edge cases, mirror against the plain loops ---------------------------------

@pytest.fixture(scope="module")
def world():
    """A small synthetic survey from a NumPy seed: a 20 000-point map in
    48-slot blocks, 4 keyframes (yaw-rotated; keyframe 0 unrotated with a
    map point at its origin, so at range 0) of 3 000 scan points."""
    rng = np.random.default_rng(11)
    K, S = 4, 3000
    xyz = rng.uniform([-40, -40, -3], [40, 40, 6], (20_000, 3)).astype(np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    for k in range(1, K):
        yaw = rng.uniform(0, 2 * np.pi)
        poses[k, :2, :2] = [[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw), np.cos(yaw)]]
    poses[:, :3, 3] = rng.uniform([-15, -15, 0], [15, 15, 1], (K, 3))
    xyz[0] = poses[0, :3, 3]
    mask = rng.uniform(size=len(xyz)) > 0.05
    mask[0] = True
    bm, ov, _ = tb.build_block_map_with_slots(torch.from_numpy(xyz), torch.from_numpy(mask),
                                              10.0, 512, 48)
    assert ov == 0
    pose_inv = np.linalg.inv(poses.astype(np.float64)).astype(np.float32)
    d = rng.normal(size=(K, S, 3))
    d[..., 2] *= 0.2
    scans = (d / np.linalg.norm(d, axis=-1, keepdims=True)
             * rng.uniform(1, 60, (K, S, 1))).astype(np.float32)
    smask = rng.uniform(size=(K, S)) > 0.1
    pinv, pos = torch.from_numpy(pose_inv), torch.from_numpy(poses)
    kb = tb.required_k_blocks(bm, poses[:, :3, 3], 45.0, round_to=8)
    assert kb < bm.num_blocks
    extra = torch.from_numpy(rng.uniform(size=bm.mask.numel()) > 0.3)
    # source images of the other points: the target (extra) lies in front of
    # and behind them, so both diff signs flag
    _, imgs = tb.block_fused_visibility_images_plain(bm, ~extra, pinv, pos, FOV, SHAPE, PROJ,
                                                     k_blocks=bm.num_blocks, max_range=400.0,
                                                     scale=SCALE)
    return dict(bm=bm, pinv=pinv, poses=pos, scans=torch.from_numpy(scans),
                smask=torch.from_numpy(smask), kb=kb, extra=extra, imgs=imgs)


def _run(w, name, mod, reverse=False, k_blocks=None, K=None):
    """One sweep of ``mod`` (``sweep`` or ``blocks`` with ``_plain``) on the
    world's first K keyframes."""
    sfx = "" if mod is sweep else "_plain"
    K = w["pinv"].shape[0] if K is None else K
    kb = w["kb"] if k_blocks is None else k_blocks
    pinv, poses, bm = w["pinv"][:K], w["poses"][:K], w["bm"]
    if name == "forward":
        return getattr(mod, "block_sweep_discrepancy" + sfx)(
            bm, w["scans"][:K], w["smask"][:K], pinv, poses, FOV, SHAPE, k_blocks=kb,
            max_range=45.0, diff_threshold=0.1, reverse=reverse)
    if name == "vs_images":
        return getattr(mod, "block_sweep_discrepancy_vs_images" + sfx)(
            bm, w["extra"], w["imgs"][:K], pinv, poses, FOV, SHAPE, k_blocks=kb,
            max_range=45.0, diff_threshold=0.1, reverse=reverse)
    if name == "presel":
        return getattr(mod, "block_sweep_discrepancy_vs_images_presel" + sfx)(
            bm, w["extra"], w["imgs"][:K], pinv, w["sel"][:K], w["val"][:K], FOV, SHAPE,
            diff_threshold=0.1, reverse=reverse)
    return getattr(mod, "block_fused_visibility_images" + sfx)(
        bm, w["extra"], pinv, poses, FOV, SHAPE, PROJ, k_blocks=kb, max_range=45.0,
        scale=SCALE)


def _with_presel(w):
    """The world with (K, k_sel) lists of the in-range blocks in reversed
    order, padded by invalid entries that repeat block 0."""
    sel, val = sweep.select_blocks(w["bm"], w["poses"][:, :3, 3], 45.0, w["kb"])
    sel = torch.cat([sel.flip(1), torch.zeros_like(sel[:, :9])], 1)
    val = torch.cat([val.flip(1), torch.zeros_like(val[:, :9])], 1)
    return dict(w, sel=sel, val=val)


_SWEEPS = [("forward", False), ("forward", True), ("vs_images", False), ("vs_images", True),
           ("presel", False), ("presel", True), ("fused", False)]


@pytest.mark.parametrize("name,reverse", _SWEEPS)
def test_mirror_bit_equal_plain(world, name, reverse):
    w = _with_presel(world)
    got, plain = _run(w, name, sweep, reverse), _run(w, name, tb, reverse)
    _equal(got, plain)
    flagged = (got[0] if isinstance(got, tuple) else got).sum()
    assert flagged > 50, int(flagged)


@pytest.mark.parametrize("name,reverse", _SWEEPS)
def test_forced_keyframe_chunks(world, monkeypatch, name, reverse):
    """Keyframes in chunks of 1 and of 3 give the unchunked bits."""
    w = _with_presel(world)
    whole = _run(w, name, sweep, reverse)
    for cap in (1, 3):
        monkeypatch.setattr(sweep, "MAX_KEYFRAMES", cap)
        _equal(_run(w, name, sweep, reverse), whole)


@pytest.mark.parametrize("name", ["forward", "vs_images", "fused"])
def test_all_blocks_selected(world, name):
    """``k_blocks == n_blocks``: the whole map a keyframe."""
    nb = world["bm"].num_blocks
    _equal(_run(world, name, sweep, k_blocks=nb), _run(world, name, tb, k_blocks=nb))


@pytest.mark.parametrize("name", ["forward", "vs_images", "presel", "fused"])
def test_no_keyframes(world, name):
    """K = 0: nothing launched, all-False masks and (0, n_pix) images."""
    w = _with_presel(world)
    got, plain = _run(w, name, sweep, K=0), _run(w, name, tb, K=0)
    _equal(got, plain)
    if isinstance(got, tuple):
        assert got[1].shape == (0, SHAPE[0] * SHAPE[1])
        got = got[0]
    assert got.shape == (w["bm"].mask.numel(),) and not got.any()


def test_range_zero_point_never_flagged(world):
    """The map point at keyframe 0's origin lies at range 0: it may win its
    pixel, but a winning range of 0 is never flagged (the ``m > 0`` of the
    decoded gather), here under an image that flags every pixel."""
    bm = world["bm"]
    flat = bm.xyz.reshape(-1, 3)
    slot = int(torch.nonzero((flat == world["poses"][0, :3, 3]).all(1) & bm.mask.reshape(-1))[0])
    local = tp.apply_pose(flat[slot:slot + 1], world["pinv"][0])
    assert float(tp.sumsq3(local)[0]) == 0.0
    imgs = torch.full((1, SHAPE[0] * SHAPE[1]), 50.0)
    args = (bm, bm.mask.reshape(-1), imgs, world["pinv"][:1], world["poses"][:1], FOV, SHAPE)
    kw = dict(k_blocks=world["kb"], max_range=45.0, diff_threshold=0.1)
    got = sweep.block_sweep_discrepancy_vs_images(*args, **kw)
    _equal(got, tb.block_sweep_discrepancy_vs_images_plain(*args, **kw))
    assert got.sum() > 100 and not bool(got[slot])
    win, _ = sweep.block_fused_visibility_images(bm, bm.mask.reshape(-1), world["pinv"][:1],
                                                 world["poses"][:1], FOV, SHAPE, PROJ,
                                                 k_blocks=world["kb"], max_range=45.0,
                                                 scale=SCALE)
    assert bool(win[slot])      # it wins its proj pixel: nothing lies nearer


def test_all_masked_keyframe(world):
    """A keyframe whose scan is all masked sees an all-NO_POINT image."""
    w = dict(world, smask=world["smask"].clone())
    w["smask"][1] = False
    _equal(_run(w, "forward", sweep), _run(w, "forward", tb))
    _equal(_run(w, "forward", sweep, reverse=True), _run(w, "forward", tb, reverse=True))


@pytest.mark.parametrize("name", ["forward", "vs_images", "fused"])
def test_far_padded_keyframes(world, name):
    """Keyframes padded 1e9 m away, as the mesh pads them, select no block
    and flag nothing: the padded sweep equals the unpadded one."""
    pinv, poses = _pad_poses_far(world["pinv"], world["poses"], 7)
    K = pinv.shape[0]
    pad = K - world["pinv"].shape[0]
    w = dict(world, pinv=pinv, poses=poses,
             scans=torch.cat([world["scans"], torch.zeros((pad,) + world["scans"].shape[1:])]),
             smask=torch.cat([world["smask"], torch.zeros((pad, world["smask"].shape[1]),
                                                          dtype=torch.bool)]),
             imgs=torch.cat([world["imgs"], torch.full((pad, world["imgs"].shape[1]),
                                                       tp.NO_POINT)]))
    sel, val = sweep.select_blocks(w["bm"], poses[:, :3, 3], 45.0, w["kb"])
    assert not val[-pad:].any()
    got = _run(w, name, sweep)
    _equal(got, _run(w, name, tb))
    if isinstance(got, tuple):
        _equal(got[0], _run(world, name, sweep)[0])
        assert bool((got[1][-pad:] == tp.NO_POINT).all())
    else:
        _equal(got, _run(world, name, sweep))


# ---- selection ------------------------------------------------------------------

@pytest.mark.parametrize("max_range,k_blocks,occupied", [
    (45.0, None, False), (45.0, None, True), (400.0, 512, False), (45.0, 8, False),
    (1.0, 8, False)])
def test_selection_sets(world, max_range, k_blocks, occupied):
    """The batched selection picks each keyframe's ``_select_blocks`` set
    (also when ``k_blocks`` truncates: the distances here are distinct)."""
    bm = world["bm"]
    valid = None
    if occupied:
        valid = bm.block_valid & torch.any(bm.mask & world["extra"].reshape(bm.mask.shape), 1)
    kb = world["kb"] if k_blocks is None else k_blocks
    sel, val = sweep.select_blocks(bm, world["poses"][:, :3, 3], max_range, kb, valid=valid)
    ref_bm = bm if valid is None else bm._replace(block_valid=valid)
    for k in range(sel.shape[0]):
        rs, rv = tb._select_blocks(ref_bm, world["poses"][k, :3, 3], max_range, kb)
        assert set(sel[k][val[k]].tolist()) == set(rs[rv].tolist())
        assert int(val[k].sum()) == int(rv.sum())


# ---- argument checks ------------------------------------------------------------

def _bad_calls(w):
    bm, K = w["bm"], w["pinv"].shape[0]
    sel, val = sweep.select_blocks(bm, w["poses"][:, :3, 3], 45.0, w["kb"])
    base = dict(bm=bm, extra=None, sel=sel, sel_valid=val, pose_inv=w["pinv"], fov=FOV,
                shape=SHAPE, scan_imgs=w["imgs"])
    return {
        "float64_map": dict(base, bm=bm._replace(xyz=bm.xyz.double())),
        "int_mask": dict(base, bm=bm._replace(mask=bm.mask.int())),
        "short_extra": dict(base, extra=w["extra"][:-1]),
        "float64_poses": dict(base, pose_inv=w["pinv"].double()),
        "pose_rows": dict(base, pose_inv=w["pinv"][:, :3]),
        "float_sel": dict(base, sel=sel.float()),
        "sel_rows": dict(base, sel=sel[:K - 1], sel_valid=val[:K - 1]),
        "sel_valid_shape": dict(base, sel_valid=val[:, :-1]),
        "image_shape": dict(base, scan_imgs=w["imgs"][:, :-1]),
        "image_dtype": dict(base, scan_imgs=w["imgs"].double()),
        "scans_and_images": dict(base, scans=(w["scans"], w["smask"])),
        "neither": dict(base, scan_imgs=None),
        "scan_mask_shape": dict(base, scan_imgs=None, scans=(w["scans"], w["smask"][:, :-1])),
        "meta_device": dict(base, bm=bm._replace(xyz=bm.xyz.to("meta"))),
    }


_BAD = ["float64_map", "int_mask", "short_extra", "float64_poses", "pose_rows", "float_sel",
        "sel_rows", "sel_valid_shape", "image_shape", "image_dtype", "scans_and_images",
        "neither", "scan_mask_shape", "meta_device"]


@pytest.mark.parametrize("case", _BAD)
def test_discrepancy_sweep_checks(world, case):
    with pytest.raises(ValueError):
        sweep.discrepancy_sweep(**_bad_calls(world)[case])


def test_winner_and_selection_checks(world):
    bm = world["bm"]
    sel, val = sweep.select_blocks(bm, world["poses"][:, :3, 3], 45.0, world["kb"])
    with pytest.raises(ValueError, match="no finer"):
        sweep.winner_sweep(bm, None, sel, val, world["pinv"], FOV, PROJ, SHAPE, SCALE)
    with pytest.raises(ValueError, match="k_blocks"):
        sweep.select_blocks(bm, world["poses"][:, :3, 3], 45.0, bm.num_blocks + 1)
    with pytest.raises(ValueError, match="card"):      # the pixel-rule check is card-only
        sweep.pixel_rule(bm.xyz.reshape(-1, 3), world["pinv"][0], FOV, SHAPE, PROJ, SCALE)
