"""ltm_torch.kernels.blocks vs ltm.kernels.blocks on the CPU.

The block map of one point set must be bit-equal (slots, points, AABBs),
its block centers equal up to float32 summation order.  The
block sweeps run on ONE session built by ``ltm`` and carried across with
``session_from_arrays``, so prep differences cannot hide in them.  Their
masks must be equal except where ``apply_pose`` rounds differently: a point
whose local range or pixel differs from ``ltm``'s by an ulp, or a point
sharing a pixel with one.  The test computes that set per keyframe and
asserts it holds every difference.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltm.core.config import RemovertConfig
from ltm.io.synthetic import make_two_sessions
from ltm.kernels import blocks as jb
from ltm.kernels import projection as jp
from ltm.removert import RemovertInput, RemovertSession
from ltm_torch.kernels import blocks as tb
from ltm_torch.kernels import projection as tp
from ltm_torch.removert.convert import config_from_dict, session_from_arrays, session_to_arrays

torch.set_num_threads(1)

FOV = (50.0, 360.0)
_j_apply_pose = jax.jit(jp.apply_pose)
_j_project = jax.jit(jp.spherical_project, static_argnums=(1, 2))


@pytest.fixture(scope="module")
def sessions():
    bundle = make_two_sessions(num_keyframes=3, num_cars=4, num_changed=2,
                               max_scan_points=4000, scan_range=70.0,
                               seed=5, point_noise=0.01)
    cfg = RemovertConfig()
    cfg.scan_capacity = 4096
    cfg.downsample_voxel_size = 0.1
    syn = bundle["query"]          # the rotated session: apply_pose rounds
    inp = RemovertInput(scans=[s for s in syn.data.scans], poses=syn.site_poses)
    js = RemovertSession.build(inp, cfg, "Query", np.arange(len(inp.scans)))
    ts = session_from_arrays(session_to_arrays(js), "cpu")
    return js, ts, config_from_dict(dataclasses.asdict(cfg))


def _affected(xyz, pose_inv, K, shapes):
    """Per-point flag: under some keyframe, the point's local range or pixel
    differs between the packages, or it shares a pixel with such a point."""
    xyz, pose_inv = np.array(xyz), np.array(pose_inv)     # writable copies
    aff = np.zeros(len(xyz), bool)
    for k in range(K):
        lj = _j_apply_pose(jnp.asarray(xyz), jnp.asarray(pose_inv[k]))
        lt = tp.apply_pose(torch.from_numpy(xyz), torch.from_numpy(pose_inv[k]))
        for shape in shapes:
            pj, rj = map(np.asarray, _j_project(lj, FOV, shape))
            pt, rt = (a.numpy() for a in tp.spherical_project(lt, FOV, shape))
            bad = (pj != pt) | (rj != rt)
            pix = np.union1d(pj[bad], pt[bad])
            aff |= bad | np.isin(pj, pix) | np.isin(pt, pix)
    return aff


def _assert_only_affected(a, b, aff, min_set=100):
    a, b = np.asarray(a), b.numpy()
    assert a.sum() >= min_set
    diff = a != b
    assert not np.any(diff & ~aff), int((diff & ~aff).sum())
    print(f"set {a.sum()}: {diff.sum()} differ, {aff.sum()} affected points")


def test_build_block_map_bit_equal(sessions):
    js, _, _ = sessions
    xyz, mask = np.array(js.map_xyz), np.array(js.map_mask)
    bj, oj, sj = jb.build_block_map_with_slots(jnp.asarray(xyz), jnp.asarray(mask), 25.0, 256, 256)
    bt, ot, st = tb.build_block_map_with_slots(torch.from_numpy(xyz), torch.from_numpy(mask), 25.0, 256, 256)
    assert int(oj) == ot
    np.testing.assert_array_equal(np.asarray(sj), st.numpy())
    for f in ("xyz", "mask", "block_valid", "bmin", "bmax"):
        np.testing.assert_array_equal(np.asarray(getattr(bj, f)), getattr(bt, f).numpy(), err_msg=f)
    # centers are 256-point float32 sums, which XLA and PyTorch reduce in
    # different orders; the radius follows them
    cj, ct = np.asarray(bj.centers), bt.centers.numpy()
    ulps = np.abs(cj - ct) / np.spacing(np.abs(cj).max(axis=1, keepdims=True))
    print("centers: max", ulps.max(), "ulps of the block's largest coordinate")
    assert ulps.max() <= 4
    np.testing.assert_allclose(np.asarray(bj.radius), bt.radius.numpy(), rtol=0, atol=1e-4)


def test_block_sweep_discrepancy(sessions):
    js, ts, cfg = sessions
    K = js.num_keyframes
    shape = jp.rimg_shape(FOV, 2.5)
    args = dict(k_blocks=js.bm.num_blocks, max_range=200.0, diff_threshold=0.1, reverse=False)
    dj = jb.block_sweep_discrepancy(js.bm, js.scans_xyz[:K], js.scans_mask[:K], js.poses_inv[:K],
                                    js.poses[:K], FOV, shape, **args)
    dt = tb.block_sweep_discrepancy(ts.bm, ts.scans_xyz[:K], ts.scans_mask[:K], ts.poses_inv[:K],
                                    ts.poses[:K], FOV, shape, **args)
    aff = _affected(np.asarray(js.map_xyz), np.asarray(js.poses_inv), K, [shape])
    _assert_only_affected(dj, dt, aff)


@pytest.fixture(scope="module")
def fused(sessions):
    js, ts, _ = sessions
    K = js.num_keyframes
    shape, proj = jp.rimg_shape(FOV, 2.5), jp.rimg_shape(FOV, 3.0)
    args = dict(k_blocks=js.bm.num_blocks, max_range=400.0, scale=float(2 ** 27) / 256.0)
    wj, ij = jb.block_fused_visibility_images(js.bm, js.map_mask, js.poses_inv[:K], js.poses[:K],
                                              FOV, shape, proj, **args)
    wt, it = tb.block_fused_visibility_images(ts.bm, ts.map_mask, ts.poses_inv[:K], ts.poses[:K],
                                              FOV, shape, proj, **args)
    return wj, ij, wt, it


def test_block_fused_visibility_images(sessions, fused):
    js, _, _ = sessions
    wj, ij, wt, it = fused
    K = js.num_keyframes
    shapes = [jp.rimg_shape(FOV, 2.5), jp.rimg_shape(FOV, 3.0)]
    aff = _affected(np.asarray(js.map_xyz), np.asarray(js.poses_inv), K, shapes)
    _assert_only_affected(wj, wt, aff)
    # an affected point can move a winner out of, and into, one pixel each
    ij, it = np.asarray(ij), it.numpy()
    assert ij.shape == it.shape
    assert (ij != it).sum() <= 2 * aff.sum()


@pytest.mark.parametrize("reverse", [False, True])
def test_block_sweep_discrepancy_vs_images(sessions, fused, reverse):
    """The strong-weak filter sweep: the session's map against images made
    from ltm's winner pass (so both packages read the same images)."""
    js, ts, _ = sessions
    _, ij, _, _ = fused
    K = js.num_keyframes
    shape = jp.rimg_shape(FOV, 2.5)
    # a target set shifted off the imaged surfaces: some points in front of,
    # some behind the image pixels, so both diff signs flag points
    rng = np.random.default_rng(3)
    shift = rng.normal(0, 0.4, np.asarray(js.map_xyz).shape).astype(np.float32)
    txyz = np.asarray(js.map_xyz) + shift
    tmask = np.asarray(js.map_mask) & (rng.uniform(size=len(txyz)) < 0.5)
    bj, _, _ = jb.build_block_map_with_slots(jnp.asarray(txyz), jnp.asarray(tmask), 25.0,
                                             js.bm.num_blocks, 256)
    bt, _, _ = tb.build_block_map_with_slots(torch.from_numpy(txyz), torch.from_numpy(tmask), 25.0,
                                             js.bm.num_blocks, 256)
    args = dict(k_blocks=js.bm.num_blocks, max_range=600.0, diff_threshold=0.1, reverse=reverse)
    dj = jb.block_sweep_discrepancy_vs_images(bj, bj.mask.reshape(-1), ij, js.poses_inv[:K],
                                              js.poses[:K], FOV, shape, **args)
    dt = tb.block_sweep_discrepancy_vs_images(bt, bt.mask.reshape(-1), torch.from_numpy(np.array(ij)),
                                              ts.poses_inv[:K], ts.poses[:K], FOV, shape, **args)
    aff = _affected(np.asarray(bj.xyz).reshape(-1, 3), np.asarray(js.poses_inv), K, [shape])
    _assert_only_affected(dj, dt, aff)


@pytest.fixture(scope="module")
def keyframes(sessions):
    """The session's rotated keyframe poses and its block budget at 20 m,
    the same from either package's layout."""
    js, ts, _ = sessions
    K = js.num_keyframes
    pinv, poses = np.array(js.poses_inv)[:K], np.array(js.poses)[:K]
    kb = tb.required_k_blocks(ts.bm, poses[:, :3, 3], 20.0, round_to=8)
    assert kb == jb.required_k_blocks(js.bm, poses[:, :3, 3], 20.0, round_to=8)
    assert kb < js.bm.num_blocks
    assert kb == tb.required_k_blocks_np(*(a.numpy() for a in (ts.bm.centers, ts.bm.radius,
                                                              ts.bm.block_valid)),
                                         poses[:, :3, 3], 20.0, round_to=8)
    return pinv, poses, kb


def _pixel_spread(aff, src_xyz, tgt_xyz, pose_inv, K, shape):
    """Target points that share a ``shape`` pixel, in either package under
    some keyframe, with an affected source point: a projected scan's image
    can change there."""
    out = np.zeros(len(tgt_xyz), bool)
    for k in range(K):
        pix = []
        for xyz in (src_xyz, tgt_xyz):
            lj = _j_apply_pose(jnp.asarray(xyz), jnp.asarray(pose_inv[k]))
            lt = tp.apply_pose(torch.from_numpy(np.array(xyz)), torch.from_numpy(pose_inv[k]))
            pix.append((np.asarray(_j_project(lj, FOV, shape)[0]),
                        tp.spherical_project(lt, FOV, shape)[0].numpy()))
        bad = np.union1d(pix[0][0][aff], pix[0][1][aff])
        out |= np.isin(pix[1][0], bad) | np.isin(pix[1][1], bad)
    return out


@pytest.mark.parametrize("name", ["block_sweep_visibility", "block_projected_scan_images",
                                  "block_sweep_discrepancy_projected"])
def test_block_keyframe_sweeps(sessions, keyframes, name):
    """The three block sweeps against ``ltm``'s under the session's rotated
    poses and the module's rule: masks equal but at affected points, images
    at no more than two pixels an affected point.  The projected scans'
    winners reach the target through the image, so a target point in the
    ``shape`` pixel of an affected source point counts as affected too."""
    js, ts, _ = sessions
    pinv, poses, kb = keyframes
    K = js.num_keyframes
    shape, proj = jp.rimg_shape(FOV, 2.5), jp.rimg_shape(FOV, 3.0)
    rng = np.random.default_rng(4)
    extra = rng.uniform(size=js.bm.num_blocks * js.bm.block_capacity) > 0.3
    j = (jnp.asarray(extra), jnp.asarray(pinv), jnp.asarray(poses))
    t = (torch.from_numpy(extra), torch.from_numpy(pinv), torch.from_numpy(poses))
    kw = dict(k_blocks=kb, max_range=20.0)
    xyz = np.asarray(js.bm.xyz).reshape(-1, 3)
    aff = _affected(xyz, pinv, K, [shape, proj])
    if name == "block_sweep_visibility":
        ref = jb.block_sweep_visibility(js.bm, *j, FOV, proj, **kw)
        got = tb.block_sweep_visibility(ts.bm, *t, FOV, proj, **kw)
        return _assert_only_affected(ref, got, aff)
    if name == "block_projected_scan_images":
        ref = np.asarray(jb.block_projected_scan_images(js.bm, *j, FOV, shape, proj, **kw))
        got = tb.block_projected_scan_images(ts.bm, *t, FOV, shape, proj, **kw).numpy()
        assert got.shape == ref.shape and (got < tp.NO_POINT).sum() > 1000
        assert (got != ref).sum() <= 2 * aff.sum()
        return
    # the map's other points as the target of the map's projected scans
    ref = jb.block_sweep_discrepancy_projected(js.bm, jnp.asarray(~extra), js.bm, *j, FOV, shape,
                                               proj, reverse=True, **kw)
    got = tb.block_sweep_discrepancy_projected(ts.bm, torch.from_numpy(~extra), ts.bm, *t, FOV,
                                               shape, proj, reverse=True, **kw)
    _assert_only_affected(ref, got, aff | _pixel_spread(aff, xyz, xyz, pinv, K, shape))
