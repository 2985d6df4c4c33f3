"""ltm_torch.kernels.projection vs ltm.kernels.projection on the CPU.

Both packages get identical local-frame points, so the projection itself
must be bit-equal: pixel ids, the range image, winner masks, the packed
winner image (mask and decoded image) and the discrepancy mask.  ``ltm``'s
functions run under ``jit``, as its pipeline runs them (XLA then fuses
multiply-adds, which the port reproduces).  ``apply_pose`` is checked on
its own at km-scale coordinates, within 1 ulp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltm.kernels import projection as jp
from ltm_torch.kernels import projection as tp

torch.set_num_threads(1)

FOV = (50.0, 360.0)
SHAPE = jp.rimg_shape(FOV, 2.5)
PROJ = jp.rimg_shape(FOV, 3.0)

j_project = jax.jit(jp.spherical_project, static_argnums=(1, 2))
j_range_image = jax.jit(jp.range_image, static_argnums=(2, 3))
j_winner = jax.jit(lambda x, m, fov, shape: jp.winner_mask(x, m, fov, shape)[0],
                   static_argnums=(2, 3))
j_packed = jax.jit(jp.packed_winner_image, static_argnums=(2, 3, 4, 5))


def _cloud(rng, n, extent=60.0):
    xyz = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    xyz[:, 2] *= 0.1
    mask = rng.uniform(size=n) > 0.1
    return xyz, mask


def _both(a):
    return jnp.asarray(a), torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("shape", [SHAPE, PROJ])
def test_pixels_and_range_image_bit_equal(rng, shape):
    xyz, mask = _cloud(rng, 20000)
    xj, xt = _both(xyz)
    mj, mt = _both(mask)
    pj, rj = j_project(xj, FOV, shape)
    pt, rt = tp.spherical_project(xt, FOV, shape)
    np.testing.assert_array_equal(np.asarray(pj), pt.numpy())
    np.testing.assert_array_equal(np.asarray(rj), rt.numpy())
    np.testing.assert_array_equal(np.asarray(j_range_image(xj, mj, FOV, shape)),
                                  tp.range_image(xt, mt, FOV, shape).numpy())
    np.testing.assert_array_equal(np.asarray(j_winner(xj, mj, FOV, shape)),
                                  tp.winner_mask(xt, mt, FOV, shape)[0].numpy())


def test_packed_winner_image_bit_equal(rng):
    xyz, mask = _cloud(rng, 30000)
    xj, xt = _both(xyz)
    mj, mt = _both(mask)
    scale = float(2 ** 27) / 256.0
    wj, ij = j_packed(xj, mj, FOV, PROJ, SHAPE, scale)
    wt, it = tp.packed_winner_image(xt, mt, FOV, PROJ, SHAPE, scale)
    np.testing.assert_array_equal(np.asarray(wj), wt.numpy())
    np.testing.assert_array_equal(np.asarray(ij), it.numpy())


@pytest.mark.parametrize("reverse", [False, True])
def test_discrepancy_mask_bit_equal(rng, reverse):
    xyz, mask = _cloud(rng, 20000)
    # a scan that sees part of the map, partly nearer and partly farther
    scan = xyz[:8000] * rng.uniform(0.97, 1.03, (8000, 1)).astype(np.float32)
    smask = np.ones(8000, bool)
    args = [_both(a) for a in (xyz, mask, scan, smask)]
    dj = jp.discrepancy_mask(*(a[0] for a in args), FOV, SHAPE, 0.1, reverse)
    dt = tp.discrepancy_mask(*(a[1] for a in args), FOV, SHAPE, 0.1, reverse)
    assert np.asarray(dj).sum() > 100
    np.testing.assert_array_equal(np.asarray(dj), dt.numpy())


def test_apply_pose_within_one_ulp(rng):
    # km-scale global coordinates, a yawed and slightly tilted pose
    xyz = (rng.uniform(-60, 60, (50000, 3)) + [1200.0, -300.0, 5.0]).astype(np.float32)
    c, s = np.cos(0.7), np.sin(0.7)
    T = np.eye(4)
    T[:3, :3] = [[c, -s, 0.01], [s, c, -0.02], [-0.01, 0.02, 1.0]]
    T[:3, 3] = [1190.0, -310.0, 2.0]
    Tinv = np.linalg.inv(T).astype(np.float32)
    a = np.asarray(jax.jit(jp.apply_pose)(jnp.asarray(xyz), jnp.asarray(Tinv)))
    b = tp.apply_pose(torch.from_numpy(xyz), torch.from_numpy(Tinv)).numpy()
    # the rounding of R·p + t happens at the magnitude of its terms (km),
    # not of its result (tens of metres): 1 ulp of Σ|terms|
    mag = (np.abs(xyz) @ np.abs(Tinv[:3, :3]).T + np.abs(Tinv[:3, 3])).astype(np.float32)
    assert np.all(np.abs(a - b) <= np.spacing(mag))
    print("apply_pose: %.2g of coordinates differ" % (a != b).mean())


def _translations(rng, k=3):
    """Keyframe poses that only translate: ``apply_pose`` then adds the
    offset alone, so both packages see the same local points and the
    sweeps' masks and images must be bit-equal."""
    pinv = np.tile(np.eye(4, dtype=np.float32), (k, 1, 1))
    pinv[:, :3, 3] = rng.uniform(-20, 20, (k, 3)).astype(np.float32) * [1, 1, 0.05]
    return pinv


def _rotations(rng, k=3):
    """Keyframe poses that yaw, tilt slightly and translate: ``apply_pose``
    may round differently in the two packages, and the sweeps are held to
    the affected-point rule of tests/test_torch_blocks.py."""
    pinv = _translations(rng, k)
    for T, yaw, tilt in zip(pinv, rng.uniform(-np.pi, np.pi, k), rng.uniform(-0.05, 0.05, (k, 2))):
        c, s = np.cos(yaw), np.sin(yaw)
        rz = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        rx = np.array([[1, 0, 0], [0, np.cos(tilt[0]), -np.sin(tilt[0])],
                       [0, np.sin(tilt[0]), np.cos(tilt[0])]])
        ry = np.array([[np.cos(tilt[1]), 0, np.sin(tilt[1])], [0, 1, 0],
                       [-np.sin(tilt[1]), 0, np.cos(tilt[1])]])
        T[:3, :3] = rz @ rx @ ry
    return pinv


def _sweep_case(rng, name, poses):
    xyz, mask = _cloud(rng, 20000)
    src = (xyz[:12000] * rng.uniform(0.97, 1.03, (12000, 1))).astype(np.float32)
    smask = rng.uniform(size=12000) > 0.05
    pinv = poses(rng)
    if name == "sweep_visibility":
        args = (xyz, mask, pinv)
        static = (FOV, PROJ)
    elif name == "projected_scan_images":
        args = (src, smask, pinv)
        static = (FOV, SHAPE, PROJ)
    else:
        args = (xyz, mask, src, smask, pinv)
        static = (FOV, SHAPE, PROJ)
    kw = dict(diff_threshold=0.1, reverse=True) if name == "sweep_discrepancy_projected" else {}
    ref = np.asarray(getattr(jp, name)(*(jnp.asarray(a) for a in args), *static, **kw))
    got = getattr(tp, name)(*(torch.from_numpy(a) for a in args), *static, **kw).numpy()
    assert got.shape == ref.shape and got.dtype == ref.dtype
    if got.dtype == bool:
        assert 0 < got.sum() < got.size
    else:
        assert (got < tp.NO_POINT).sum() > 1000
    return xyz, src, pinv, ref, got


@pytest.mark.parametrize("name", ["sweep_visibility", "projected_scan_images",
                                  "sweep_discrepancy_projected"])
def test_keyframe_sweeps_rotated(rng, name):
    """The three keyframe sweeps under rotated poses, against ``ltm`` under
    the affected-point rule: masks equal but at affected points, images at
    no more than two pixels an affected source point; a target point in the
    ``SHAPE`` pixel of an affected source point counts as affected too."""
    from test_torch_blocks import _affected, _assert_only_affected, _pixel_spread

    xyz, src, pinv, ref, got = _sweep_case(rng, name, _rotations)
    K = len(pinv)
    if name == "sweep_visibility":
        return _assert_only_affected(ref, torch.from_numpy(got), _affected(xyz, pinv, K, [PROJ]))
    aff_src = _affected(src, pinv, K, [SHAPE, PROJ])
    if name == "projected_scan_images":
        assert (got != ref).sum() <= 2 * aff_src.sum()
        print(f"images: {(got != ref).sum()} pixels differ, {aff_src.sum()} affected points")
        return
    aff = _affected(xyz, pinv, K, [SHAPE]) | _pixel_spread(aff_src, src, xyz, pinv, K, SHAPE)
    _assert_only_affected(ref, torch.from_numpy(got), aff)


@pytest.mark.parametrize("name", ["sweep_visibility", "projected_scan_images",
                                  "sweep_discrepancy_projected"])
def test_keyframe_sweeps_bit_equal(rng, name):
    *_, ref, got = _sweep_case(rng, name, _translations)
    np.testing.assert_array_equal(got, ref)
