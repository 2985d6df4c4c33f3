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
