"""ltm_torch.kernels.voxel vs ltm.kernels.voxel on the CPU: the same voxel
set and count, centroids within 1e-6 m, and a bit-equal unique mask."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltm.kernels import voxel as jv
from ltm_torch.kernels import voxel as tv

torch.set_num_threads(1)


def _cloud(rng, n, offset):
    # survey-like: clustered points at a km-scale offset, 10% invalid
    xyz = (rng.normal(0, 3.0, (n, 3)) + offset).astype(np.float32)
    mask = rng.uniform(size=n) > 0.1
    return xyz, mask


@pytest.mark.parametrize("offset", [0.0, 1000.0])
def test_voxel_downsample_centroid_matches(rng, offset):
    xyz, mask = _cloud(rng, 20000, offset)
    cap = 1 << 15
    oj, mj, nj = jv.voxel_downsample_centroid(jnp.asarray(xyz), jnp.asarray(mask), 0.5, cap)
    ot, mt, nt = tv.voxel_downsample_centroid(torch.from_numpy(xyz), torch.from_numpy(mask), 0.5, cap)
    assert int(nj) == nt
    np.testing.assert_array_equal(np.asarray(mj), mt.numpy())
    np.testing.assert_allclose(np.asarray(oj), ot.numpy(), rtol=0, atol=1e-6)


def test_voxel_downsample_centroid_capacity_drops_tail(rng):
    xyz, mask = _cloud(rng, 5000, 0.0)
    oj, mj, nj = jv.voxel_downsample_centroid(jnp.asarray(xyz), jnp.asarray(mask), 0.5, 256)
    ot, mt, nt = tv.voxel_downsample_centroid(torch.from_numpy(xyz), torch.from_numpy(mask), 0.5, 256)
    assert int(nj) == nt > 256
    np.testing.assert_array_equal(np.asarray(mj), mt.numpy())
    np.testing.assert_allclose(np.asarray(oj), ot.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("offset", [0.0, 1000.0])
def test_voxel_unique_mask_bit_equal(rng, offset):
    xyz, mask = _cloud(rng, 20000, offset)
    kj = jv.voxel_unique_mask(jnp.asarray(xyz), jnp.asarray(mask), 0.1)
    kt = tv.voxel_unique_mask(torch.from_numpy(xyz), torch.from_numpy(mask), 0.1)
    np.testing.assert_array_equal(np.asarray(kj), kt.numpy())
