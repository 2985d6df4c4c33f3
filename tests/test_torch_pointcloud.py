"""``ltm_torch.core.pointcloud`` against ``ltm.core.pointcloud`` (the mirror
of tests/test_se3.py:105): the same seeded points through ``from_numpy``,
``concat``, ``and_mask``, ``compact``, ``pad_to`` and ``transform`` give the
same clouds in both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltm.core import pointcloud as jpc
from ltm.core import se3 as jse3
from ltm_torch.core import PointCloud
from ltm_torch.core import pointcloud as tpc

torch.set_num_threads(1)


def _same(tcloud, jcloud):
    np.testing.assert_array_equal(tcloud.mask.numpy(), np.asarray(jcloud.mask))
    np.testing.assert_array_equal(tcloud.xyz.numpy(), np.asarray(jcloud.xyz))
    assert (tcloud.intensity is None) == (jcloud.intensity is None)
    if tcloud.intensity is not None:
        np.testing.assert_array_equal(tcloud.intensity.numpy(), np.asarray(jcloud.intensity))
    np.testing.assert_array_equal(tcloud.to_numpy(), jcloud.to_numpy())
    np.testing.assert_array_equal(tcloud.to_numpy_with_intensity(),
                                  jcloud.to_numpy_with_intensity())


def test_pointcloud_roundtrip(rng):
    pts = rng.normal(size=(100, 3)).astype(np.float32)
    pc = tpc.from_numpy(pts, capacity=128)
    assert isinstance(pc, PointCloud) and pc.capacity == 128 and int(pc.count()) == 100
    np.testing.assert_allclose(pc.to_numpy(), pts)
    _same(pc, jpc.from_numpy(pts, capacity=128))

    both = tpc.concat([pc, pc])
    assert both.capacity == 256 and int(both.count()) == 200
    _same(both, jpc.concat([jpc.from_numpy(pts, capacity=128)] * 2))

    half = pc.and_mask(torch.arange(128) % 2 == 0)
    comp = tpc.compact(half, 64)
    assert int(comp.count()) == 50
    np.testing.assert_allclose(comp.to_numpy(), pts[::2])
    j_half = jpc.from_numpy(pts, capacity=128).and_mask(jnp.arange(128) % 2 == 0)
    _same(comp, jpc.compact(j_half, 64))
    _same(half, j_half)


def test_intensity_pad_mask_and_transform(rng):
    pts = rng.uniform(-20, 20, size=(70, 3)).astype(np.float32)
    inten = rng.uniform(size=70).astype(np.float32)
    tc, jc = tpc.from_numpy(pts, 80, inten), jpc.from_numpy(pts, 80, inten)
    _same(tc, jc)
    _same(tpc.pad_to(tc, 96), jpc.pad_to(jc, 96))
    assert tpc.pad_to(tc, 80) is tc
    with pytest.raises(ValueError):
        tpc.pad_to(tc, 64)
    with pytest.raises(ValueError):
        tpc.from_numpy(pts, capacity=10)
    keep = rng.uniform(size=80) > 0.4
    _same(tc.with_mask(torch.from_numpy(keep)), jc.with_mask(jnp.asarray(keep)))
    _same(tpc.compact(tc.and_mask(torch.from_numpy(keep)), 80),
          jpc.compact(jc.and_mask(jnp.asarray(keep)), 80))
    # an intensity survives concat only when every cloud has one
    assert tpc.concat([tc, tpc.from_numpy(pts)]).intensity is None
    np.testing.assert_array_equal(tc.masked_xyz(-1.0).numpy(), np.asarray(jc.masked_xyz(-1.0)))
    T = np.array(jse3.from_rpy(0.1, -0.2, 0.7, t=[3.0, -1.0, 0.5]), np.float32)
    moved_t = tc.transform(torch.from_numpy(T)).xyz.numpy()
    moved_j = np.asarray(jc.transform(jnp.asarray(T)).xyz)
    np.testing.assert_allclose(moved_t, moved_j, rtol=0, atol=1e-5)
    assert tc.to("cpu").xyz.device.type == "cpu"
