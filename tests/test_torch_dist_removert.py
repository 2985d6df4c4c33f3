"""The port's sharded LT-removert sweeps and kNN (``ltm_torch.dist.removert``
and ``ltm_torch.dist.sharding``) on meshes of CPU slots.

Every sharded function runs on 1, 3 and 8 slots (3 and 8 pad the 5
keyframes and the 23 kNN chunks) and must equal the port's one-device
function bit for bit (NaN rows of overflowed chunks included), and be
held to ``ltm``'s jitted one-device function under the rule of the
existing one-device comparison: the poses are pure translations, so
``apply_pose`` gives both packages the same local points and the masks and
images are bit-equal (tests/test_torch_projection.py); the brute 2-NN
statistic, a mean of two distances each within an ulp of ``ltm``'s
(tests/test_torch_knn.py), is within two ulps; the chunked kNN keeps
``ltm``'s overflow, order and the bits of every row of a chunk that did
not overflow (tests/test_torch_chunk_knn.py).  Two functions are also
compared with ``ltm``'s own sharded function on conftest's 8 virtual
devices, to hold the padding semantics.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltm.dist import mesh as jmesh
from ltm.dist import removert as jdr
from ltm.kernels import blocks as jb
from ltm.kernels import chunk_knn as jck
from ltm.kernels import knn as jknn
from ltm.kernels import projection as jp
from ltm_torch.dist import make_mesh
from ltm_torch.dist import removert as tdr
from ltm_torch.dist import sharding as tds
from ltm_torch.kernels import blocks as tb
from ltm_torch.kernels import chunk_knn as tck
from ltm_torch.kernels import knn as tknn
from ltm_torch.kernels import projection as tp

torch.set_num_threads(1)

FOV = (50.0, 360.0)
SHAPE = jp.rimg_shape(FOV, 2.5)
PROJ = jp.rimg_shape(FOV, 3.0)
K = 5
SCALE = float(2 ** 27) / 256.0
RANGE = 25.0
CHUNK_KW = dict(clamp_radius=1.5, k=2, chunk=128, k_blocks=6, sort_cell=10.0)


@pytest.fixture(scope="module")
def scene():
    """One seeded scene as port tensors (``.t``) and ``ltm`` arrays (``.j``)."""
    rng = np.random.default_rng(7)
    n = 6000
    xyz = rng.uniform([-60, -15, -2], [60, 15, 4], (n, 3)).astype(np.float32)
    mask = rng.uniform(size=n) > 0.1
    poses = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    poses[:, :3, 3] = np.stack([np.linspace(-40, 40, K), rng.uniform(-2, 2, K),
                                np.full(K, 1.5)], 1)
    pinv = poses.copy()
    pinv[:, :3, 3] *= -1
    # each scan sees map points nudged along their rays: nearer and farther
    scans = np.stack([(xyz[rng.choice(n, 1500)] - poses[k, :3, 3])
                      * rng.uniform(0.95, 1.05, (1500, 1)) for k in range(K)]).astype(np.float32)
    smask = rng.uniform(size=scans.shape[:2]) > 0.05
    shifted = (xyz + rng.normal(0, 0.4, xyz.shape)).astype(np.float32)
    tmask = mask & (rng.uniform(size=n) < 0.5)
    q = shifted[:2900]
    qm = rng.uniform(size=2900) > 0.05
    arrays = dict(xyz=xyz, mask=mask, poses=poses, pinv=pinv, scans=scans, smask=smask,
                  shifted=shifted, tmask=tmask, q=q, qm=qm)

    t = SimpleNamespace(**{k: torch.from_numpy(v) for k, v in arrays.items()})
    j = SimpleNamespace(**{k: jnp.asarray(v) for k, v in arrays.items()})
    for ns, build in ((t, lambda x, m, c, b, cap: tb.build_block_map(
            torch.from_numpy(x), torch.from_numpy(m), c, b, cap)),
                      (j, lambda x, m, c, b, cap: jb.build_block_map(
            jnp.asarray(x), jnp.asarray(m), c, b, cap))):
        ns.bm, ov = build(xyz, mask, 10.0, 256, 32)
        ns.tbm, ov2 = build(shifted, tmask, 10.0, 256, 32)
        ns.kbm, ov3 = build(xyz, mask, 4.0, 1024, 16)
        assert int(ov) == int(ov2) == int(ov3) == 0
    extra = rng.uniform(size=256 * 32) > 0.3
    kextra = rng.uniform(size=1024 * 16) > 0.2
    t.extra, j.extra = torch.from_numpy(extra), jnp.asarray(extra)
    t.kextra, j.kextra = torch.from_numpy(kextra), jnp.asarray(kextra)
    t.tflat, j.tflat = t.tbm.mask.reshape(-1), j.tbm.mask.reshape(-1)
    kb = tb.required_k_blocks(t.bm, poses[:, :3, 3], RANGE)
    assert kb < 256                      # the range gate selects
    # the images the strong/weak sweeps read: the map's projected scans
    t.imgs = tp.projected_scan_images(t.xyz, t.mask, t.pinv, FOV, SHAPE, PROJ)
    j.imgs = jnp.asarray(t.imgs.numpy())
    return SimpleNamespace(t=t, j=j, kb=kb)


def _block_kw(s, **kw):
    return dict(k_blocks=s.kb, max_range=RANGE, **kw)


# name -> (sharded, port one-device, ltm one-device, positional args of a
# namespace, keyword args of the scene)
CASES = {
    "block_sweep_discrepancy": (
        tdr.block_sweep_discrepancy_sharded, tb.block_sweep_discrepancy,
        jb.block_sweep_discrepancy,
        lambda n: (n.bm, n.scans, n.smask, n.pinv, n.poses, FOV, SHAPE),
        lambda s: _block_kw(s, diff_threshold=0.1, reverse=False)),
    "block_sweep_visibility": (
        tdr.block_sweep_visibility_sharded, tb.block_sweep_visibility, jb.block_sweep_visibility,
        lambda n: (n.bm, n.extra, n.pinv, n.poses, FOV, PROJ), _block_kw),
    "block_projected_scan_images": (
        tdr.block_projected_scan_images_sharded, tb.block_projected_scan_images,
        jb.block_projected_scan_images,
        lambda n: (n.bm, n.extra, n.pinv, n.poses, FOV, SHAPE, PROJ), _block_kw),
    "block_fused_visibility_images": (
        tdr.block_fused_visibility_images_sharded, tb.block_fused_visibility_images,
        jb.block_fused_visibility_images,
        lambda n: (n.bm, n.extra, n.pinv, n.poses, FOV, SHAPE, PROJ),
        lambda s: _block_kw(s, scale=SCALE)),
    "block_sweep_discrepancy_vs_images": (
        tdr.block_sweep_discrepancy_vs_images_sharded, tb.block_sweep_discrepancy_vs_images,
        jb.block_sweep_discrepancy_vs_images,
        lambda n: (n.tbm, n.tflat, n.imgs, n.pinv, n.poses, FOV, SHAPE),
        lambda s: _block_kw(s, diff_threshold=0.1, reverse=True)),
    "sweep_visibility": (
        tdr.sweep_visibility_sharded, tp.sweep_visibility, jp.sweep_visibility,
        lambda n: (n.xyz, n.mask, n.pinv, FOV, PROJ), lambda s: {}),
    "projected_scan_images": (
        tdr.projected_scan_images_sharded, tp.projected_scan_images, jp.projected_scan_images,
        lambda n: (n.xyz, n.mask, n.pinv, FOV, SHAPE, PROJ), lambda s: {}),
    "fused_visibility_images": (
        tdr.fused_visibility_images_sharded, tp.fused_visibility_images,
        jp.fused_visibility_images,
        lambda n: (n.xyz, n.mask, n.pinv, FOV, SHAPE, PROJ), lambda s: dict(scale=SCALE)),
    "sweep_discrepancy_vs_images": (
        tdr.sweep_discrepancy_vs_images_sharded, tp.sweep_discrepancy_vs_images,
        jp.sweep_discrepancy_vs_images,
        lambda n: (n.shifted, n.tmask, n.imgs, n.pinv, FOV, SHAPE),
        lambda s: dict(diff_threshold=0.1, reverse=True)),
    "chunk_knn_sqdists": (
        tdr.chunk_knn_sqdists_sharded, tck.chunk_knn_sqdists, jck.chunk_knn_sqdists,
        lambda n: (n.q, n.qm, n.kbm, n.kextra), lambda s: CHUNK_KW),
    "sweep_discrepancy": (
        tds.sweep_discrepancy_sharded, tp.sweep_discrepancy, jp.sweep_discrepancy,
        lambda n: (n.xyz, n.mask, n.scans, n.smask, n.pinv, FOV, SHAPE),
        lambda s: dict(diff_threshold=0.1, reverse=False)),
    "sweep_discrepancy_map": (
        tds.sweep_discrepancy_map_sharded, tp.sweep_discrepancy, jp.sweep_discrepancy,
        lambda n: (n.xyz, n.mask, n.scans, n.smask, n.pinv, FOV, SHAPE),
        lambda s: dict(diff_threshold=0.1, reverse=True)),
    "knn_avg_sqdist": (
        tds.knn_avg_sqdist_sharded, tknn.knn_avg_sqdist, jax.jit(jknn.knn_avg_sqdist),
        lambda n: (n.shifted, n.tmask, n.xyz, n.mask), lambda s: {}),
}


def _outputs(out):
    """The tensors of a result, floats as their bits (NaN rows compare)."""
    outs = list(out) if isinstance(out, tuple) else [out]
    return [o.view(torch.int32) if o.dtype == torch.float32 else o for o in outs]


@pytest.fixture(scope="module")
def one_device(scene):
    """The port's one-device result of every case."""
    return {name: c[1](*c[3](scene.t), **c[4](scene)) for name, c in CASES.items()}


@pytest.mark.parametrize("slots", [1, 3, 8])
@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_equals_one_device(scene, one_device, name, slots):
    sharded, _, _, args, kw = CASES[name]
    got = sharded(make_mesh(["cpu"] * slots), *args(scene.t), **kw(scene))
    want = one_device[name]
    for g, w in zip(_outputs(got), _outputs(want), strict=True):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.equal(g, w)
    # not vacuous: every mask flags points, every image has pixels
    for w in _outputs(want):
        if w.dtype == torch.bool:
            assert 0 < int(w.sum()) < w.numel()


def _assert_chunk_rows(got, ref):
    """tests/test_torch_chunk_knn.py's rule: overflow and order equal, the
    rows of chunks that did not overflow bit-equal, NaN for the valid
    queries of overflowed ones."""
    over, order = np.asarray(ref.chunk_overflow), np.asarray(ref.order)
    np.testing.assert_array_equal(got.chunk_overflow.numpy(), over)
    np.testing.assert_array_equal(got.order.numpy(), order)
    chunk = CHUNK_KW["chunk"]
    n = len(order)
    rows = order[np.flatnonzero(np.repeat(over == 0, chunk)[:n])]
    np.testing.assert_array_equal(got.sqdists.numpy()[rows].view(np.int32),
                                  np.asarray(ref.sqdists)[rows].view(np.int32))
    bad = np.setdiff1d(order, rows)
    assert 0 < (over > 0).sum() < over.size and bad.size
    assert np.all(np.isnan(got.sqdists.numpy()[bad][got.sqdists.numpy()[bad] < 1e29]))


@pytest.fixture(scope="module")
def ltm_one_device(scene):
    """``ltm``'s jitted one-device result of every case."""
    return {name: c[2](*c[3](scene.j), **c[4](scene)) for name, c in CASES.items()}


@pytest.mark.parametrize("slots", [1, 3, 8])
@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_matches_ltm(scene, ltm_one_device, name, slots):
    sharded, _, _, args, kw = CASES[name]
    got = sharded(make_mesh(["cpu"] * slots), *args(scene.t), **kw(scene))
    ref = ltm_one_device[name]
    if name == "chunk_knn_sqdists":
        return _assert_chunk_rows(got, ref)
    if name == "knn_avg_sqdist":
        a, b = got.numpy(), np.asarray(ref)
        assert np.all(np.abs(a - b) <= 2 * np.spacing(np.maximum(np.abs(a), np.abs(b))))
        return
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for g, r in zip(got, ref, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.fixture(scope="module")
def ltm_mesh(cpu_devices):
    return jmesh.make_mesh(cpu_devices)


def test_block_sweep_matches_ltm_sharded(scene, ltm_mesh):
    """``ltm``'s sharded sweep on 8 virtual devices pads 5 keyframes with 3
    far poses; the port's on 8 slots gives its bits."""
    args, kw = CASES["block_sweep_discrepancy"][3], CASES["block_sweep_discrepancy"][4](scene)
    ref = jdr.block_sweep_discrepancy_sharded(ltm_mesh, *args(scene.j), **kw)
    got = tdr.block_sweep_discrepancy_sharded(make_mesh(["cpu"] * 8), *args(scene.t), **kw)
    assert int(np.asarray(ref).sum()) > 0
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_chunk_knn_matches_ltm_sharded(scene, ltm_mesh):
    """``ltm``'s chunk-sharded kNN pads 23 chunks to 24 all-invalid ones;
    the port's on 8 slots keeps its overflow rows, order and bits."""
    args = CASES["chunk_knn_sqdists"][3]
    ref = jdr.chunk_knn_sqdists_sharded(ltm_mesh, *args(scene.j), **CHUNK_KW)
    got = tdr.chunk_knn_sqdists_sharded(make_mesh(["cpu"] * 8), *args(scene.t), **CHUNK_KW)
    assert got.chunk_overflow.shape[0] == 23
    _assert_chunk_rows(got, ref)


def test_padding_contributes_nothing(scene):
    """A far pose selects no block, and a shard of padded keyframes adds
    nothing: the pure-padding shards of an 8-slot mesh give all-False
    masks and ``NO_POINT`` images."""
    t = scene.t
    pinv, poses = tdr._pad_poses_far(t.pinv, t.poses, 8)
    far = dict(k_blocks=scene.kb, max_range=RANGE)
    pad_scans = t.scans.new_zeros((3,) + t.scans.shape[1:])
    out = tb.block_sweep_discrepancy(t.bm, pad_scans, torch.zeros(pad_scans.shape[:2], dtype=bool),
                                     pinv[K:], poses[K:], FOV, SHAPE, **far)
    assert not out.any()
    win, imgs = tb.block_fused_visibility_images(t.bm, t.extra, pinv[K:], poses[K:], FOV, SHAPE,
                                                 PROJ, scale=SCALE, **far)
    assert not win.any() and bool((imgs == tp.NO_POINT).all())
    shards = tds.kf_valid_shards(make_mesh(["cpu"] * 8), K)
    assert [(ks.start, ks.stop) for _, ks in shards] == [(0, 1), (1, 2), (2, 3), (3, 4),
                                                          (4, 5), (5, 5), (6, 6), (7, 7)]
    shards = tds.kf_valid_shards(make_mesh(["cpu"] * 3), K)
    assert [(ks.start, ks.stop) for _, ks in shards] == [(0, 2), (2, 4), (4, 5)]
