"""The port's ``Removerter.run`` on a mesh of 8 CPU slots
(``cfg.mesh_devices=8``) against its one-device run, on the fixture and
config of ``ltm``'s ``test_removert_mesh_matches_single``
(tests/test_dist_pipeline.py): the 14 named sets must be equal bit for
bit on the block path, the whole-map path, and the block path with the
chunked kNN forced (the fixture's maps sit below ``chunk_knn_min_targets``)
at a block budget that overflows, so chunks are escalated and
brute-forced on the mesh too.  On one card ``mesh_devices=8`` gives no
mesh in either driver, as ``ltm`` on one chip."""

import dataclasses

import pytest
import torch

from ltm.io.synthetic import make_two_sessions
from ltm_torch.core.config import LTSlamConfig, RemovertConfig
from ltm_torch.removert import Removerter, RemovertInput
from ltm_torch.removert.pipeline import MASK_NAMES
from ltm_torch.slam import LTSlam

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def slam_bundle():
    return make_two_sessions(num_keyframes=4, num_cars=4, num_changed=2,
                             max_scan_points=6000, scan_range=70.0, seed=0, point_noise=0.01)


def _removert_mesh_small_cfg(**kw):
    return RemovertConfig(scan_capacity=6144, downsample_voxel_size=0.1,
                          knn_avg_sqdist_threshold=0.04, save_high_dyn_maps=False, **kw)


@pytest.mark.parametrize("flags", [dict(use_block_map=True), dict(use_block_map=False),
                                   dict(use_block_map=True, chunk_knn_min_targets=0,
                                        chunk_knn_k_blocks=4)],
                         ids=["block", "flat", "block_chunk_knn"])
def test_removert_mesh_matches_single(slam_bundle, flags):
    def inp(syn):
        return RemovertInput(scans=[s for s in syn.data.scans], poses=syn.site_poses)

    c, q = inp(slam_bundle["central"]), inp(slam_bundle["query"])
    cfg = _removert_mesh_small_cfg(**flags)
    one = Removerter(cfg, device="cpu")
    assert one.mesh is None
    res_1 = one.run(c, q)
    rm = Removerter(dataclasses.replace(cfg, mesh_devices=8), device="cpu")
    assert rm.mesh is not None and rm.mesh.size == 8
    res_8 = rm.run(c, q)
    for name in MASK_NAMES:
        assert torch.equal(res_8.masks[name], res_1.masks[name]), name
    for name in ("nd", "pd", "updated"):
        assert int(res_1.masks[name].sum()) > 0, name
    if flags.get("chunk_knn_min_targets") == 0:
        # overflowed chunks were re-resolved, the same queries either way
        assert rm.chunk_knn_fallbacks and len(rm.chunk_knn_fallbacks) == len(one.chunk_knn_fallbacks)
        for a, b in zip(rm.chunk_knn_fallbacks, one.chunk_knn_fallbacks):
            assert (a["escalated"] == b["escalated"]).all() and (a["brute"] == b["brute"]).all()


def test_one_card_runs_the_one_device_path(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert Removerter(RemovertConfig(mesh_devices=8), device="cuda").mesh is None
    assert Removerter(RemovertConfig(mesh_devices=-1), device="cuda").mesh is None
    LTSlam(LTSlamConfig(mesh_devices=8), device="cuda")     # no NotImplementedError
