"""LT-removert's opt-in configurations in the port, on the CPU, on the
4 kf x 6000 point fixture of tests/test_torch_removert.py:

  * ``use_occlusion_culling``: exact by construction, so the 14 masks equal
    the unculled port run's bit for bit;
  * ``use_self_removert`` and ``device_scan_prep``: the 14 sets equal
    ``ltm``'s run with the same flag under the module rule of
    test_torch_removert.py (symmetric difference ≤ max(2, 1e-4·|set|) at
    1e-4 m);
  * ``use_grid_knn`` (slow: the clamped grid scores every query of a cell
    against 27 padded cells, ~300 s at one thread here): the 14 masks equal
    the brute-force port run's;
  * on a mesh ``use_occlusion_culling`` leaves the culled branches and
    takes the sharded ones, as ``ltm`` does, with the same 14 masks; LT-SLAM's
    mesh still raises.
"""

import dataclasses

import pytest
import torch

from ltm.io.synthetic import make_two_sessions
from ltm.removert import Removerter, RemovertInput
from ltm_torch.removert import Removerter as TRemoverter
from ltm_torch.removert import RemovertInput as TRemovertInput
from ltm_torch.removert.convert import config_from_dict
from ltm_torch.removert.pipeline import MASK_NAMES
from test_torch_removert import _small_cfg, set_difference

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def bundle():
    return make_two_sessions(num_keyframes=4, num_cars=6, num_changed=2,
                             max_scan_points=6000, scan_range=70.0, seed=11, point_noise=0.01)


def _run(cls, bundle, cfg, **kw):
    def inp(syn):
        return cls[1](scans=[s for s in syn.data.scans], poses=syn.site_poses)

    rm = cls[0](cfg, **kw)
    return rm, rm.run(inp(bundle["central"]), inp(bundle["query"]))


PORT = (TRemoverter, TRemovertInput)
LTM = (Removerter, RemovertInput)


def _port(bundle, **flags):
    cfg = config_from_dict(dataclasses.asdict(_small_cfg()))
    return _run(PORT, bundle, dataclasses.replace(cfg, **flags), device="cpu")


@pytest.fixture(scope="module")
def default_port(bundle):
    return _port(bundle)[1]


@pytest.fixture(scope="module")
def culled_port(bundle):
    return _port(bundle, use_occlusion_culling=True)


def _assert_masks_equal(a, b):
    for name in MASK_NAMES:
        assert torch.equal(a.masks[name], b.masks[name]), name


def test_occlusion_culled_masks_equal_unculled(culled_port, default_port):
    rm, culled = culled_port
    _assert_masks_equal(culled, default_port)
    sweeps = {st["sweep"].split()[0] for st in rm.occlusion_stats}
    assert {"fwd", "project_static", "ND", "PD"} <= sweeps, sweeps
    fwd = [st for st in rm.occlusion_stats if st["sweep"].startswith("fwd")]
    assert all(max(st["survivors"]) < st["blocks"] for st in fwd)   # the cull cut blocks


@pytest.mark.parametrize("flag", ["use_self_removert", "device_scan_prep"])
def test_optin_sets_match_ltm(bundle, flag):
    cfg = _small_cfg()
    setattr(cfg, flag, True)
    _, ref = _run(LTM, bundle, cfg)
    _, port = _port(bundle, **{flag: True})
    for name in MASK_NAMES:
        a, b = ref.points(name), port.points(name)
        diff = set_difference(a, b)
        print(f"{flag} {name}: ltm {len(a)} port {len(b)} symmetric difference {diff}")
        assert len(a) > 0
        assert diff <= max(2, 1e-4 * len(a)), (name, len(a), len(b), diff)


def test_self_removert_snapshots_and_revert_resolution(bundle, default_port):
    """The remove → revert → remove loop keeps the per-resolution
    snapshots, and a second iteration and an explicit revert resolution
    run through it; the static set differs from the single removal's."""
    rm, one = _port(bundle, use_self_removert=True, repeat_removert_iter=2,
                    revert_resolution_list=[2.0])
    res = _small_cfg().remove_resolution_list[0]
    for sess in (one.central, one.query):
        assert torch.equal(sess.masks[f"static@{res}"], sess.masks["static"])
        assert not (sess.masks["static"] & sess.masks["dynamic"]).any()
        assert torch.equal(sess.masks["static"] | sess.masks["dynamic"], sess.map_mask)
    assert not torch.equal(one.masks["static_c"], default_port.masks["static_c"])


@pytest.mark.slow
def test_grid_knn_masks_equal_brute(bundle, default_port):
    _, grid = _port(bundle, use_grid_knn=True, grid_n_cells=1 << 14, grid_cell_capacity=256)
    _assert_masks_equal(grid, default_port)


def test_mesh_still_raises(bundle, culled_port):
    """``mesh_devices`` no longer raises in ``LTSlam`` either: it takes a
    mesh of 2 CPU slots (its mesh path: tests/test_torch_slam_mesh.py).
    LT-removert with ``use_occlusion_culling`` on 3 CPU slots (3 pads the
    keyframe and map axes) leaves the culled branches, as ``ltm`` does: no
    sweep is culled, the sharded forward, project-static and strong/weak
    sweeps run, and the 14 masks equal the one-device culled run's."""
    from ltm_torch.core.config import LTSlamConfig
    from ltm_torch.slam import LTSlam

    assert LTSlam(LTSlamConfig(mesh_devices=2), device="cpu").mesh.size == 2
    rm, on_mesh = _port(bundle, use_occlusion_culling=True, mesh_devices=3)
    assert rm.mesh.size == 3
    assert rm.occlusion_stats == []
    _assert_masks_equal(on_mesh, culled_port[1])
