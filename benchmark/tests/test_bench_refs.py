"""The references, at the small bundle's size (2 x 24 ParkingLot keyframes x
2 000 points), tell a correct answer from a perturbed one; the control (the
reference in bfloat16 in the program's place) comes out not correct."""

import numpy as np
import pytest
import torch

from conftest import small_cell
from harness import synthetic
from refs import removert_ref as rr
from refs import slam_ref as sr

SEED = 2 ** 32 + 17


@pytest.fixture(scope="module")
def bundle():
    return synthetic.make_two_sessions(seed=SEED, num_keyframes=24, max_scan_points=2000,
                                       scan_range=70.0, odom_noise=5e-4)


@pytest.fixture(scope="module")
def removert_case(bundle):
    cell = small_cell("removert.parkinglot")
    s = cell.config["settings"]
    c, q = bundle["central"], bundle["query"]
    c_idx, q_idx = rr.keyframe_indices(c.site_poses, q.site_poses, s)
    raw = [[torch.from_numpy(sess.scans[i][:, :3]).double() for i in idx]
           for sess, idx in ((c, c_idx), (q, q_idx))]
    kept = [rr.prep_reference(r, s) for r in raw]
    sets = rr.detector_reference(kept[0], c.site_poses[c_idx], kept[1], q.site_poses[q_idx], s)
    return cell, s, raw, kept, sets


def test_removert_reference_agrees_with_itself(removert_case):
    cell, s, raw, kept, sets = removert_case
    assert rr.prep_gap(kept[0] + kept[1], raw[0] + raw[1], s) == 0.0
    assert max(rr.set_gaps(sets, sets).values()) == 0.0
    assert all(len(sets[n]) for n in ("static_c", "nd", "pd", "updated"))


def test_removert_reference_finds_a_perturbed_answer(removert_case):
    cell, s, raw, kept, sets = removert_case
    lim = cell.config["limits"]
    moved = [k + 0.01 for k in kept[0]] + kept[1]
    assert rr.prep_gap(moved, raw[0] + raw[1], s) > lim["prep_gap"]
    for name in ("nd", "static_q", "updated"):
        bad = dict(sets)
        bad[name] = sets[name][::2]
        assert rr.set_gaps(bad, sets)[name] > lim["set_gap"]


def test_removert_control_is_not_correct(removert_case, bundle):
    """The reference in bfloat16 in the program's place: its prep and its
    sets both fail their limits."""
    cell, s, raw, kept, sets = removert_case
    lim = cell.config["limits"]
    low_kept = [rr.prep_reference([r.to(torch.bfloat16) for r in rs], s) for rs in raw]
    assert rr.prep_gap(low_kept[0] + low_kept[1], raw[0] + raw[1], s) > lim["prep_gap"]
    c, q = bundle["central"], bundle["query"]
    c_idx, q_idx = rr.keyframe_indices(c.site_poses, q.site_poses, s)
    low = rr.detector_reference(kept[0], c.site_poses[c_idx], kept[1], q.site_poses[q_idx], s,
                                dtype=torch.bfloat16)
    gaps = rr.set_gaps({n: v.double() for n, v in low.items()}, sets)
    assert max(gaps.values()) > lim["set_gap"]


def test_slam_control_is_not_correct(bundle):
    cell = small_cell("slam.sc")
    d = cell.driver.Driver.__new__(cell.driver.Driver)
    d.settings, d.limits, d.bundles = cell.config["settings"], cell.config["limits"], [bundle]
    checks, _ = d.control()
    assert any(v > lim for _, v, lim in checks), checks


def test_slam_reference_finds_perturbed_poses_and_loops(bundle):
    cell = small_cell("slam.sc")
    lim, sc = cell.config["limits"], cell.config["settings"]["scan_context"]
    c, q = bundle["central"], bundle["query"]
    truth = {"01": c.site_poses, "02": q.site_poses}
    assert sr.ate_rmse(truth, truth) == 0.0
    moved = {n: p.copy() for n, p in truth.items()}
    moved["02"][:, 0, 3] += 0.2
    assert sr.ate_rmse(moved, truth) > lim["ate_m"]
    rel = sr.relative_truth(c.site_poses[3], q.site_poses[5])
    assert np.allclose(c.site_poses[3] @ rel, q.site_poses[5])
    loops = sr.detect_loops(sr.scan_contexts(q.scans, sc), sr.scan_contexts(c.scans, sc), sc)
    assert (loops >= 0).any()


def test_slam_numbers_tell_a_correct_answer_from_a_perturbed_one(bundle, cpu):
    cell = small_cell("slam.sc")
    d = cell.driver.Driver.__new__(cell.driver.Driver)
    d.settings, d.limits, d.bundles = cell.config["settings"], cell.config["limits"], [bundle]
    ref = d.reference_loops()
    c, q = bundle["central"], bundle["query"]
    truth = {"01": c.site_poses, "02": q.site_poses}

    def answer(shift_target=0, dx=0.0):
        loops = [(int(t) + shift_target, s, sr.relative_truth(c.site_poses[t], q.site_poses[s])
                  + np.pad([[dx]], ((0, 3), (3, 0))))
                 for s, t in enumerate(ref[0]) if t >= 0]
        return {"bundle": 0, "poses": truth, "loops": loops, "n_sc": len(loops), "n_rs": 0,
                "sc_found": len(loops)}

    good, _ = d.numbers([answer()], ref)
    assert all(v == 0.0 for v in good.values()), good
    off, _ = d.numbers([answer(shift_target=1)], ref)
    assert off["sc_loop_off"] > d.limits["sc_loop_off"]
    _, info = d.numbers([answer(dx=0.5)], ref)
    assert info["loop_err_median_m"] > 0.4
