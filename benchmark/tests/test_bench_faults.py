"""A run with the timed path broken underneath comes out not correct: the
harness's look for a chip skipped (``run.run_cell`` on the CPU, at the
small size of ``conftest.small_cell``), each fault planted in the program
for the run and taken out after."""

import os
import time

import numpy as np
import pytest
import torch

import run
from conftest import ROOT, small_cell
from harness.cell import find_cell, load_json

SEED = 2 ** 33 + 5


def _run(name, cpu, seconds=0.5):
    return run.run_cell(small_cell(name), SEED, seconds, False, cpu, time.perf_counter())


def _unchanged_strong_weak(mp):
    """The strong/weak split returns its candidates unchanged."""
    from ltm_torch.removert.pipeline import Removerter

    mp.setattr(Removerter, "_filter_strong",
               lambda self, sess, cand, *a, **k: (cand, torch.zeros_like(cand)))


def _half_the_keyframes(mp):
    """Half of the central session's keyframes left out."""
    import ltm_torch.removert.pipeline as pipe

    parse = pipe.parse_keyframe_indices
    mp.setattr(pipe, "parse_keyframe_indices", lambda *a: parse(*a)[::2])


def _altered_updated_map(mp):
    """The updated map's answer altered where it is produced: a tenth of its
    points flipped."""
    import ltm_torch.removert.pipeline as pipe

    compose = pipe.compose_updated_maps

    def altered(*a, **k):
        xyz, updated, strong = compose(*a, **k)
        flip = torch.zeros_like(updated)
        flip[::10] = True
        return xyz, updated ^ flip, strong

    mp.setattr(pipe, "compose_updated_maps", altered)


@pytest.mark.parametrize("fault", [_unchanged_strong_weak, _half_the_keyframes,
                                   _altered_updated_map])
def test_removert_fault_is_not_correct(fault, cpu, monkeypatch):
    fault(monkeypatch)
    out = _run("removert.parkinglot", cpu)
    assert out["correct"] is False, out["checks"]


def test_removert_sound_run_is_correct(cpu):
    out = _run("removert.parkinglot", cpu)
    assert out["correct"] is True, out["checks"]


def _unchanged_solve(mp):
    """The solver returns the graph's state unchanged."""
    from ltm_torch.slam import LTSlam

    mp.setattr(LTSlam, "_optimize", lambda self: None)


def _altered_loop_poses(mp):
    """Each verified loop's relative pose altered where ICP produces it: 0.5 m
    along x."""
    from ltm_torch.slam import LTSlam

    farm = LTSlam._run_icp_batches

    def altered(self, *a, **k):
        out = []
        for T, fit, conv in farm(self, *a, **k):
            T = np.array(T)
            T[0, 3] += 0.5
            out.append((T, fit, conv))
        return out

    mp.setattr(LTSlam, "_run_icp_batches", altered)


@pytest.mark.parametrize("fault,number", [(_unchanged_solve, "ate_m"),
                                          (_altered_loop_poses, "ate_m")])
def test_slam_fault_is_not_correct(fault, number, cpu, monkeypatch):
    fault(monkeypatch)
    out = _run("slam.sc", cpu, seconds=0.1)
    assert out["correct"] is False, out["checks"]
    c = out["checks"][number]
    assert c["value"] > c["limit"], out["checks"]


@pytest.mark.card
def test_slam_unchanged_solve_at_the_cells_size(card, monkeypatch):
    """The upper reading of ``ate_m``: the solver returning its state
    unchanged, on the card at the cell's own size, on three seeds.  Run it
    with ``python -m pytest benchmark/tests/test_bench_faults.py -m card -s``
    (it prints each reading)."""
    _unchanged_solve(monkeypatch)
    for seed in (2 ** 33 + 111, 2 ** 34 + 222, 2 ** 35 + 333):
        cell = find_cell(load_json(os.path.join(ROOT, "BENCHMARK.json")), "slam.sc")
        d = cell.driver.Driver(cell, seed, card)
        d.job(0)
        checks, _ = d.checks()
        print(f"unchanged solve, slam.sc seed {seed}: "
              + ", ".join(f"{n} {v!r} (limit {lim!r})" for n, v, lim in checks))
        assert dict((n, v > lim) for n, v, lim in checks)["ate_m"], checks
