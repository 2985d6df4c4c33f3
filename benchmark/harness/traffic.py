"""The benchmark's traffic: a mix's file of parameters read by the general
code here and by its scene's generator, ``scenes/<scene>.py``, found by
name, which makes from the seed the sessions the jobs take.

A scene file defines ``sessions(mix, survey, seed)``: a list of bundles
{"central": Session, "query": Session} (``harness.synthetic.Session``),
at the configuration's ``survey`` shape (``keyframes_per_session``,
``scan_points``).
``frame`` (optional) moves each job's survey by a rigid transform of the
world frame: a yaw uniform over a turn and a translation uniform within
``±frame.translation_m`` in x and y, applied to the poses only.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

STREAM_SESSIONS, STREAM_FRAMES, STREAM_SAMPLE = 0, 1, 2


def rng(seed: int, stream: int, *more: int) -> np.random.Generator:
    """A generator of its own for each use of the seed (any whole number)."""
    return np.random.default_rng([int(seed) & (2 ** 64 - 1), stream, *more])


SURVEY = ("keyframes_per_session", "scan_points")


def sessions(cell, seed: int) -> List[Dict]:
    """The cell's bundles, made by its mix's scene file,
    ``scenes/<scene>.py``, at its configuration's survey shape."""
    from harness.cell import load_module

    scene = load_module(os.path.join(cell.bench_dir, "scenes", cell.traffic["scene"] + ".py"))
    return scene.sessions(cell.traffic, {k: cell.config[k] for k in SURVEY}, seed)


def job_frame(traffic: dict, seed: int, job: int) -> np.ndarray:
    """The job's rigid transform of the world frame (identity without
    ``frame``)."""
    T = np.eye(4)
    frame = traffic.get("frame")
    if frame:
        g = rng(seed, STREAM_FRAMES, job + 1)
        yaw = g.uniform(0.0, 2.0 * np.pi)
        c, s = np.cos(yaw), np.sin(yaw)
        T[:2, :2] = [[c, -s], [s, c]]
        T[:2, 3] = g.uniform(-frame["translation_m"], frame["translation_m"], 2)
    return T


def checked_job(traffic: dict, seed: int) -> int:
    """Index of the job whose answer is checked, drawn from the seed among
    the first ``check_among`` jobs (the last job of a shorter window)."""
    return int(rng(seed, STREAM_SAMPLE).integers(0, traffic.get("check_among", 1)))
