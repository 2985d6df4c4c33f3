"""Synthetic corridor survey for the pipeline workload (the port's copy of
``tools/e2e_bench.synth_session`` with its default mix, so ``chip_smoke.py``
can make its data without ``ltm``).  Pure NumPy from a caller-owned
``default_rng``: the same seed gives the same sessions as the JAX package's
benchmark."""

from __future__ import annotations

import numpy as np

__all__ = ["synth_session"]

_LATERAL = 45.0      # corridor half-width (m)
_CLUTTER_FRAC = 0.15


def synth_session(rng, n_kf, n_pts, traj=1200.0, phase=0.0):
    """Scans along a ``traj``-metre corridor: ground + walls + clutter in the
    LOCAL frame of each pose.  Returns ``(scans, poses)``: a list of
    (n_pts, 3) float32 arrays and (n_kf, 4, 4) float64 poses."""
    lateral = _LATERAL
    xs = np.linspace(60.0, traj - 60.0, n_kf)
    poses = np.tile(np.eye(4, dtype=np.float64), (n_kf, 1, 1))
    poses[:, 0, 3] = xs
    poses[:, 1, 3] = 4.0 * np.sin(xs / 90.0 + phase)

    scans = []
    for _ in range(n_kf):
        nc = int(n_pts * _CLUTTER_FRAC)
        ng = int(n_pts * 0.55)
        nw = n_pts - nc - ng
        g = np.stack([rng.uniform(-60, 60, ng), rng.uniform(-lateral, lateral, ng),
                      rng.normal(-1.6, 0.03, ng)], 1)
        side = rng.choice([-lateral, lateral], nw)
        w = np.stack([rng.uniform(-60, 60, nw), side + rng.normal(0, 0.05, nw),
                      rng.uniform(-1.5, 6.0, nw)], 1)
        c = np.stack([rng.uniform(-55, 55, nc), rng.uniform(-lateral, lateral, nc),
                      rng.uniform(-1.5, 2.0, nc)], 1)
        scans.append(np.concatenate([g, w, c]).astype(np.float32))
    return scans, poses
