"""Synthetic survey generators (the port's copies, pure NumPy, so
``chip_smoke.py`` makes its data without ``ltm``; the same seed gives the
same sessions as the JAX package's generators).

  * ``synth_session``: the corridor survey of the LT-removert pipeline
    workload (``tools/e2e_bench.synth_session`` with its default mix);
  * ``make_world`` / ``make_session`` / ``make_two_sessions`` /
    ``make_n_sessions``: the "ParkingLot" scene of ``ltm.io.synthetic`` —
    a static world with walls and pillars, parked cars present in subsets
    per session (the low-dynamic ground truth), a mover a keyframe (the
    high-dynamic ground truth), loop trajectories with noisy odometry and
    intra-session loop closures, and a per-session rigid offset (the
    anchor-node ground truth).  Point labels: 0 static, 1..N_car car id,
    1000+k the mover at keyframe k.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from ltm_torch.io.sessions import SessionData

__all__ = ["synth_session", "ParkingLotWorld", "SyntheticSession", "make_world",
           "make_session", "make_two_sessions", "make_n_sessions"]

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


MOVER_LABEL_BASE = 1000
SENSOR_HEIGHT = 2.0


def _box_points(center, size, rng, density=24.0, yaw=0.0):
    """Sample points on the 4 side faces + top of an axis-aligned box."""
    cx, cy, cz = center
    sx, sy, sz = size
    pts = []
    faces = [
        # (normal axis, sign)
        (0, +1), (0, -1), (1, +1), (1, -1), (2, +1),
    ]
    for axis, sign in faces:
        dims = [sx, sy, sz]
        area = (dims[(axis + 1) % 3]) * (dims[(axis + 2) % 3])
        n = max(4, int(area * density))
        u = rng.uniform(-0.5, 0.5, size=(n,))
        v = rng.uniform(-0.5, 0.5, size=(n,))
        p = np.zeros((n, 3))
        p[:, axis] = 0.5 * sign
        p[:, (axis + 1) % 3] = u
        p[:, (axis + 2) % 3] = v
        p *= np.array([sx, sy, sz])
        pts.append(p)
    p = np.concatenate(pts)
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    return p @ R.T + np.array([cx, cy, cz + sz / 2])


@dataclass
class ParkingLotWorld:
    """Static structure + car geometry in the site (central) frame."""

    static_xyz: np.ndarray                 # (Ns, 3)
    car_xyz: List[np.ndarray]              # per-car point sets
    car_slots: np.ndarray                  # (C, 2) slot centers
    extent: float

    def session_points(self, car_ids: Sequence[int]):
        """World points + labels for a session with the given cars present."""
        pts = [self.static_xyz]
        labels = [np.zeros(len(self.static_xyz), np.int32)]
        for cid in car_ids:
            pts.append(self.car_xyz[cid])
            labels.append(np.full(len(self.car_xyz[cid]), cid + 1, np.int32))
        return np.concatenate(pts), np.concatenate(labels)


def make_world(seed: int = 0, extent: float = 60.0, num_cars: int = 12,
               ground_step: float = 0.6, wall_step: float = 0.45) -> ParkingLotWorld:
    rng = np.random.default_rng(seed)
    L = extent

    # ground grid
    xs = np.arange(-L / 2, L / 2, ground_step)
    gx, gy = np.meshgrid(xs, xs)
    ground = np.stack([gx.ravel(), gy.ravel(), np.zeros(gx.size)], axis=-1)

    # boundary walls — deliberately ASYMMETRIC (different heights per side,
    # a notch in one wall) so place recognition cannot alias rotated views
    line = np.arange(-L / 2, L / 2, wall_step)
    wall_specs = [
        # (fixed axis, fixed value, height, notch interval or None)
        (1, -L / 2, 2.5, None),
        (1, L / 2, 4.5, (-L / 8, L / 8)),
        (0, -L / 2, 3.5, None),
        (0, L / 2, 2.0, (L / 4 - 5, L / 4 + 5)),
    ]
    walls = []
    for axis, val, height, notch in wall_specs:
        for z in np.arange(0.0, height, wall_step):
            keep = np.ones_like(line, bool)
            if notch is not None and z > 0.8:
                keep = (line < notch[0]) | (line > notch[1])
            seg = line[keep]
            if axis == 1:
                walls.append(np.stack([seg, np.full_like(seg, val), np.full_like(seg, z)], -1))
            else:
                walls.append(np.stack([np.full_like(seg, val), seg, np.full_like(seg, z)], -1))
    walls = np.concatenate(walls)

    # pillars / small buildings at IRREGULAR positions and sizes
    pillars = []
    pillar_specs = [
        ((-L * 0.33, -L * 0.17), (1.0, 1.0, 4.0)),
        ((L * 0.08, -L * 0.37), (2.5, 1.2, 5.5)),
        ((L * 0.30, L * 0.05), (1.2, 3.0, 3.0)),
        ((-L * 0.13, L * 0.23), (1.0, 1.0, 6.5)),
        ((L * 0.20, L * 0.33), (4.0, 2.0, 2.5)),
        ((-L * 0.38, L * 0.36), (2.0, 2.0, 8.0)),
    ]
    for (px, py), size in pillar_specs:
        pillars.append(_box_points((px, py, 0.0), size, rng, density=24.0))
    static = np.concatenate([ground, walls] + pillars)

    # parking slots along two rows
    slot_x = np.linspace(-L / 2 + 6, L / 2 - 6, max(2, num_cars // 2))
    slots = []
    for y in (-L / 2 + 5.0, L / 2 - 5.0):
        for x in slot_x:
            slots.append((x, y))
    slots = np.asarray(slots[:num_cars])

    cars = []
    for i in range(num_cars):
        yaw = rng.uniform(0, np.pi)
        cars.append(_box_points((slots[i, 0], slots[i, 1], 0.0), (4.2, 1.9, 1.6), rng, density=18.0, yaw=yaw))

    return ParkingLotWorld(static_xyz=static, car_xyz=cars, car_slots=slots, extent=extent)


def _yaw_pose(x, y, z, yaw):
    c, s = np.cos(yaw), np.sin(yaw)
    T = np.eye(4)
    T[:3, :3] = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    T[:3, 3] = [x, y, z]
    return T


def loop_trajectory(num_keyframes: int, extent: float, phase: float = 0.0,
                    radius_frac: float = 0.3) -> np.ndarray:
    """Off-center elliptic loop; poses (K, 4, 4) in the site frame.

    The center offset + ellipse break the rotational symmetry of the path so
    opposite sides of the loop produce genuinely different scans.
    """
    rx = extent * radius_frac
    ry = extent * radius_frac * 0.72
    cx, cy = extent * 0.06, -extent * 0.09
    th = np.linspace(0, 2 * np.pi, num_keyframes, endpoint=False) + phase
    poses = []
    for t in th:
        x, y = cx + rx * np.cos(t), cy + ry * np.sin(t)
        dx, dy = -rx * np.sin(t), ry * np.cos(t)
        yaw = np.arctan2(dy, dx)  # tangent heading
        poses.append(_yaw_pose(x, y, SENSOR_HEIGHT, yaw))
    return np.stack(poses)


@dataclass
class SyntheticSession:
    """A generated session + its ground truth."""

    data: SessionData
    site_poses: np.ndarray                 # GT keyframe poses in site frame (K,4,4)
    anchor: np.ndarray                     # GT site_from_local transform (4,4)
    scan_labels: List[np.ndarray]          # per-scan point labels
    car_ids: List[int]


def make_session(world: ParkingLotWorld, name: str, car_ids: Sequence[int],
                 num_keyframes: int = 40, seed: int = 1,
                 anchor: Optional[np.ndarray] = None,
                 scan_range: float = 45.0, max_scan_points: int = 12000,
                 odom_noise: float = 0.004, point_noise: float = 0.02,
                 loop_closure_radius: float = 6.0, traj_phase: float = 0.0,
                 with_mover: bool = True) -> SyntheticSession:
    rng = np.random.default_rng(seed)
    anchor = np.eye(4) if anchor is None else np.asarray(anchor, float)
    anchor_inv = np.linalg.inv(anchor)

    site_poses = loop_trajectory(num_keyframes, world.extent, phase=traj_phase)
    world_pts, world_labels = world.session_points(car_ids)

    scans: List[np.ndarray] = []
    labels: List[np.ndarray] = []
    for k in range(num_keyframes):
        T = site_poses[k]
        Tinv = np.linalg.inv(T)
        d2 = np.sum((world_pts[:, :2] - T[:2, 3]) ** 2, axis=-1)
        sel = np.flatnonzero(d2 < scan_range**2)
        if len(sel) > max_scan_points:
            sel = rng.choice(sel, size=max_scan_points, replace=False)
        pts = world_pts[sel]
        lbl = world_labels[sel]

        if with_mover:
            # high-dynamic object: a box at a keyframe-dependent spot near the path
            ang = 2 * np.pi * k / num_keyframes + 0.7
            mx = 0.55 * world.extent * 0.3 * np.cos(ang)
            my = 0.55 * world.extent * 0.3 * np.sin(ang)
            mover = _box_points((mx, my, 0.0), (3.5, 1.8, 1.7), rng, density=18.0)
            md2 = np.sum((mover[:, :2] - T[:2, 3]) ** 2, axis=-1)
            mover = mover[md2 < scan_range**2]
            pts = np.concatenate([pts, mover])
            lbl = np.concatenate([lbl, np.full(len(mover), MOVER_LABEL_BASE + k, np.int32)])

        local = pts @ Tinv[:3, :3].T + Tinv[:3, 3]
        local = local + rng.normal(scale=point_noise, size=local.shape)
        xyzi = np.concatenate([local, np.zeros((len(local), 1))], -1).astype(np.float32)
        scans.append(xyzi)
        labels.append(lbl)

    # local-frame node poses (what the session's own SLAM would estimate)
    local_gt = np.einsum("ij,kjl->kil", anchor_inv, site_poses)

    # odometry integration with noise -> initial values drift slightly
    node_poses = [local_gt[0]]
    edges_from, edges_to, edges_rel = [], [], []
    for k in range(1, num_keyframes):
        rel = np.linalg.inv(local_gt[k - 1]) @ local_gt[k]
        noise = _yaw_pose(*rng.normal(scale=odom_noise, size=3), rng.normal(scale=odom_noise))
        rel_noisy = rel @ noise
        node_poses.append(node_poses[-1] @ rel_noisy)
        edges_from.append(k - 1)
        edges_to.append(k)
        edges_rel.append(rel_noisy)

    # intra-session loop closures on site-frame proximity
    for i in range(num_keyframes):
        for j in range(i + 8, num_keyframes):
            d = np.linalg.norm(site_poses[i][:3, 3] - site_poses[j][:3, 3])
            if d < loop_closure_radius:
                rel = np.linalg.inv(local_gt[i]) @ local_gt[j]
                edges_from.append(i)
                edges_to.append(j)
                edges_rel.append(rel)

    data = SessionData(
        name=name,
        node_ids=np.arange(num_keyframes, dtype=np.int32),
        poses=np.stack(node_poses),
        edges=(
            np.asarray(edges_from, np.int32),
            np.asarray(edges_to, np.int32),
            np.stack(edges_rel) if edges_rel else np.zeros((0, 4, 4)),
        ),
        scans=scans,
    )
    return SyntheticSession(
        data=data, site_poses=site_poses, anchor=anchor, scan_labels=labels, car_ids=list(car_ids)
    )


def make_n_sessions(n_sessions: int = 3, seed: int = 0, num_keyframes: int = 30,
                    num_cars: int = 12, **kw) -> Dict:
    """N sessions over one world: session i keeps a sliding window of cars
    (gradual change) and has its own anchor offset (session 0 = identity)."""
    world = make_world(seed=seed, num_cars=num_cars)
    rng = np.random.default_rng(seed + 100)
    sessions = []
    anchors = [np.eye(4)]
    for i in range(1, n_sessions):
        anchors.append(_yaw_pose(rng.uniform(-8, 8), rng.uniform(-8, 8), 0.0, rng.uniform(-0.5, 0.5)))
    per = max(num_cars - n_sessions + 1, 1)
    for i in range(n_sessions):
        car_ids = list(range(i, min(i + per, num_cars)))
        sessions.append(
            make_session(world, f"{i + 1:02d}", car_ids, num_keyframes=num_keyframes,
                         seed=seed + 1 + i, anchor=anchors[i], traj_phase=0.08 * i, **kw)
        )
    return {"world": world, "sessions": sessions, "anchors": anchors}


def make_two_sessions(seed: int = 0, num_keyframes: int = 40, num_cars: int = 12,
                      num_changed: int = 4, **kw) -> Dict:
    """Central + query sessions with PD/ND ground truth.

    Cars ``0..num_cars-num_changed`` exist in both; the last ``num_changed``
    split between central-only (ND: disappeared by query time) and query-only
    (PD: newly appeared).
    """
    world = make_world(seed=seed, num_cars=num_cars)
    shared = list(range(num_cars - num_changed))
    half = num_changed // 2
    nd_only = list(range(num_cars - num_changed, num_cars - num_changed + half))
    pd_only = list(range(num_cars - num_changed + half, num_cars))

    # query session's local frame is offset from the site frame (anchor GT)
    anchor_q = _yaw_pose(6.0, -4.0, 0.0, 0.35)

    central = make_session(world, "01", shared + nd_only, num_keyframes=num_keyframes,
                           seed=seed + 1, traj_phase=0.0, **kw)
    query = make_session(world, "02", shared + pd_only, num_keyframes=num_keyframes,
                         seed=seed + 2, anchor=anchor_q, traj_phase=0.4, **kw)
    return {
        "world": world,
        "central": central,
        "query": query,
        "nd_car_ids": nd_only,
        "pd_car_ids": pd_only,
        "anchor_query": anchor_q,
    }
