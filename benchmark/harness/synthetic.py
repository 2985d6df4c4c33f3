"""Survey generators of the benchmark's traffic: a frozen copy.

Source: ``ltm_torch/io/synthetic.py`` at commit 15258b49d6b0 (``_box_points``,
``make_world``, ``_yaw_pose``, ``loop_trajectory``, ``make_session``,
``make_two_sessions``), pure NumPy.  The changes: ``make_session`` returns a
plain :class:`Session` (arrays only) instead of the program's
``SessionData``, so this file imports nothing of the program (the driver
hands the arrays to the program); its intra-session loop closures are found
by one vectorised test instead of a Python loop over pairs, in the same
order; ``make_two_sessions`` passes ``world`` (``make_world``'s keywords,
such as its point spacing) on.  Without ``world`` the same seed gives the
same arrays as the source.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

SENSOR_HEIGHT = 2.0


def _box_points(center, size, rng, density=24.0, yaw=0.0):
    """Sample points on the 4 side faces + top of an axis-aligned box."""
    cx, cy, cz = center
    sx, sy, sz = size
    pts = []
    for axis, sign in ((0, +1), (0, -1), (1, +1), (1, -1), (2, +1)):
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

    static_xyz: np.ndarray
    car_xyz: List[np.ndarray]
    car_slots: np.ndarray
    extent: float

    def session_points(self, car_ids: Sequence[int]):
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
    xs = np.arange(-L / 2, L / 2, ground_step)
    gx, gy = np.meshgrid(xs, xs)
    ground = np.stack([gx.ravel(), gy.ravel(), np.zeros(gx.size)], axis=-1)

    line = np.arange(-L / 2, L / 2, wall_step)
    wall_specs = [
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

    pillar_specs = [
        ((-L * 0.33, -L * 0.17), (1.0, 1.0, 4.0)),
        ((L * 0.08, -L * 0.37), (2.5, 1.2, 5.5)),
        ((L * 0.30, L * 0.05), (1.2, 3.0, 3.0)),
        ((-L * 0.13, L * 0.23), (1.0, 1.0, 6.5)),
        ((L * 0.20, L * 0.33), (4.0, 2.0, 2.5)),
        ((-L * 0.38, L * 0.36), (2.0, 2.0, 8.0)),
    ]
    pillars = [_box_points((px, py, 0.0), size, rng, density=24.0)
               for (px, py), size in pillar_specs]
    static = np.concatenate([ground, walls] + pillars)

    slot_x = np.linspace(-L / 2 + 6, L / 2 - 6, max(2, num_cars // 2))
    slots = np.asarray([(x, y) for y in (-L / 2 + 5.0, L / 2 - 5.0) for x in slot_x][:num_cars])
    cars = []
    for i in range(num_cars):
        yaw = rng.uniform(0, np.pi)
        cars.append(_box_points((slots[i, 0], slots[i, 1], 0.0), (4.2, 1.9, 1.6), rng,
                                density=18.0, yaw=yaw))
    return ParkingLotWorld(static_xyz=static, car_xyz=cars, car_slots=slots, extent=extent)


def _yaw_pose(x, y, z, yaw):
    c, s = np.cos(yaw), np.sin(yaw)
    T = np.eye(4)
    T[:3, :3] = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    T[:3, 3] = [x, y, z]
    return T


def loop_trajectory(num_keyframes: int, extent: float, phase: float = 0.0,
                    radius_frac: float = 0.3) -> np.ndarray:
    """Off-center elliptic loop; poses (K, 4, 4) in the site frame."""
    rx = extent * radius_frac
    ry = extent * radius_frac * 0.72
    cx, cy = extent * 0.06, -extent * 0.09
    th = np.linspace(0, 2 * np.pi, num_keyframes, endpoint=False) + phase
    poses = []
    for t in th:
        x, y = cx + rx * np.cos(t), cy + ry * np.sin(t)
        dx, dy = -rx * np.sin(t), ry * np.cos(t)
        poses.append(_yaw_pose(x, y, SENSOR_HEIGHT, np.arctan2(dy, dx)))
    return np.stack(poses)


@dataclass
class Session:
    """A generated session: what the program is given (``name``,
    ``node_ids``, ``poses``, ``edges``, ``scans``) and its ground truth."""

    name: str
    node_ids: np.ndarray
    poses: np.ndarray                      # odometry-integrated local poses (N, 4, 4)
    edges: tuple                           # (from (E,), to (E,), rel (E, 4, 4))
    scans: List[np.ndarray]                # each (M_i, 4) xyzi float32, local frame
    site_poses: np.ndarray                 # ground-truth poses in the site frame
    anchor: np.ndarray                     # ground-truth site_from_local (4, 4)


def make_session(world: ParkingLotWorld, name: str, car_ids: Sequence[int],
                 num_keyframes: int = 40, seed: int = 1,
                 anchor: Optional[np.ndarray] = None,
                 scan_range: float = 45.0, max_scan_points: int = 12000,
                 odom_noise: float = 0.004, point_noise: float = 0.02,
                 loop_closure_radius: float = 6.0, traj_phase: float = 0.0,
                 with_mover: bool = True) -> Session:
    rng = np.random.default_rng(seed)
    anchor = np.eye(4) if anchor is None else np.asarray(anchor, float)
    anchor_inv = np.linalg.inv(anchor)

    site_poses = loop_trajectory(num_keyframes, world.extent, phase=traj_phase)
    world_pts, _ = world.session_points(car_ids)

    scans: List[np.ndarray] = []
    for k in range(num_keyframes):
        T = site_poses[k]
        Tinv = np.linalg.inv(T)
        d2 = np.sum((world_pts[:, :2] - T[:2, 3]) ** 2, axis=-1)
        sel = np.flatnonzero(d2 < scan_range**2)
        if len(sel) > max_scan_points:
            sel = rng.choice(sel, size=max_scan_points, replace=False)
        pts = world_pts[sel]
        if with_mover:
            ang = 2 * np.pi * k / num_keyframes + 0.7
            mx = 0.55 * world.extent * 0.3 * np.cos(ang)
            my = 0.55 * world.extent * 0.3 * np.sin(ang)
            mover = _box_points((mx, my, 0.0), (3.5, 1.8, 1.7), rng, density=18.0)
            md2 = np.sum((mover[:, :2] - T[:2, 3]) ** 2, axis=-1)
            pts = np.concatenate([pts, mover[md2 < scan_range**2]])
        local = pts @ Tinv[:3, :3].T + Tinv[:3, 3]
        local = local + rng.normal(scale=point_noise, size=local.shape)
        scans.append(np.concatenate([local, np.zeros((len(local), 1))], -1).astype(np.float32))

    local_gt = np.einsum("ij,kjl->kil", anchor_inv, site_poses)
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
    # the source's loop over (i, j >= i + 8), vectorised in the same order
    pos = site_poses[:, :3, 3]
    d = np.linalg.norm(pos[:, None, :] - pos[None, :, :], axis=-1)
    ii, jj = np.nonzero(np.triu(d < loop_closure_radius, k=8))
    inv_local = np.linalg.inv(local_gt)
    edges_from += ii.tolist()
    edges_to += jj.tolist()
    edges_rel += list(inv_local[ii] @ local_gt[jj])

    return Session(
        name=name, node_ids=np.arange(num_keyframes, dtype=np.int32),
        poses=np.stack(node_poses),
        edges=(np.asarray(edges_from, np.int32), np.asarray(edges_to, np.int32),
               np.stack(edges_rel) if edges_rel else np.zeros((0, 4, 4))),
        scans=scans, site_poses=site_poses, anchor=anchor)


def make_two_sessions(seed: int = 0, num_keyframes: int = 40, num_cars: int = 12,
                      num_changed: int = 4, world: Optional[Dict] = None, **kw) -> Dict:
    """Central + query sessions over one ParkingLot world; the last
    ``num_changed`` cars split between central-only and query-only."""
    world = make_world(seed=seed, num_cars=num_cars, **(world or {}))
    shared = list(range(num_cars - num_changed))
    half = num_changed // 2
    nd_only = list(range(num_cars - num_changed, num_cars - num_changed + half))
    pd_only = list(range(num_cars - num_changed + half, num_cars))
    anchor_q = _yaw_pose(6.0, -4.0, 0.0, 0.35)
    central = make_session(world, "01", shared + nd_only, num_keyframes=num_keyframes,
                           seed=seed + 1, traj_phase=0.0, **kw)
    query = make_session(world, "02", shared + pd_only, num_keyframes=num_keyframes,
                         seed=seed + 2, anchor=anchor_q, traj_phase=0.4, **kw)
    return {"central": central, "query": query}
