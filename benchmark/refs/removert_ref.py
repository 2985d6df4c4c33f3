"""Plain reference of LT-removert's detector, in PyTorch (any device, any
float type) with SciPy's KD-tree for the k nearest neighbours.

A frozen transcription of ``tests/ref_oracle.py`` at commit 15258b49d6b0 (the
f64 NumPy oracle written line against line from the reference C++,
``ltremovert/src/Removerter.cpp`` and ``Session.cpp``; its citations hold
here), recast from per-point NumPy to tensor operations so that a job at
the cell's size runs in seconds on the card.  Two steps are added, each
from the configuration as the program's users set it:

* ``prep_reference``: the keyframe parse (``parseKeyframes``,
  ``parseKeyframesInROI``), the ego-ring preclean and the voxel centroids
  of each scan, and the ``scan_capacity`` rule (a scan with more voxels
  keeps that many, spread evenly over its voxel list).  Which voxels the
  program keeps depends on the order of its voxel list, which no
  specification fixes, so the prep is checked apart (:func:`prep_gap`):
  every kept point has to be one of the scan's voxel centroids, and the
  count has to be the rule's.
* ``detector_reference``: the detector from the prepped scans on; it
  starts from the program's prepped scans (or its own, for the control).

Point sets are compared as sets of occupied 0.05 m cells (``cell_keys``,
``set_gaps``): the reference's re-dedupe keeps centroids, the program a
point of each voxel, and both lie in the same cell.

Imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch
from scipy.spatial import cKDTree

K_FLAG_NO_POINT = 10000.0     # utility.h:93
K_VALID_DIFF_UPPER = 200.0    # utility.h:94
DEDUPE_VOXEL = 0.05           # hard-coded at every re-dedupe site
CELL = 0.05                   # the cell of the set comparison (m)

SET_NAMES = ("static_c", "dynamic_c", "static_q", "dynamic_q", "coexist_c",
             "coexist_q", "nd", "nd_strong", "nd_weak", "pd", "pd_strong",
             "pd_weak", "updated", "updated_strong")


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def _pack(idx: torch.Tensor) -> torch.Tensor:
    """Integer cells (N, 3) -> int64 keys in lexicographic order."""
    lo = torch.tensor([-(1 << 20)] * 3, device=idx.device)
    i = idx - lo
    return (i[:, 0] << 42) | (i[:, 1] << 21) | i[:, 2]


def cell_keys(pts: torch.Tensor, cell: float = CELL) -> torch.Tensor:
    """Sorted unique keys of the ``cell``-metre cells that ``pts`` occupy."""
    if len(pts) == 0:
        return torch.zeros(0, dtype=torch.int64, device=pts.device)
    return torch.unique(_pack(torch.floor(pts.double() / cell).long()))


def voxel_centroid(pts: torch.Tensor, leaf: float) -> torch.Tensor:
    """Voxel-centroid downsample, voxels in the order of their cells."""
    if len(pts) == 0:
        return pts.reshape(0, 3)
    key = _pack(torch.floor(pts / leaf).long())
    uniq, inv = torch.unique(key, return_inverse=True)
    sums = torch.zeros((len(uniq), 3), dtype=pts.dtype, device=pts.device)
    sums.index_add_(0, inv, pts)
    cnt = torch.bincount(inv, minlength=len(uniq)).to(pts.dtype)
    return sums / cnt[:, None]


def preclean(pts: torch.Tensor, radius: float, z_band: float) -> torch.Tensor:
    """``precleaningKeyframes``: drop (range < radius) & (|z| < z_band)."""
    r = torch.linalg.norm(pts, dim=1)
    return pts[~((r < radius) & (pts[:, 2].abs() < z_band))]


def rimg_shape(fov, alpha):
    """``resetRimgSize`` (utility.cpp:222-236)."""
    return int(round(fov[0] * alpha)), int(round(fov[1] * alpha))


def _pixel_of(pts: torch.Tensor, fov, shape):
    vfov, hfov = fov
    rows, cols = shape
    az = torch.rad2deg(torch.atan2(pts[:, 1], pts[:, 0]))
    el = torch.rad2deg(torch.atan2(pts[:, 2], torch.sqrt(pts[:, 0] ** 2 + pts[:, 1] ** 2)))
    r = torch.linalg.norm(pts, dim=1)
    row = torch.round(rows * (1.0 - (el + vfov / 2.0) / vfov)).long().clamp(0, rows - 1)
    col = torch.round(cols * ((az + hfov / 2.0) / hfov)).long().clamp(0, cols - 1)
    return row * cols + col, r


def scan_range_image(scan_local, fov, shape):
    """``scan2RangeImg``: scatter-min range, flat (P,)."""
    img = torch.full((shape[0] * shape[1],), K_FLAG_NO_POINT, dtype=scan_local.dtype,
                     device=scan_local.device)
    if len(scan_local):
        pix, r = _pixel_of(scan_local, fov, shape)
        img.scatter_reduce_(0, pix, r, "amin")
    return img


def map_range_image(map_local, fov, shape):
    """``map2RangeImg``: (range image, winner index image); a pixel's winner
    is its nearest point, the lowest index among equals, and index 0
    doubles as "no point" (the reference's quirk, kept by the callers)."""
    n_pix = shape[0] * shape[1]
    img = torch.full((n_pix,), K_FLAG_NO_POINT, dtype=map_local.dtype, device=map_local.device)
    ptidx = torch.zeros(n_pix, dtype=torch.long, device=map_local.device)
    n = len(map_local)
    if n == 0:
        return img, ptidx
    pix, r = _pixel_of(map_local, fov, shape)
    rmin = torch.full((n_pix,), float("inf"), dtype=r.dtype, device=r.device)
    rmin.scatter_reduce_(0, pix, r, "amin")
    at_min = r == rmin[pix]
    ids = torch.arange(n, device=r.device)
    win = torch.full((n_pix,), n, dtype=torch.long, device=r.device)
    win.scatter_reduce_(0, pix[at_min], ids[at_min], "amin")
    hit = win < n
    img[hit] = rmin[hit]
    ptidx[hit] = win[hit]
    return img, ptidx


def _transform(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    return pts @ T[:3, :3].T + T[:3, 3]


def _knn_avg_sqdist(queries: torch.Tensor, targets: torch.Tensor, k: int) -> torch.Tensor:
    """Mean of the ``k`` nearest squared distances of each query (exact,
    SciPy's KD-tree on the host, in float64 over the given values)."""
    q = queries.double().cpu().numpy()
    t = targets.double().cpu().numpy()
    d, _ = cKDTree(t).query(q, k=min(k, len(t)), workers=-1)
    d = np.asarray(d).reshape(len(q), -1)
    return torch.from_numpy(np.mean(d ** 2, axis=1)).to(queries.device, queries.dtype)


# ---------------------------------------------------------------------------
# prep
# ---------------------------------------------------------------------------

def keyframe_indices(central_poses: np.ndarray, query_poses: np.ndarray, cfg: dict):
    """``parseKeyframes`` over the central session and ``parseKeyframesInROI``
    over the query one (keep scans within ``roi_inplace_threshold`` m of a
    central keyframe), both gap-subsampled."""
    l2b = np.asarray(cfg["extrinsic_lidar_to_base"], np.float64).reshape(4, 4)
    idx = np.arange(len(central_poses))
    c_idx = idx[(idx >= cfg["start_idx"]) & (idx <= cfg["end_idx"])][::max(cfg["keyframe_gap"], 1)]
    roi = np.asarray([central_poses[i] @ l2b for i in c_idx]).reshape(-1, 4, 4)[:, :3, 3]
    d = np.linalg.norm(query_poses[:, None, :3, 3] - roi[None], axis=-1).min(axis=1)
    q_idx = np.flatnonzero(d <= cfg["roi_inplace_threshold"])[::max(cfg["keyframe_gap"], 1)]
    return c_idx, q_idx


def prep_scan(raw: torch.Tensor, cfg: dict) -> torch.Tensor:
    """Preclean, then voxel centroids (the program's documented order)."""
    pts = preclean(raw[:, :3], cfg["preclean_radius"], cfg["preclean_z_band"])
    return voxel_centroid(pts, cfg["downsample_voxel_size"])


def keep_count(n_voxels: int, cfg: dict) -> int:
    return min(n_voxels, cfg["scan_capacity"])


def prep_reference(raw_scans: Sequence[torch.Tensor], cfg: dict) -> List[torch.Tensor]:
    """Each scan's kept points under the ``scan_capacity`` rule, its voxel
    list taken in cell order."""
    out = []
    for raw in raw_scans:
        cen = prep_scan(raw, cfg)
        keep = keep_count(len(cen), cfg)
        sel = torch.from_numpy(np.linspace(0, len(cen) - 1, keep).astype(np.int64)).to(cen.device)
        out.append(cen[sel] if keep < len(cen) else cen)
    return out


def prep_gap(kept: Sequence[torch.Tensor], raw_scans: Sequence[torch.Tensor], cfg: dict,
             tol: float = 1e-4) -> float:
    """Share of kept points that are no voxel centroid of their scan (no
    centroid in the same cell within ``tol`` m, or a cell kept twice), plus
    each scan's count off the rule, over all kept points."""
    bad, total = 0, 0
    v = cfg["downsample_voxel_size"]
    for pts, raw in zip(kept, raw_scans):
        cen = prep_scan(raw.double(), cfg)
        key_c = _pack(torch.floor(cen / v).long())
        order = torch.argsort(key_c)
        key_c, cen = key_c[order], cen[order]
        p = pts.double()
        key_p = _pack(torch.floor(p / v).long())
        pos = torch.searchsorted(key_c, key_p).clamp(max=max(len(key_c) - 1, 0))
        ok = (key_c[pos] == key_p) & ((cen[pos] - p).abs().amax(1) <= tol) if len(key_c) else \
            torch.zeros(len(p), dtype=torch.bool, device=p.device)
        dup = len(key_p) - len(torch.unique(key_p))
        bad += int((~ok).sum()) + dup + abs(len(p) - keep_count(len(cen), cfg))
        total += max(len(p), 1)
    return bad / max(total, 1)


# ---------------------------------------------------------------------------
# the detector (``Removerter::run`` steps 1-3, Removerter.cpp:1653-1678)
# ---------------------------------------------------------------------------

class _Session:
    def __init__(self, scans, poses, cfg, dtype, device):
        l2b = np.asarray(cfg["extrinsic_lidar_to_base"], np.float64).reshape(4, 4)
        eff = np.asarray([np.asarray(p, np.float64) @ l2b for p in poses]).reshape(-1, 4, 4)
        self.poses = [torch.from_numpy(p).to(device, dtype) for p in eff]
        self.inv_poses = [torch.from_numpy(np.linalg.inv(p)).to(device, dtype) for p in eff]
        self.scans = [s.to(device, dtype) for s in scans]
        merged = torch.cat([_transform(T, s) for T, s in zip(self.poses, self.scans)]) \
            if self.scans else torch.zeros((0, 3), dtype=dtype, device=device)
        self.map_global = voxel_centroid(merged, cfg["downsample_voxel_size"])
        self.static_map = self.map_global
        self.dynamic = merged[:0]


def _discrepancy_flags(target_map, source_scans, source_inv_poses, fov, alpha, thres, reverse):
    """Winner points flagged by any source keyframe's range-image discrepancy
    (``calcDescrepancyAndParseDynamicPointIdxForEachScan``)."""
    shape = rimg_shape(fov, alpha)
    flag = torch.zeros(len(target_map) + 1, dtype=torch.bool, device=target_map.device)
    for scan_local, inv_pose in zip(source_scans, source_inv_poses):
        scan_img = scan_range_image(scan_local, fov, shape)
        map_img, ptidx = map_range_image(_transform(inv_pose, target_map), fov, shape)
        diff = (map_img - scan_img) if reverse else (scan_img - map_img)
        hit = (diff < K_VALID_DIFF_UPPER) & (diff > thres)
        flag[ptidx[hit]] = True
    return flag[:len(target_map)]


def _project_scans(map_global, inv_poses, fov, alpha):
    """Each keyframe's winner map points at the reprojection resolution, in
    its LOCAL frame; the winner of index 0 is dropped (the ptidx==0 quirk)."""
    shape = rimg_shape(fov, alpha)
    out = []
    for inv_pose in inv_poses:
        local = _transform(inv_pose, map_global)
        _, ptidx = map_range_image(local, fov, shape)
        out.append(local[ptidx[ptidx != 0]])
    return out


def _knn_partition(scans_local, poses, target_map, k, thr):
    """Per scan point: mean of the ``k`` nearest squared distances to the
    target map below ``thr`` -> coexisting, else different."""
    lens = [len(s) for s in scans_local]
    if not sum(lens) or len(target_map) == 0:
        return [s[:0] for s in scans_local], list(scans_local)
    pts_g = torch.cat([_transform(T, s) for T, s in zip(poses, scans_local)])
    close = (_knn_avg_sqdist(pts_g, target_map, k) < thr).split(lens)
    return ([s[c] for s, c in zip(scans_local, close)],
            [s[~c] for s, c in zip(scans_local, close)])


def _merge_global(scans_local, poses, voxel=DEDUPE_VOXEL):
    pts = [_transform(T, s) for T, s in zip(poses, scans_local) if len(s)]
    if not pts:
        return torch.zeros((0, 3), dtype=poses[0].dtype, device=poses[0].device)
    return voxel_centroid(torch.cat(pts), voxel)


def _filter_strong(cand, source: _Session, proj, cfg, fov, reverse):
    cur, weak = cand, cand[:0]
    for _ in range(cfg["nd_pd_filter_repeats"]):
        flag = _discrepancy_flags(cur, proj, source.inv_poses, fov,
                                  cfg["nd_pd_filter_resolution"], 0.1, reverse)
        cur, dyn = voxel_centroid(cur[~flag], DEDUPE_VOXEL), cur[flag]
        weak = voxel_centroid(torch.cat([weak, dyn]), DEDUPE_VOXEL)
    return cur, weak


def detector_reference(central_scans, central_poses, query_scans, query_poses, cfg: dict,
                       dtype=torch.float64, device="cpu") -> Dict[str, torch.Tensor]:
    """The named global point sets of ``SET_NAMES`` from prepped local scans
    and the sessions' poses, every tensor in ``dtype``."""
    fov = (cfg["vfov"], cfg["hfov"])
    c = _Session(central_scans, central_poses, cfg, dtype, device)
    q = _Session(query_scans, query_poses, cfg, dtype, device)

    # Step 1: high-dynamic removal, then each session's projected static scans
    for s in (c, q):
        m, dyn = s.map_global, [s.map_global[:0]]
        for res in cfg["remove_resolution_list"]:
            flag = _discrepancy_flags(m, s.scans, s.inv_poses, fov, res,
                                      cfg["diff_threshold"], reverse=False)
            dyn.append(m[flag])
            m = voxel_centroid(m[~flag], DEDUPE_VOXEL)
        s.static_map, s.dynamic = m, torch.cat(dyn)
        s.proj = _project_scans(m, s.inv_poses, fov, cfg["reprojection_alpha"])

    # Step 2: low-dynamic detection
    k, thr = cfg["num_knn_points"], cfg["knn_avg_sqdist_threshold"]
    c_coex, c_diff = _knn_partition(c.proj, c.poses, q.static_map, k, thr)
    q_coex, q_diff = _knn_partition(q.proj, q.poses, c.static_map, k, thr)
    nd_map = _merge_global(c_diff, c.poses)
    pd_map = _merge_global(q_diff, q.poses)

    # ND: reversed diff against the query's projected static scans; PD:
    # forward diff against the central ones
    nd_strong, nd_weak = _filter_strong(nd_map, q, q.proj, cfg, fov, reverse=True)
    pd_strong, pd_weak = _filter_strong(pd_map, c, c.proj, cfg, fov, reverse=False)

    # removeWeakNDMapPointsHavingStrongNDInNear
    if len(nd_strong) and len(nd_weak):
        promote = _knn_avg_sqdist(nd_weak, nd_strong, 2) < cfg["weak_to_strong_sqdist_threshold"]
        nd_strong = torch.cat([nd_strong, nd_weak[promote]])
        nd_weak = nd_weak[~promote]

    # Step 3: composition (updateCurrentMap)
    union_q = _merge_global(q_coex, q.poses)
    union_c = _merge_global(c_coex, c.poses)
    updated = voxel_centroid(torch.cat([union_q, union_c, nd_weak, pd_map]), DEDUPE_VOXEL)
    updated_strong = voxel_centroid(torch.cat([union_q, union_c, nd_weak, pd_strong]),
                                    DEDUPE_VOXEL)
    return {"static_c": c.static_map, "dynamic_c": c.dynamic, "static_q": q.static_map,
            "dynamic_q": q.dynamic, "coexist_c": union_c, "coexist_q": union_q,
            "nd": nd_map, "nd_strong": nd_strong, "nd_weak": nd_weak, "pd": pd_map,
            "pd_strong": pd_strong, "pd_weak": pd_weak, "updated": updated,
            "updated_strong": updated_strong}


def set_gaps(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """1 - Jaccard index of the occupied cells, a set by name (0 where both
    are empty)."""
    out = {}
    for name in SET_NAMES:
        a, b = cell_keys(got[name]), cell_keys(want[name].to(got[name].device))
        if len(a) == 0 and len(b) == 0:
            out[name] = 0.0
            continue
        inter = int(torch.isin(a, b).sum())
        out[name] = 1.0 - inter / (len(a) + len(b) - inter)
    return out
