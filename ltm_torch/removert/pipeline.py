"""LT-removert + LT-map: dynamic removal, change detection, map update
(port of ``ltm.removert.pipeline`` on one device).

Reference: ``Removerter::run`` (``ltremovert/src/Removerter.cpp:1653-1678``):
  Step 0 prep (load, parse keyframes, preclean, global maps)
  Step 1 high-dynamic removal (self visibility check per session)
  Step 2 low-dynamic PD/ND change detection (cross-session kNN + 3×
         visibility re-checks → strong/weak split, weak→strong propagation)
  Step 3 LT-map composition (union + weak-ND + PD), and with a save
         directory the reference's artifact tree (maps, scan-wise updates).

Each session's global map is ONE padded tensor and every stage is a boolean
mask over it.  The visibility sweeps stream keyframes through scatter-min
projections over the block layout (``ltm_torch.kernels.blocks``).  The kNN
stages take the chunked block kNN on maps of at least
``chunk_knn_min_targets`` points (the hand-written CUDA scan of
``ltm_torch.kernels.chunk_knn`` on the card), with its overflowed chunks
escalated and then brute-forced, and the brute-force 2-NN below that (the
CUDA kernel of ``ltm_torch.kernels.knn2``).

The opt-in configurations run as in ``ltm``: ``use_occlusion_culling``
(per-(keyframe, block) footprint culling of every sweep, exact by
construction, ``ltm_torch.kernels.occlusion``), ``use_grid_knn`` (the
clamped grid 2-NN, ``ltm_torch.kernels.grid_knn``), ``device_scan_prep``
(``ltm_torch.removert.session``) and ``use_self_removert`` (the
remove → revert → remove loop).

``cfg.mesh_devices`` puts the hot loops on a mesh of device slots
(``ltm_torch.dist``), as ``ltm`` does: the forward, winner and
strong/weak sweeps sharded over keyframes, the chunked kNN over Morton
chunks (each slot launching K4's scan over its chunk range) and the brute
kNN over queries (K1 a slot), every result bit-equal to the one-device
path.  On one card ``mesh_from_config`` gives no mesh, as ``ltm`` on one
chip; a mesh of repeated slots (``make_mesh([cuda:0] * 4)``) is assigned to
``Removerter.mesh``.  The opt-in culled, presel and grid paths stay
unsharded, as in ``ltm``.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch

from ltm_torch.core.config import RemovertConfig
from ltm_torch.device import resolve_device
from ltm_torch.dist.mesh import mesh_from_config
from ltm_torch.dist.removert import (
    block_fused_visibility_images_sharded,
    block_sweep_discrepancy_sharded,
    block_sweep_discrepancy_vs_images_sharded,
    chunk_knn_sqdists_sharded,
    fused_visibility_images_sharded,
    sweep_discrepancy_vs_images_sharded,
)
from ltm_torch.dist.sharding import knn_avg_sqdist_sharded, sweep_discrepancy_sharded
from ltm_torch.io.pcd import write_pcd
from ltm_torch.kernels.blocks import (
    block_fused_phase_a,
    block_fused_phase_b,
    block_fused_visibility_images,
    block_sweep_discrepancy,
    block_sweep_discrepancy_vs_images,
    block_sweep_discrepancy_vs_images_presel,
    build_block_map_with_slots,
    required_k_blocks_np,
)
from ltm_torch.kernels.chunk_knn import chunk_knn_sqdists
from ltm_torch.kernels.grid_knn import build_grid_buckets, grid_knn2_sqdists
from ltm_torch.kernels.knn import chunked_knn_avg_sqdist
from ltm_torch.kernels.occlusion import (
    compact_survivors,
    cull_blocks_vs_images,
    effective_range_image,
)
from ltm_torch.kernels.projection import (
    NO_POINT,
    VALID_DIFF_UB,
    apply_pose,
    fused_visibility_images,
    range_image,
    rimg_shape,
    spherical_project,
    sweep_discrepancy,
    sweep_discrepancy_vs_images,
    transform,
    winner_mask,
)
from ltm_torch.kernels.voxel import voxel_unique_mask
from ltm_torch.ltmap.compose import compose_updated_maps
from ltm_torch.removert.session import (
    RemovertInput,
    RemovertSession,
    parse_keyframe_indices,
    parse_keyframes_in_roi,
)
from ltm_torch.utils import count_slots, get_logger, stage_timer

__all__ = ["Removerter", "RemovertResult"]

log = get_logger("ltm_torch.removert")

MASK_NAMES = ("static_c", "dynamic_c", "static_q", "dynamic_q", "coexist_c",
              "coexist_q", "nd", "nd_strong", "nd_weak", "pd", "pd_strong",
              "pd_weak", "updated", "updated_strong")


@dataclass
class RemovertResult:
    """All named point sets as (xyz, mask) pairs over fixed tensors."""

    central: RemovertSession
    query: RemovertSession
    combined_xyz: torch.Tensor            # cat(central map, query map)
    masks: Dict[str, torch.Tensor] = field(default_factory=dict)

    def points(self, name: str) -> np.ndarray:
        """Compact a named set (one of ``MASK_NAMES``) to a host (M, 3) array."""
        m = self.masks[name]
        if name in ("updated", "updated_strong"):
            xyz = self.combined_xyz
        elif name.endswith("_q") or name.startswith("pd"):
            xyz = self.query.map_xyz
        else:
            xyz = self.central.map_xyz
        return xyz[m].cpu().numpy()


class _IdCache:
    """Cache keyed by object identity that holds a strong reference to the
    key object, so a freed object's id can never alias a live entry."""

    def __init__(self):
        self._d: dict = {}

    def get(self, obj, extra=None):
        hit = self._d.get((id(obj), extra))
        return hit[1] if hit is not None and hit[0] is obj else None

    def put(self, obj, value, extra=None):
        self._d[(id(obj), extra)] = (obj, value)
        return value


class Removerter:
    def __init__(self, cfg: Optional[RemovertConfig] = None, device=None):
        self.cfg = cfg or RemovertConfig()
        self.device = resolve_device(device)
        # per-run exact-bound caches (reset by run())
        self._origins = np.zeros((0, 3))
        self._kb_cache = _IdCache()
        self._vis_cache = _IdCache()
        self._geom_cache = _IdCache()
        # session -> (K, n_pix) filter-res images of its projected static
        # scans (built in project_static, read by every strong-weak repeat)
        self._img_cache = _IdCache()
        # map -> (kNN block layout, slots), built once per map (_knn_block_map)
        self._kbm_cache = _IdCache()
        # one entry per chunk-kNN call that overflowed: the original indices
        # of its escalated and brute-forced queries (_chunk_knn_finish)
        self.chunk_knn_fallbacks: list = []
        # one entry per occlusion cull of a run: the sweep and, per keyframe,
        # the blocks it kept (for the winner pass: near blocks and far
        # survivors) out of the layout's
        self.occlusion_stats: list = []
        # mesh of device slots for the hot loops (cfg.mesh_devices; the
        # reference's OpenMP loops at device scale, Session.cpp:408,491)
        self.mesh = mesh_from_config(self.cfg.mesh_devices, self.device)
        if self.mesh is not None:
            log.info("removert: sharding hot loops over %d slots", self.mesh.size)

    # ------------------------------------------------------------------
    def run(self, central_inp: RemovertInput, query_inp: RemovertInput,
            save_directory: Optional[str] = None) -> RemovertResult:
        cfg = self.cfg
        fov = (cfg.vfov, cfg.hfov)
        self._kbm_cache = _IdCache()
        self.chunk_knn_fallbacks = []
        self.occlusion_stats = []

        # ---------------- Step 0: prep -----------------------------------
        with stage_timer("removert.prep", log):
            c_idx = parse_keyframe_indices(len(central_inp.scans), cfg.start_idx, cfg.end_idx, cfg.keyframe_gap)
            lidar2base = np.asarray(cfg.extrinsic_lidar_to_base, np.float64).reshape(4, 4)
            roi = np.asarray([central_inp.poses[i] @ lidar2base for i in c_idx]).reshape(-1, 4, 4)
            q_idx = parse_keyframes_in_roi(query_inp.poses, roi, cfg.roi_inplace_threshold, cfg.keyframe_gap)
            # every per-sweep bound needs only the keyframe ORIGINS, known
            # before the sessions are built: budgets size over the union of
            # both sessions' origins (ND/PD filters sweep one session's map
            # from the other's keyframes)
            q_eff = np.asarray([query_inp.poses[i] @ lidar2base for i in q_idx],
                               np.float32).reshape(-1, 4, 4)
            self._origins = (np.concatenate([roi.astype(np.float32)[:, :3, 3], q_eff[:, :3, 3]])
                             if (len(c_idx) + len(q_idx)) else np.zeros((0, 3)))
            self._kb_cache = _IdCache()
            self._vis_cache = _IdCache()
            self._geom_cache = _IdCache()
            self._img_cache = _IdCache()
        # the query session's host prep runs on a pool thread while the
        # central session is built and swept; the finally joins it even when
        # a central stage raises
        ex = ThreadPoolExecutor(max_workers=1)
        try:
            with stage_timer("removert.prep", log):
                f_q = ex.submit(RemovertSession.build, query_inp, cfg, "Query", q_idx, self.device)
                central = RemovertSession.build(central_inp, cfg, "Central", c_idx, self.device)
            log.info("central: %d keyframes, %d map pts", central.num_keyframes,
                     int(central.map_mask.sum()))

            # ---------------- Step 1: high-dynamic removal ----------------
            with stage_timer("removert.high_dynamic", log):
                self._remove_high_dynamic(central, fov)
            with stage_timer("removert.project_static", log):
                self._project_static_and_images(central, fov)
            with stage_timer("removert.prep", log):
                query = f_q.result()
        finally:
            ex.shutdown(wait=True)
        log.info("query: %d keyframes, %d map pts", query.num_keyframes, int(query.map_mask.sum()))
        for sess in (central, query):
            if sess.bm is not None:
                log.info("%s: block map %d blocks x %d cap, fwd bound %.1f m, "
                         "vis bound %.1f m", sess.sess_type, sess.bm.num_blocks,
                         sess.bm.block_capacity, self._fwd_bound(sess), self._vis_bound(sess))
        with stage_timer("removert.high_dynamic", log):
            self._remove_high_dynamic(query, fov)
        with stage_timer("removert.project_static", log):
            self._project_static_and_images(query, fov)

        # ---------------- Step 2: low-dynamic change detection ------------
        with stage_timer("removert.knn_diff", log):
            nd_cand, coexist_c = self._knn_partition(central, query)
            pd_cand, coexist_q = self._knn_partition(query, central)
        log.info("ND candidates: %d | PD candidates: %d", int(nd_cand.sum()), int(pd_cand.sum()))

        with stage_timer("removert.strong_weak", log):
            # ND checks use the reversed diff (Removerter.cpp:516)
            nd_strong, nd_weak = self._filter_strong(central, nd_cand, query, fov, reverse=True)
            pd_strong, pd_weak = self._filter_strong(query, pd_cand, central, fov, reverse=False)
        with stage_timer("removert.strong_weak.propagate", log):
            nd_strong, nd_weak = self._propagate_weak_to_strong(central, nd_strong, nd_weak)
        # reference revertStrongPDMapPointsHavingWeakPDInNear is an empty
        # TODO (Session.cpp:447-450) — intentionally not applied here.

        # ---------------- Step 3: LT-map composition ----------------------
        with stage_timer("removert.compose", log):
            comb_xyz, updated, updated_strong = compose_updated_maps(
                central.map_xyz, query.map_xyz, coexist_c, nd_weak,
                coexist_q, pd_cand, pd_strong, cfg.downsample_voxel_size,
            )

        masks = dict(zip(MASK_NAMES, (
            central.masks["static"], central.masks["dynamic"],
            query.masks["static"], query.masks["dynamic"],
            coexist_c, coexist_q, nd_cand, nd_strong, nd_weak,
            pd_cand, pd_strong, pd_weak, updated, updated_strong)))
        result = RemovertResult(central=central, query=query, combined_xyz=comb_xyz, masks=masks)
        if save_directory:
            with stage_timer("removert.save", log):
                self._save_artifacts(result, save_directory, fov)
        return result

    # ------------------------------------------------------------------
    # per-sweep exact culling bounds + block budgets
    # ------------------------------------------------------------------
    def _fwd_bound(self, sess: RemovertSession) -> float:
        """Exact bound for forward discrepancy sweeps of a session's own
        scans: a flagged map point satisfies range < scan_pixel − thres, and
        a culled farther point can't displace a pixel minimum below it."""
        return sess.max_scan_range + self.cfg.diff_threshold + 0.25

    def _vis_bound(self, sess: RemovertSession) -> float:
        """Exact bound for winner (visibility) projections of a session's
        map: the farthest valid block from any viewpoint (a winner can sit
        at any range)."""
        hit = self._vis_cache.get(sess.bm.xyz)
        if hit is not None:
            return hit
        centers, radius, valid = self._geom(sess.bm)
        if self._origins.size == 0 or not valid.any():
            b = 0.0
        else:
            d = np.linalg.norm(centers[None] - self._origins[:, None], axis=-1) + radius[None]
            b = float(np.where(valid[None], d, 0.0).max())
        return self._vis_cache.put(sess.bm.xyz, b)

    def _geom(self, bm):
        """Host copies of a layout's (centers, radius, block_valid), fetched
        once per block map."""
        hit = self._geom_cache.get(bm.xyz)
        if hit is None:
            hit = self._geom_cache.put(bm.xyz, tuple(
                a.cpu().numpy() for a in (bm.centers, bm.radius, bm.block_valid)))
        return hit

    def _kb(self, bm, bound: float):
        """(k_blocks, max_range) for a sweep over ``bm`` with an exact
        culling bound.  Bounds bucket to 25 m; an explicit cfg.k_blocks acts
        as a floor, an explicit cfg.block_max_range replaces the bound."""
        cfg = self.cfg
        if cfg.block_max_range is not None:
            bound = cfg.block_max_range
        bound = float(np.ceil(bound / 25.0) * 25.0)
        hit = self._kb_cache.get(bm.xyz, bound)
        if hit is not None:
            return hit
        need = required_k_blocks_np(*self._geom(bm), self._origins, bound)
        if cfg.k_blocks is not None:
            need = min(max(cfg.k_blocks, need), bm.num_blocks)
        log.info("block budget: %d/%d blocks within %.0f m", need, bm.num_blocks, bound)
        return self._kb_cache.put(bm.xyz, (need, bound), bound)

    def _pack_scale(self, sess: RemovertSession) -> float:
        """Fixed-point scale for the packed winner pass: 2²⁷ units over the
        session's pow-2-bucketed visibility bound."""
        if sess.bm is not None:
            b = self._vis_bound(sess)
        else:
            ext = torch.where(sess.map_mask[:, None], sess.map_xyz, 0.0)
            b = float(torch.linalg.vector_norm(ext, dim=-1).max())
            if self._origins.size:
                b += float(np.linalg.norm(self._origins, axis=-1).max())
        B = float(1 << max(8, int(np.ceil(b + 1.0) - 1).bit_length()))
        return float(2 ** 27) / B

    def _project_static_and_images(self, sess: RemovertSession, fov) -> None:
        """One fused winner pass per keyframe over the session's static set:
        sets ``masks["proj_static"]`` (visible from any keyframe at the
        reprojection resolution α=3, ``Session.cpp:305-360``) and caches the
        (K, n_pix) filter-resolution images of those projected static scans,
        the source side of ``filterStrongND``/``filterStrongPD``."""
        cfg = self.cfg
        proj_shape = rimg_shape(fov, cfg.reprojection_alpha)
        shape = rimg_shape(fov, cfg.nd_pd_filter_resolution)
        K = sess.num_keyframes
        scale = self._pack_scale(sess)
        if sess.bm is not None and self.mesh is None and cfg.use_occlusion_culling:
            win, imgs = self._project_static_culled(sess, fov, shape, proj_shape, scale)
        elif sess.bm is not None and self.mesh is not None:
            kb, mr = self._kb(sess.bm, self._vis_bound(sess))
            win, imgs = block_fused_visibility_images_sharded(
                self.mesh, sess.bm, sess.masks["static"], sess.poses_inv[:K], sess.poses[:K],
                fov, shape, proj_shape, k_blocks=kb, max_range=mr, scale=scale)
        elif sess.bm is not None:
            kb, mr = self._kb(sess.bm, self._vis_bound(sess))
            count_slots(kb * sess.bm.block_capacity * K)
            win, imgs = block_fused_visibility_images(
                sess.bm, sess.masks["static"], sess.poses_inv[:K], sess.poses[:K],
                fov, shape, proj_shape, k_blocks=kb, max_range=mr, scale=scale)
        elif self.mesh is not None:
            win, imgs = fused_visibility_images_sharded(
                self.mesh, sess.map_xyz, sess.masks["static"], sess.poses_inv[:K],
                fov, shape, proj_shape, scale=scale)
        else:
            win, imgs = fused_visibility_images(
                sess.map_xyz, sess.masks["static"], sess.poses_inv[:K],
                fov, shape, proj_shape, scale=scale)
        sess.masks["proj_static"] = win
        self._img_cache.put(sess, imgs)

    def _project_static_culled(self, sess: RemovertSession, fov, shape, proj_shape, scale):
        """The two-phase occlusion-culled winner pass: the blocks within the
        near range build a provisional packed image; a far block whose least
        possible range exceeds every provisional pixel of its footprint
        cannot win and is skipped; the survivors get one more scatter and
        the winner test runs against the final image — bit-identical to the
        full pass (``ltm_torch.kernels.occlusion``)."""
        cfg = self.cfg
        K = sess.num_keyframes
        static = sess.masks["static"]
        r_near = (self._fwd_bound(sess) if cfg.occlusion_near_range is None
                  else cfg.occlusion_near_range)
        kb_near, r_near_b = self._kb(sess.bm, r_near)
        sel_a, sel_a_valid, packed_imgs, survive = block_fused_phase_a(
            sess.bm, static, sess.poses_inv[:K], sess.poses[:K], fov, shape, proj_shape,
            k_near=kb_near, r_near=r_near_b, scale=scale)
        survive = survive.cpu().numpy()
        sel_b, sel_b_valid, k_b = compact_survivors(survive)
        log.info("%s winner pass: %d near + %d/%d far blocks/keyframe",
                 sess.sess_type, kb_near, k_b, sess.bm.num_blocks)
        self.occlusion_stats.append({"sweep": "project_static", "session": sess.sess_type,
                                     "near_blocks": kb_near,
                                     "far_survivors": survive.sum(1).tolist(),
                                     "blocks": sess.bm.num_blocks})
        count_slots((kb_near + k_b) * sess.bm.block_capacity * K)
        dev = sel_a.device
        sel_b = torch.from_numpy(sel_b).to(dev)
        sel_b_valid = torch.from_numpy(sel_b_valid).to(dev)
        return block_fused_phase_b(
            sess.bm, static, sess.poses_inv[:K], packed_imgs, sel_b, sel_b_valid,
            torch.cat([sel_a, sel_b], 1), torch.cat([sel_a_valid, sel_b_valid], 1),
            fov, shape, proj_shape, scale=scale)

    def _scan_images(self, sess: RemovertSession, fov, shape):
        """(K, nrow*ncol) range images of the session's scans, cached per
        (session, shape): every forward sweep at this resolution shares
        them (remove and revert iterations).  One scatter-min over all
        keyframes, each into its own image."""
        hit = self._img_cache.get(sess, shape)
        if hit is not None:
            return hit
        K = sess.num_keyframes
        n_pix = shape[0] * shape[1]
        pix, rng = spherical_project(sess.scans_xyz[:K], fov, shape)
        pix = pix + n_pix * torch.arange(K, device=pix.device)[:, None]
        imgs = torch.full((K * n_pix,), NO_POINT, dtype=torch.float32, device=pix.device)
        imgs.scatter_reduce_(0, pix.reshape(-1),
                             torch.where(sess.scans_mask[:K], rng, torch.inf).reshape(-1), "amin")
        return self._img_cache.put(sess, imgs.reshape(K, n_pix), shape)

    def _culled_lists(self, bm, candidate, pose_inv, imgs, fov, shape, slack, tag):
        """Per-keyframe survivor block lists of one occlusion cull, on the
        device: (sel_idx (K, k_sel), sel_valid, k_sel)."""
        survive = cull_blocks_vs_images(bm.bmin, bm.bmax, candidate, pose_inv,
                                        effective_range_image(imgs, -torch.inf), fov, shape,
                                        slack).cpu().numpy()
        sel_idx, sel_valid, k_sel = compact_survivors(survive)
        log.info("occlusion cull (%s): %d/%d blocks/keyframe", tag, k_sel, bm.num_blocks)
        self.occlusion_stats.append({"sweep": tag, "survivors": survive.sum(1).tolist(),
                                     "blocks": bm.num_blocks})
        dev = bm.xyz.device
        return torch.from_numpy(sel_idx).to(dev), torch.from_numpy(sel_valid).to(dev), k_sel

    def _sweep(self, sess: RemovertSession, mask, fov, res):
        shape = rimg_shape(fov, res)
        K = sess.num_keyframes  # padded keyframes are masked but not free
        if sess.bm is not None and self.mesh is None and self.cfg.use_occlusion_culling:
            # per-(keyframe, block) footprint test against the scan images
            # replaces the range ball: strictly tighter and exact (slack
            # −thres for forward diffs); one cull a layout and resolution
            # serves every remove and revert sweep
            bm = sess.bm
            imgs = self._scan_images(sess, fov, shape)
            hit = self._kb_cache.get(bm.xyz, (shape, "fwd_cull"))
            if hit is None:
                hit = self._kb_cache.put(bm.xyz, self._culled_lists(
                    bm, bm.block_valid, sess.poses_inv[:K], imgs, fov, shape,
                    -self.cfg.diff_threshold, f"fwd {sess.sess_type}")[:2], (shape, "fwd_cull"))
            sel_idx, sel_valid = hit
            count_slots(sel_idx.shape[1] * bm.block_capacity * K)
            return block_sweep_discrepancy_vs_images_presel(
                bm._replace(mask=mask.reshape(bm.mask.shape)), mask, imgs, sess.poses_inv[:K],
                sel_idx, sel_valid, fov, shape, diff_threshold=self.cfg.diff_threshold,
                reverse=False)
        if sess.bm is not None:
            bm = sess.bm._replace(mask=mask.reshape(sess.bm.mask.shape))
            kb, mr = self._kb(sess.bm, self._fwd_bound(sess))
            args = (bm, sess.scans_xyz[:K], sess.scans_mask[:K], sess.poses_inv[:K],
                    sess.poses[:K], fov, shape)
            kw = dict(k_blocks=kb, max_range=mr, diff_threshold=self.cfg.diff_threshold,
                      reverse=False)
            if self.mesh is not None:
                return block_sweep_discrepancy_sharded(self.mesh, *args, **kw)
            count_slots(kb * sess.bm.block_capacity * K)
            return block_sweep_discrepancy(*args, **kw)
        if self.mesh is not None:
            return sweep_discrepancy_sharded(
                self.mesh, sess.map_xyz, mask, sess.scans_xyz[:K], sess.scans_mask[:K],
                sess.poses_inv[:K], fov, shape, self.cfg.diff_threshold, False)
        return sweep_discrepancy(
            sess.map_xyz, mask, sess.scans_xyz[:K], sess.scans_mask[:K],
            sess.poses_inv[:K], fov, shape, self.cfg.diff_threshold, False)

    def _remove_high_dynamic(self, sess: RemovertSession, fov) -> None:
        """``removeHighDynamicPoints`` (``Removerter.cpp:1580-1604``).

        Default: one ``removeOnce`` per configured resolution (the reference
        run() does ``removeOnce(sess, sess, 2.5)``, ``:1584``).  With
        ``use_self_removert``, the full multi-resolution remove → revert (at
        ``revert_resolution_list``'s entry, else 0.95×res, restoring falsely
        removed points) → remove loop, ``repeat_removert_iter`` times a
        resolution (``selfRemovert``/``revertOnce``,
        ``Removerter.cpp:1378-1393,908-931``), as mask algebra."""
        cfg = self.cfg
        cur = sess.map_mask
        dynamic = torch.zeros_like(cur)

        def remove_once(cur, dynamic, res):
            dyn = self._sweep(sess, cur, fov, res)
            return cur & ~dyn, dynamic | dyn

        def revert_once(cur, dynamic, res):
            flagged = self._sweep(sess, dynamic, fov, res)
            return cur | (dynamic & ~flagged), dynamic & flagged

        for i, res in enumerate(cfg.remove_resolution_list):
            if not cfg.use_self_removert:
                cur, dynamic = remove_once(cur, dynamic, res)
            else:
                revert_list = cfg.revert_resolution_list
                revert_res = (revert_list[min(i, len(revert_list) - 1)] if revert_list
                              else 0.95 * res)
                for _ in range(max(cfg.repeat_removert_iter, 1)):
                    cur, dynamic = remove_once(cur, dynamic, res)
                    cur, dynamic = revert_once(cur, dynamic, revert_res)
                    cur, dynamic = remove_once(cur, dynamic, res)
            # per-resolution snapshot (Removerter.cpp:318-338)
            sess.masks[f"static@{res}"] = cur
            sess.masks[f"dynamic@{res}"] = dynamic
        sess.masks["static"] = cur
        sess.masks["dynamic"] = dynamic
        log.info("%s HD removal: %d static / %d dynamic", sess.sess_type,
                 int(cur.sum()), int(dynamic.sum()))

    def _knn_partition(self, sess: RemovertSession, other: RemovertSession):
        """``extractLowDynPointsViaKnnDiff`` against the other session's
        static map (``Session.cpp:393-427,537-607``), once per map point of
        the projected-visible static set (the verdict depends only on the
        point).  Returns (diff, coexist)."""
        eligible = sess.masks["static"] & sess.masks["proj_static"]
        d = self._knn_stat(sess.map_xyz, eligible, other.map_xyz, other.masks["static"],
                           target_base=other.map_mask)
        close = d < self.cfg.knn_avg_sqdist_threshold
        return eligible & ~close, eligible & close

    def _filter_strong(self, sess: RemovertSession, cand, source: RemovertSession,
                       fov, reverse: bool):
        """3× visibility re-checks of a delta map against the source
        session's projected static scans (``filterStrongND``/``filterStrongPD``,
        ``Removerter.cpp:1395-1411``).  Returns (strong, weak)."""
        cfg = self.cfg
        shape = rimg_shape(fov, cfg.nd_pd_filter_resolution)
        cur = cand                       # ALWAYS original map index space
        weak = torch.zeros_like(cand)
        use_blocks = sess.bm is not None and source.bm is not None
        Ks = source.num_keyframes  # padded poses are identity (phantom origin view)
        imgs = self._img_cache.get(source)
        dbm = d_slots = None
        sel_idx = sel_valid = None
        kb_eff = mr_t = None
        n_cur = int(cand.sum()) if use_blocks else -1
        repeat_counts = [n_cur]
        if use_blocks:
            # target side: a flagged point's range is bounded by the largest
            # source image pixel (≤ source vis bound), plus
            # kValidDiffUpperBound when the diff is reversed (ND)
            bound_t = self._vis_bound(source) + (VALID_DIFF_UB if reverse else 0.0)
            kb_t, mr_t = self._kb(sess.bm, bound_t)
            bcap = sess.bm.block_capacity
            nb = sess.bm.num_blocks
            kb_bound = float(np.ceil(mr_t / 25.0) * 25.0)

            # re-block JUST the delta set into a tight layout (same points,
            # same images, same per-pixel winners), rebuilt between repeats
            # whenever the survivors fit a strictly smaller pow-2 layout
            def _delta_blocks(n_del):
                need = max((n_del * 5 + 4 * bcap - 1) // (4 * bcap), 1)
                return max(64, 1 << (need - 1).bit_length())

            def _build_delta(mask_orig, n_del):
                """(layout, slots, k_blocks), or None on overflow
                (degenerate extents: the caller keeps the map layout)."""
                dbm_c, ov, slots_c = build_block_map_with_slots(
                    sess.map_xyz, mask_orig, cfg.block_cell_size, _delta_blocks(n_del), bcap)
                if ov:
                    return None
                geom = (a.cpu().numpy() for a in (dbm_c.centers, dbm_c.radius, dbm_c.block_valid))
                return dbm_c, slots_c, required_k_blocks_np(*geom, self._origins, kb_bound)

            built = _build_delta(cand, n_cur) if n_cur else None
            if built is not None:
                dbm, d_slots, kb_eff = built
            else:
                n_cb = int(torch.any(cand.reshape(nb, bcap), dim=1).sum())
                kb_eff = min(max(min(kb_t, ((n_cb + 127) // 128) * 128), 128), nb)
            if cfg.use_occlusion_culling and self.mesh is None:
                # per (keyframe, block) footprint test against the source
                # images (slack −thres, or +kValidDiffUpperBound reversed);
                # one cull over the full candidate set serves every repeat
                # (targets only shrink)
                bm_c = dbm if dbm is not None else sess.bm
                candidate = bm_c.block_valid
                if dbm is None:
                    candidate = candidate & torch.any(bm_c.mask & cand.reshape(nb, bcap), dim=1)
                slack = float(VALID_DIFF_UB if reverse else -cfg.diff_threshold)
                sel_idx, sel_valid, k_sel = self._culled_lists(
                    bm_c, candidate, source.poses_inv[:Ks], imgs, fov, shape, slack,
                    f"{'ND' if reverse else 'PD'} filter {sess.sess_type}")
                if k_sel >= kb_eff:
                    sel_idx = sel_valid = None   # culling won nothing
        # survivor counts per repeat drive the pow-2 shrink rebuilds and the
        # empty-set exit; on a mesh the fixed loop runs, as in ltm
        count_repeats = use_blocks and self.mesh is None
        for r in range(cfg.nd_pd_filter_repeats):
            if count_repeats and n_cur == 0:
                break   # nothing left to re-check (flagged ⊆ cur always)
            if (count_repeats and dbm is not None and sel_idx is None and r > 0
                    and _delta_blocks(n_cur) < dbm.num_blocks):
                built = _build_delta(cur, n_cur)
                if built is not None:       # on overflow keep the old layout
                    dbm, d_slots, kb_eff = built
            if use_blocks:
                bm_eff, cur_eff = sess.bm, cur
                if dbm is not None:
                    # layout-space mask of the current survivors (d_slots:
                    # orig index -> flat delta slot; the sentinel is cut off)
                    n_flat = dbm.num_blocks * dbm.block_capacity
                    cur_l = torch.zeros((n_flat + 1,), dtype=torch.bool, device=cur.device)
                    cur_l[d_slots] = cur
                    bm_eff, cur_eff = dbm, cur_l[:n_flat]
                if sel_idx is not None:
                    count_slots(sel_idx.shape[1] * bm_eff.block_capacity * Ks)
                    flagged = block_sweep_discrepancy_vs_images_presel(
                        bm_eff, cur_eff, imgs, source.poses_inv[:Ks], sel_idx, sel_valid,
                        fov, shape, diff_threshold=cfg.diff_threshold, reverse=reverse)
                elif self.mesh is not None:
                    flagged = block_sweep_discrepancy_vs_images_sharded(
                        self.mesh, bm_eff, cur_eff, imgs, source.poses_inv[:Ks],
                        source.poses[:Ks], fov, shape, k_blocks=kb_eff, max_range=mr_t,
                        diff_threshold=cfg.diff_threshold, reverse=reverse)
                else:
                    count_slots(kb_eff * bm_eff.block_capacity * Ks)
                    flagged = block_sweep_discrepancy_vs_images(
                        bm_eff, cur_eff, imgs, source.poses_inv[:Ks], source.poses[:Ks],
                        fov, shape, k_blocks=kb_eff, max_range=mr_t,
                        diff_threshold=cfg.diff_threshold, reverse=reverse)
                if dbm is not None:
                    # back to original map indices (a False pad row absorbs
                    # the sentinel slot)
                    flagged = cur & torch.cat([flagged, flagged.new_zeros(1)])[d_slots]
            elif self.mesh is not None:
                flagged = sweep_discrepancy_vs_images_sharded(
                    self.mesh, sess.map_xyz, cur, imgs, source.poses_inv[:Ks], fov, shape,
                    cfg.diff_threshold, reverse)
            else:
                flagged = sweep_discrepancy_vs_images(
                    sess.map_xyz, cur, imgs, source.poses_inv[:Ks], fov, shape,
                    cfg.diff_threshold, reverse)
            weak = weak | flagged
            cur = cur & ~flagged
            if count_repeats:
                n_cur = int(cur.sum())
                repeat_counts.append(n_cur)
        if count_repeats:
            log.info("filter_strong %s %s: candidates per repeat %s",
                     sess.sess_type, "ND" if reverse else "PD", repeat_counts)
        return cur, weak

    def _knn_stat(self, query_xyz, query_mask, target_xyz, target_mask, target_base=None):
        """Average of the k nearest squared distances.  Maps of at least
        ``chunk_knn_min_targets`` points take the chunked block kNN (clamped,
        exact at the pipeline's thresholds); the rest, and maps whose kNN
        block layout overflows, the brute force (on the card the k=2
        statistic is the CUDA 2-NN kernel).  ``target_base`` is the map's
        validity mask (every ``target_mask`` is a subset): the chunked path
        sizes its block layout by the real points."""
        cfg = self.cfg
        if cfg.use_chunk_knn and target_xyz.shape[0] >= cfg.chunk_knn_min_targets:
            st = self._chunk_knn_start(query_xyz, query_mask, target_xyz, target_mask, target_base)
            if st is not None:
                return self._chunk_knn_finish(*st)
        if cfg.use_grid_knn:
            return self._grid_knn_stat(query_xyz, query_mask, target_xyz, target_mask)
        if self.mesh is not None:
            return knn_avg_sqdist_sharded(self.mesh, query_xyz, query_mask, target_xyz,
                                          target_mask, k=cfg.num_knn_points, tile=8192)
        return chunked_knn_avg_sqdist(query_xyz, query_mask, target_xyz, target_mask,
                                      k=cfg.num_knn_points, tile=8192, query_chunk=16384)

    def _grid_knn_stat(self, query_xyz, query_mask, target_xyz, target_mask):
        """The grid-bucketed statistic (``ltm_torch.kernels.grid_knn``),
        clamped at ``grid_cell_size²``.  Raises, as ``ltm`` does, when the
        cell is too small for exact decisions at the pipeline's thresholds
        or a grid overflows (a full cell, too many cells, or coordinates
        past ±2^9 cells that clip into the edge cells)."""
        cfg = self.cfg
        max_t = max(cfg.knn_avg_sqdist_threshold, cfg.weak_to_strong_sqdist_threshold)
        if cfg.grid_cell_size ** 2 < cfg.num_knn_points * max_t:
            raise ValueError(
                f"grid_cell_size²={cfg.grid_cell_size**2} < k·max_threshold="
                f"{cfg.num_knn_points * max_t}: grid kNN decisions would be inexact")
        qg, o1 = build_grid_buckets(query_xyz, query_mask, cfg.grid_cell_size,
                                    cfg.grid_n_cells, cfg.grid_cell_capacity)
        tg, o2 = build_grid_buckets(target_xyz, target_mask, cfg.grid_cell_size,
                                    cfg.grid_n_cells, cfg.grid_cell_capacity)
        if o1 or o2:
            raise ValueError(
                f"grid kNN overflow (query {o1}, target {o2} pts dropped); raise "
                f"grid_n_cells ({cfg.grid_n_cells}) or grid_cell_capacity "
                f"({cfg.grid_cell_capacity})")
        d = grid_knn2_sqdists(qg, tg, num_queries=query_xyz.shape[0], k=cfg.num_knn_points)
        return d.mean(-1)

    def _knn_block_map(self, target_xyz, target_base=None):
        """kNN-grained block layout of a map and its slots (original index ->
        flat slot), built once per map: ``chunk_knn_block_cell`` cells, the
        block count the pow-2 bucket of the real points x
        ``chunk_knn_block_slack`` over the capacity.  (None, None) when the
        build overflows, so the caller goes brute."""
        hit = self._kbm_cache.get(target_xyz)
        if hit is not None:
            return hit
        cfg = self.cfg
        cap = cfg.chunk_knn_block_capacity
        if target_base is None:
            base = torch.ones((target_xyz.shape[0],), dtype=torch.bool, device=target_xyz.device)
            n_real = target_xyz.shape[0]
        else:
            base, n_real = target_base, int(target_base.sum())
        need = max((n_real * cfg.chunk_knn_block_slack + cap - 1) // cap, 1)
        kbm, ov, slots = build_block_map_with_slots(
            target_xyz, base, cfg.chunk_knn_block_cell, 1 << (need - 1).bit_length(), cap)
        if ov > 0:
            log.warning("chunk kNN block build overflow (%d pts); brute fallback", ov)
            kbm = slots = None
        return self._kbm_cache.put(target_xyz, (kbm, slots))

    def _chunk_knn_start(self, query_xyz, query_mask, target_xyz, target_mask, target_base=None):
        """Launch the chunked kNN against the map's cached block layout, with
        ``target_mask`` as the subset in layout order.  Returns the state
        :meth:`_chunk_knn_finish` takes, or None when the layout could not be
        built."""
        cfg = self.cfg
        kbm, slots = self._knn_block_map(target_xyz, target_base)
        if kbm is None:
            return None
        max_t = max(cfg.knn_avg_sqdist_threshold, cfg.weak_to_strong_sqdist_threshold)
        clamp = float(np.sqrt(cfg.num_knn_points * max_t))
        # target subset in layout order (slot n_blocks*cap is the sentinel of
        # dropped points, cut off)
        flat = kbm.num_blocks * kbm.block_capacity
        extra = torch.zeros((flat + 1,), dtype=torch.bool, device=target_xyz.device)
        extra[slots] = target_mask
        extra = extra[:flat]
        kb = min(cfg.chunk_knn_k_blocks, kbm.num_blocks)
        res = self._chunk_knn(query_xyz, query_mask, kbm, extra, clamp, k_blocks=kb)
        return res, kbm, extra, clamp, kb, query_xyz, query_mask, target_xyz, target_mask

    def _chunk_knn(self, query_xyz, query_mask, kbm, extra, clamp, k_blocks):
        """One chunked kNN call at the config's chunk, k and sort cell:
        chunk-sharded on a mesh, else on the one device."""
        cfg = self.cfg
        args = (query_xyz, query_mask, kbm, extra, clamp)
        kw = dict(k=cfg.num_knn_points, chunk=cfg.chunk_knn_chunk, k_blocks=k_blocks,
                  sort_cell=cfg.chunk_knn_sort_cell)
        if self.mesh is not None:
            return chunk_knn_sqdists_sharded(self.mesh, *args, **kw)
        return chunk_knn_sqdists(*args, **kw)

    def _chunk_knn_finish(self, res, kbm, extra, clamp, kb, query_xyz, query_mask,
                          target_xyz, target_mask):
        """The statistic of a chunked kNN call, with its overflowed chunks
        re-resolved: their queries re-run at ``k_blocks x 8`` (a seam or
        map-edge chunk needs more blocks, not a shorter chunk), and the
        queries of chunks that still overflow go brute force, clamped.
        Decisions stay exact at every pipeline threshold."""
        cfg = self.cfg
        d = res.sqdists.mean(-1)
        bad = np.flatnonzero(res.chunk_overflow.cpu().numpy())
        if not bad.size:
            return d
        ch, dev = cfg.chunk_knn_chunk, query_xyz.device
        # original indices of the queries in overflowed chunks
        pos = (bad[:, None] * ch + np.arange(ch)).ravel()
        idx = res.order.cpu().numpy()[pos[pos < query_xyz.shape[0]]].astype(np.int64)
        escalated, idx_brute = idx[:0], idx
        kb2 = min(kb * 8, kbm.num_blocks)
        if kb2 > kb:
            escalated = idx
            idx_t = torch.from_numpy(idx).to(dev)
            sub_mask = query_mask[idx_t]
            res2 = self._chunk_knn(query_xyz[idx_t], sub_mask, kbm, extra, clamp, k_blocks=kb2)
            bad2 = np.flatnonzero(res2.chunk_overflow.cpu().numpy())
            log.info("chunk kNN: %d/%d chunks escalated to k_blocks=%d (%d queries, "
                     "%d chunks still over)", bad.size, res.chunk_overflow.shape[0], kb2,
                     idx.size, bad2.size)
            d[idx_t] = torch.where(sub_mask, res2.sqdists.mean(-1), d[idx_t])
            # positions past idx.size are the last chunk's padding
            pos2 =(bad2[:, None] * ch + np.arange(ch)).ravel()
            idx_brute = idx[res2.order.cpu().numpy()[pos2[pos2 < idx.size]]]
        if idx_brute.size:
            idx_t = torch.from_numpy(idx_brute).to(dev)
            sub_mask = query_mask[idx_t]
            d_sub = chunked_knn_avg_sqdist(query_xyz[idx_t], sub_mask, target_xyz, target_mask,
                                           k=cfg.num_knn_points)
            d_sub = torch.minimum(d_sub, torch.tensor(clamp * clamp, dtype=torch.float32,
                                                      device=dev))
            d[idx_t] = torch.where(sub_mask, d_sub, d[idx_t])
            log.info("chunk kNN: %d queries brute-forced", idx_brute.size)
        self.chunk_knn_fallbacks.append({"escalated": escalated, "brute": idx_brute})
        return d

    def _propagate_weak_to_strong(self, sess: RemovertSession, strong, weak):
        """``removeWeakNDMapPointsHavingStrongNDInNear``
        (``Session.cpp:452-484``): weak points whose 2-NN average squared
        distance to the strong set is below 1 m² join the strong set."""
        if not int(strong.sum()):
            return strong, weak
        d = self._knn_stat(sess.map_xyz, weak, sess.map_xyz, strong, target_base=sess.map_mask)
        promote = weak & (d < self.cfg.weak_to_strong_sqdist_threshold)
        return strong | promote, weak & ~promote

    # ------------------------------------------------------------------
    # artifacts (reference save tree, Removerter.cpp:30-50,1442-1650)
    # ------------------------------------------------------------------
    @staticmethod
    def _all_keyframe_winners(sets, pose_invs, fov, shape):
        """For each keyframe, the winners of each ``(xyz, mask)`` set in that
        keyframe's range image, as host (M, 3) arrays in its lidar frame: one
        tuple a keyframe, so no (K, N, 3) stack is ever held."""
        for Tinv in pose_invs:
            out = []
            for xyz, mask in sets:
                local = apply_pose(xyz, Tinv)
                out.append(local[winner_mask(local, mask, fov, shape)[0]].cpu().numpy())
            yield tuple(out)

    def _high_dyn_points(self, sess: RemovertSession) -> np.ndarray:
        """``extractHighDynPointsViaKnnDiff`` (``Removerter.cpp:1591-1602``):
        the scan points of every keyframe, in the global frame, whose kNN
        statistic against the session's static map reaches the threshold,
        one per voxel.  At full width the largest kNN call of a run."""
        cfg = self.cfg
        K = sess.num_keyframes
        moved = transform(sess.scans_xyz[:K], sess.poses[:K, None, :3, :3], sess.poses[:K, None, :3, 3])
        flat = moved.reshape(-1, 3)
        fmask = sess.scans_mask[:K].reshape(-1)
        d = self._knn_stat(flat, fmask, sess.map_xyz, sess.masks["static"], target_base=sess.map_mask)
        pts = flat[fmask & (d >= cfg.knn_avg_sqdist_threshold)]
        if len(pts):
            pts = pts[voxel_unique_mask(pts, torch.ones_like(pts[:, 0], dtype=torch.bool),
                                        cfg.downsample_voxel_size)]
        return pts.cpu().numpy()

    def _save_artifacts(self, result: RemovertResult, out_dir: str, fov) -> None:
        """The reference's save tree: the global maps and their
        per-resolution snapshots, the high-dynamic scan points, optional
        range-image PNGs and the per-keyframe scan-wise updates."""
        cfg = self.cfg
        for sub in ("scans_updated", "scans_updated_strong", "scans_pd", "scans_pd_strong",
                    "scans_nd_strong", "map_static", "map_dynamic"):
            os.makedirs(os.path.join(out_dir, sub), exist_ok=True)
        c, q = result.central, result.query

        def save(name, pts):
            write_pcd(os.path.join(out_dir, name), pts)

        if cfg.save_map_pcd:
            save("OriginalNoisyCentralMapGlobal.pcd", c.map_xyz[c.map_mask].cpu().numpy())
            save("OriginalNoisyQueryMapGlobal.pcd", q.map_xyz[q.map_mask].cpu().numpy())
            # the reference saves after every removal resolution
            # (Removerter.cpp:318-338)
            for sess, tag in ((c, "Central"), (q, "Query")):
                for res in cfg.remove_resolution_list:
                    sm = sess.masks.get(f"static@{res}")
                    if sm is None:
                        continue
                    dm = sess.masks[f"dynamic@{res}"]
                    save(f"map_static/{tag}StaticMapMapsideGlobalResX{res}.pcd",
                         sess.map_xyz[sm].cpu().numpy())
                    save(f"map_dynamic/{tag}DynamicMapMapsideGlobalResX{res}.pcd",
                         sess.map_xyz[dm].cpu().numpy())
            for fname, name in (("union_map_centralside", "coexist_c"),
                                ("union_map_queryside", "coexist_q"), ("nd_map", "nd"),
                                ("pd_map", "pd"), ("strong_nd_map", "nd_strong"),
                                ("weak_nd_map", "nd_weak"), ("strong_pd_map", "pd_strong"),
                                ("weak_pd_map", "pd_weak"), ("updated_map", "updated"),
                                ("updated_map_strong", "updated_strong")):
                save(f"{fname}.pcd", result.points(name))

        if cfg.save_high_dyn_maps:
            save("central_sess_high_dyn.pcd", self._high_dyn_points(c))
            save("query_sess_high_dyn.pcd", self._high_dyn_points(q))

        if cfg.save_range_image_pngs:
            from ltm_torch.utils.viz import save_range_image_png, write_rimg_index

            shape = rimg_shape(fov, cfg.remove_resolution_list[0])
            rows = []
            for k in (0, c.num_keyframes // 2):
                scan_img = range_image(c.scans_xyz[k], c.scans_mask[k], fov, shape)
                map_img = range_image(apply_pose(c.map_xyz, c.poses_inv[k]), c.map_mask, fov, shape)
                scan_img, map_img = (x.reshape(shape).cpu().numpy() for x in (scan_img, map_img))
                diff = np.where((scan_img < NO_POINT) & (map_img < NO_POINT),
                                scan_img - map_img, NO_POINT)
                for kind, img, lo, hi in (("scan", scan_img, cfg.rimg_color_min, cfg.rimg_color_max),
                                          ("map", map_img, cfg.rimg_color_min, cfg.rimg_color_max),
                                          ("diff", diff, -2.0, 2.0)):
                    save_range_image_png(os.path.join(out_dir, f"rimg_{kind}_{k:04d}.png"), img,
                                         vmin=lo, vmax=hi)
                rows.append((k, c.names[k]))
            write_rimg_index(os.path.join(out_dir, "rimg_index.html"), rows)

        if not cfg.save_clean_scans_pcd:
            return
        # scan-wise updates of the central session (Removerter.cpp:1540-1650)
        m = result.masks
        sets = ((result.combined_xyz, m["updated"]), (result.combined_xyz, m["updated_strong"]),
                (q.map_xyz, m["pd"]), (q.map_xyz, m["pd_strong"]),
                (c.map_xyz, m["nd_weak"]), (c.map_xyz, m["nd_strong"]))
        K = c.num_keyframes
        winners = self._all_keyframe_winners(sets, c.poses_inv[:K], fov,
                                             rimg_shape(fov, cfg.reprojection_alpha))
        for name, (upd, upd_s, pd, pd_s, nd_w, nd_s) in zip(c.names, winners):
            # final per-scan update = updated + weak ND + PD, one point a
            # voxel (Session::updateScansScanwise, Session.cpp:362-380)
            pts = np.concatenate([upd, nd_w, pd])
            if len(pts):
                pts_t = torch.from_numpy(pts)
                pts = pts[voxel_unique_mask(pts_t, torch.ones(len(pts), dtype=torch.bool),
                                            cfg.downsample_voxel_size).numpy()]
            for sub, p in (("scans_updated", pts), ("scans_updated_strong", upd_s),
                           ("scans_pd", pd), ("scans_pd_strong", pd_s),
                           ("scans_nd_strong", nd_s)):
                write_pcd(os.path.join(out_dir, sub, name), p)
