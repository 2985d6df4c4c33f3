"""LT-removert + LT-map: dynamic removal, change detection, map update
(port of ``ltm.removert.pipeline`` on one device).

Reference: ``Removerter::run`` (``ltremovert/src/Removerter.cpp:1653-1678``):
  Step 0 prep (load, parse keyframes, preclean, global maps)
  Step 1 high-dynamic removal (self visibility check per session)
  Step 2 low-dynamic PD/ND change detection (cross-session kNN + 3×
         visibility re-checks → strong/weak split, weak→strong propagation)
  Step 3 LT-map composition (union + weak-ND + PD).

Each session's global map is ONE padded tensor and every stage is a boolean
mask over it.  The visibility sweeps stream keyframes through scatter-min
projections over the block layout (``ltm_torch.kernels.blocks``); the kNN
stages go through the hand-written CUDA 2-NN kernel on the card
(``ltm_torch.kernels.knn2``).

Not ported yet, and refused with ``NotImplementedError`` rather than run
differently: the chunked block kNN (``use_chunk_knn`` at map scale), the
device mesh, occlusion culling, grid kNN, the self-removert loop and saving
artifacts.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch

from ltm_torch.core.config import RemovertConfig
from ltm_torch.device import resolve_device
from ltm_torch.kernels.blocks import (
    block_fused_visibility_images,
    block_sweep_discrepancy,
    block_sweep_discrepancy_vs_images,
    build_block_map_with_slots,
    required_k_blocks_np,
)
from ltm_torch.kernels.knn import chunked_knn_avg_sqdist
from ltm_torch.kernels.projection import (
    VALID_DIFF_UB,
    fused_visibility_images,
    rimg_shape,
    sweep_discrepancy,
    sweep_discrepancy_vs_images,
)
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


def _check_supported(cfg: RemovertConfig) -> None:
    later = {
        "mesh_devices": cfg.mesh_devices not in (None, 0, 1),
        "use_occlusion_culling": cfg.use_occlusion_culling,
        "use_grid_knn": cfg.use_grid_knn,
        "use_self_removert": cfg.use_self_removert,
    }
    for name, on in later.items():
        if on:
            raise NotImplementedError(f"{name} is ported in a later slice (the opt-in "
                                      f"and multi-device paths); unset it")


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

    # ------------------------------------------------------------------
    def run(self, central_inp: RemovertInput, query_inp: RemovertInput,
            save_directory: Optional[str] = None) -> RemovertResult:
        cfg = self.cfg
        _check_supported(cfg)
        if save_directory:
            raise NotImplementedError("saving artifacts is ported with the CLI in a later "
                                      "slice; pass save_directory=None")
        fov = (cfg.vfov, cfg.hfov)

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
        return RemovertResult(central=central, query=query, combined_xyz=comb_xyz, masks=masks)

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
        if sess.bm is not None:
            kb, mr = self._kb(sess.bm, self._vis_bound(sess))
            count_slots(kb * sess.bm.block_capacity * K)
            win, imgs = block_fused_visibility_images(
                sess.bm, sess.masks["static"], sess.poses_inv[:K], sess.poses[:K],
                fov, shape, proj_shape, k_blocks=kb, max_range=mr, scale=scale)
        else:
            win, imgs = fused_visibility_images(
                sess.map_xyz, sess.masks["static"], sess.poses_inv[:K],
                fov, shape, proj_shape, scale=scale)
        sess.masks["proj_static"] = win
        self._img_cache.put(sess, imgs)

    def _sweep(self, sess: RemovertSession, mask, fov, res):
        shape = rimg_shape(fov, res)
        K = sess.num_keyframes  # padded keyframes are masked but not free
        if sess.bm is not None:
            bm = sess.bm._replace(mask=mask.reshape(sess.bm.mask.shape))
            kb, mr = self._kb(sess.bm, self._fwd_bound(sess))
            count_slots(kb * sess.bm.block_capacity * K)
            return block_sweep_discrepancy(
                bm, sess.scans_xyz[:K], sess.scans_mask[:K], sess.poses_inv[:K],
                sess.poses[:K], fov, shape, k_blocks=kb, max_range=mr,
                diff_threshold=self.cfg.diff_threshold, reverse=False)
        return sweep_discrepancy(
            sess.map_xyz, mask, sess.scans_xyz[:K], sess.scans_mask[:K],
            sess.poses_inv[:K], fov, shape, self.cfg.diff_threshold, False)

    def _remove_high_dynamic(self, sess: RemovertSession, fov) -> None:
        """``removeHighDynamicPoints`` (``Removerter.cpp:1580-1604``): one
        ``removeOnce`` per configured resolution (the reference run() does
        ``removeOnce(sess, sess, 2.5)``, ``:1584``)."""
        cur = sess.map_mask
        dynamic = torch.zeros_like(cur)
        for res in self.cfg.remove_resolution_list:
            dyn = self._sweep(sess, cur, fov, res)
            cur, dynamic = cur & ~dyn, dynamic | dyn
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
        d = self._knn_stat(sess.map_xyz, eligible, other.map_xyz, other.masks["static"])
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
        for r in range(cfg.nd_pd_filter_repeats):
            if use_blocks and n_cur == 0:
                break   # nothing left to re-check (flagged ⊆ cur always)
            if dbm is not None and r > 0 and _delta_blocks(n_cur) < dbm.num_blocks:
                built = _build_delta(cur, n_cur)
                if built is not None:       # on overflow keep the old layout
                    dbm, d_slots, kb_eff = built
            if dbm is not None:
                # layout-space mask of the current survivors (d_slots: orig
                # index -> flat delta slot; the sentinel slot is cut off)
                n_flat = dbm.num_blocks * dbm.block_capacity
                cur_l = torch.zeros((n_flat + 1,), dtype=torch.bool, device=cur.device)
                cur_l[d_slots] = cur
                count_slots(kb_eff * dbm.block_capacity * Ks)
                flagged_l = block_sweep_discrepancy_vs_images(
                    dbm, cur_l[:n_flat], imgs, source.poses_inv[:Ks], source.poses[:Ks],
                    fov, shape, k_blocks=kb_eff, max_range=mr_t,
                    diff_threshold=cfg.diff_threshold, reverse=reverse)
                # back to original map indices (a False pad row absorbs the
                # sentinel slot)
                flagged = cur & torch.cat([flagged_l, flagged_l.new_zeros(1)])[d_slots]
            elif use_blocks:
                count_slots(kb_eff * sess.bm.block_capacity * Ks)
                flagged = block_sweep_discrepancy_vs_images(
                    sess.bm, cur, imgs, source.poses_inv[:Ks], source.poses[:Ks],
                    fov, shape, k_blocks=kb_eff, max_range=mr_t,
                    diff_threshold=cfg.diff_threshold, reverse=reverse)
            else:
                flagged = sweep_discrepancy_vs_images(
                    sess.map_xyz, cur, imgs, source.poses_inv[:Ks], fov, shape,
                    cfg.diff_threshold, reverse)
            weak = weak | flagged
            cur = cur & ~flagged
            if use_blocks:
                n_cur = int(cur.sum())
                repeat_counts.append(n_cur)
        if use_blocks:
            log.info("filter_strong %s %s: candidates per repeat %s",
                     sess.sess_type, "ND" if reverse else "PD", repeat_counts)
        return cur, weak

    def _knn_stat(self, query_xyz, query_mask, target_xyz, target_mask):
        """Average of the k nearest squared distances (brute force; on the
        card the k=2 statistic is the CUDA 2-NN kernel)."""
        cfg = self.cfg
        if cfg.use_chunk_knn and target_xyz.shape[0] >= cfg.chunk_knn_min_targets:
            raise NotImplementedError("chunk kNN is ported in a later slice; set use_chunk_knn=False")
        return chunked_knn_avg_sqdist(query_xyz, query_mask, target_xyz, target_mask,
                                      k=cfg.num_knn_points, tile=8192, query_chunk=16384)

    def _propagate_weak_to_strong(self, sess: RemovertSession, strong, weak):
        """``removeWeakNDMapPointsHavingStrongNDInNear``
        (``Session.cpp:452-484``): weak points whose 2-NN average squared
        distance to the strong set is below 1 m² join the strong set."""
        if not int(strong.sum()):
            return strong, weak
        d = self._knn_stat(sess.map_xyz, weak, sess.map_xyz, strong)
        promote = weak & (d < self.cfg.weak_to_strong_sqdist_threshold)
        return strong | promote, weak & ~promote
