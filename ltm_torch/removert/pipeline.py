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

Not ported yet, and refused with ``NotImplementedError`` rather than run
differently: a device mesh of more than one device, occlusion culling, grid
kNN and the self-removert loop.
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
from ltm_torch.io.pcd import write_pcd
from ltm_torch.kernels.blocks import (
    block_fused_visibility_images,
    block_sweep_discrepancy,
    block_sweep_discrepancy_vs_images,
    build_block_map_with_slots,
    required_k_blocks_np,
)
from ltm_torch.kernels.chunk_knn import chunk_knn_sqdists
from ltm_torch.kernels.knn import chunked_knn_avg_sqdist
from ltm_torch.kernels.projection import (
    NO_POINT,
    VALID_DIFF_UB,
    apply_pose,
    fused_visibility_images,
    range_image,
    rimg_shape,
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


def mesh_size(mesh_devices: Optional[int], device: torch.device) -> int:
    """Devices the hot loops would shard over, by ``ltm``'s contract for
    ``cfg.mesh_devices``: None, 0 or 1 one device, -1 every local device
    (the CUDA cards, or one CPU), n that many."""
    if mesh_devices in (None, 0, 1):
        return 1
    if mesh_devices == -1:
        return torch.cuda.device_count() if device.type == "cuda" else 1
    return mesh_devices


def _check_supported(cfg: RemovertConfig, device: torch.device) -> None:
    later = {
        "mesh_devices": mesh_size(cfg.mesh_devices, device) > 1,
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
        # map -> (kNN block layout, slots), built once per map (_knn_block_map)
        self._kbm_cache = _IdCache()
        # one entry per chunk-kNN call that overflowed: the original indices
        # of its escalated and brute-forced queries (_chunk_knn_finish)
        self.chunk_knn_fallbacks: list = []

    # ------------------------------------------------------------------
    def run(self, central_inp: RemovertInput, query_inp: RemovertInput,
            save_directory: Optional[str] = None) -> RemovertResult:
        cfg = self.cfg
        _check_supported(cfg, self.device)
        fov = (cfg.vfov, cfg.hfov)
        self._kbm_cache = _IdCache()
        self.chunk_knn_fallbacks = []

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
        return chunked_knn_avg_sqdist(query_xyz, query_mask, target_xyz, target_mask,
                                      k=cfg.num_knn_points, tile=8192, query_chunk=16384)

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
        res = chunk_knn_sqdists(query_xyz, query_mask, kbm, extra, clamp, k=cfg.num_knn_points,
                                chunk=cfg.chunk_knn_chunk, k_blocks=kb,
                                sort_cell=cfg.chunk_knn_sort_cell)
        return res, kbm, extra, clamp, kb, query_xyz, query_mask, target_xyz, target_mask

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
            res2 = chunk_knn_sqdists(query_xyz[idx_t], sub_mask, kbm, extra, clamp,
                                     k=cfg.num_knn_points, chunk=ch, k_blocks=kb2,
                                     sort_cell=cfg.chunk_knn_sort_cell)
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
