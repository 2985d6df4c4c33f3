"""LT-SLAM: multi-session anchor-node pose-graph alignment (port of
``ltm.slam.pipeline``).

Reference: ``LTslam::run`` (``ltslam/src/LTslam.cpp:79-98``): load sessions →
central graph → optimize → SC loops (+ICP) → optimize → RS loops (info gain
+ ICP) → optimize → write trajectories.  As in ``ltm``:

  * loop retrieval is one dense batched Scan Context scoring call;
  * ICP verification runs as batches of fixed-shape ICP lanes (the
    lane-compacted farm once there are more than 8 pairs);
  * optimization is the batch LM/PCG solver (``ltm_torch.graph.solver``);
  * the 1e-12-variance gauge priors (``LTslam.cpp:565-576,591-594``) are
    frozen variables;
  * anchored loop measurements use ``measured = Between(central target
    pose, central source pose)``.

RS ("radius-search") loops implement the information-gain selection of
``findNearestRSLoopsTargetNodeIdx`` / ``calcInformationGainBtnTwoNodes``
(``LTslam.cpp:419-505``) with CG marginals and ``torch.func`` Jacobians.
Stage names are ``ltm``'s, so stage walls compare.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.func import jacfwd, vmap

from ltm_torch.core import se3
from ltm_torch.core.config import LTSlamConfig
from ltm_torch.device import resolve_device
from ltm_torch.graph.factors import build_graph_data
from ltm_torch.graph.solver import marginal_covariance, solve
from ltm_torch.io.poses import write_kitti_poses
from ltm_torch.io.sessions import SessionData
from ltm_torch.kernels.voxel import voxel_downsample_representative_capped
from ltm_torch.register.icp import icp_batch, icp_batch_compacted
from ltm_torch.removert.pipeline import mesh_size
from ltm_torch.retrieval import scancontext as sc_retrieval
from ltm_torch.slam.session import SlamSession, assemble_submap, auto_scan_capacity
from ltm_torch.utils import get_logger, stage_timer

__all__ = ["LTSlam", "LTSlamResult"]

log = get_logger("ltm_torch.slam")


@dataclass
class LTSlamResult:
    anchors: Dict[str, np.ndarray]            # session -> (4,4)
    local_poses: Dict[str, np.ndarray]        # session -> (N,4,4)
    central_poses: Dict[str, np.ndarray]      # session -> (N,4,4)
    num_sc_loops: int = 0
    num_rs_loops: int = 0
    diagnostics: Dict = field(default_factory=dict)


class LTSlam:
    """Central/query alignment, generalized to N sessions (session 0 is the
    base).  ``device=None`` runs on the CUDA card; ``cfg.mesh_devices``
    above one device raises until the multi-device paths are ported."""

    def __init__(self, cfg: Optional[LTSlamConfig] = None, device=None):
        self.cfg = cfg or LTSlamConfig()
        self.device = resolve_device(device)
        if mesh_size(self.cfg.mesh_devices, self.device) > 1:
            raise NotImplementedError("mesh_devices is ported in a later slice (the "
                                      "multi-device paths); unset it")
        # ICP iterations of every pair the farm ran, in order (diagnostics)
        self.icp_iterations: List[int] = []

    # variable layout: [anchors 0..n_sessions-1, session-0 nodes, session-1
    # nodes, ...]; session 0 is the base/central session
    def _node_var(self, sess_idx: int, node: int) -> int:
        return self.n_sessions + sess_idx * self.nodes_cap + node

    def _anchor_var(self, sess_idx: int) -> int:
        return sess_idx

    # ------------------------------------------------------------------
    def run(self, central: SessionData, query: SessionData,
            save_directory: Optional[str] = None) -> LTSlamResult:
        """Two-session central/query alignment (the reference configuration)."""
        return self.run_multi([central, query], save_directory=save_directory)

    def _load_sessions(self, session_data: List[SessionData]) -> None:
        """``self.sessions`` with shared node, scan and ICP-row capacities —
        the ``ltslam.load`` stage."""
        cfg = self.cfg
        with stage_timer("ltslam.load", log):
            n_max = max((d.num_nodes for d in session_data), default=1)
            auto = 1 << max(3, (max(n_max, 1) - 1).bit_length())
            n_cap = cfg.max_nodes_per_session if cfg.max_nodes_per_session else auto
            if n_max > n_cap:
                log.warning("max_nodes_per_session=%d < %d nodes — escalating "
                            "capacity to %d", n_cap, n_max, auto)
                n_cap = auto
            self.nodes_cap = n_cap
            s_cap = cfg.scan_capacity
            if s_cap is None:
                s_cap = auto_scan_capacity(session_data)
                log.info("scan_capacity auto-sized to %d (largest scan, pow-2)", s_cap)
            self.sessions = [
                SlamSession.from_session_data(d, cfg, is_base=(i == 0), n_cap=n_cap,
                                              s_cap=s_cap, device=self.device)
                for i, d in enumerate(session_data)
            ]
            # shared ICP-row capacity: pow-2 bucket of the largest per-scan
            # voxel count (lossless trim)
            icp_cap = 1 << max(9, (max((s.max_icp_voxels for s in self.sessions),
                                       default=1) - 1).bit_length())
            icp_cap = min(icp_cap, s_cap)
            for s in self.sessions:
                s.trim_icp_scans(icp_cap)
        self.n_sessions = len(self.sessions)
        self.diag = {}

    def run_multi(self, session_data: List[SessionData],
                  save_directory: Optional[str] = None) -> LTSlamResult:
        """Joint N-session alignment: every other session is tied to session 0
        through its own anchor via SC/RS loops, all anchors and nodes
        optimize in one graph."""
        cfg = self.cfg
        self.icp_iterations = []
        self._load_sessions(session_data)
        if cfg.use_intra_session_loops:
            with stage_timer("ltslam.intra_loops", log):
                for s_idx, sess in enumerate(self.sessions):
                    ef, et, _ = sess.edges
                    if not any(abs(int(et[k]) - int(ef[k])) != 1 for k in range(len(ef))):
                        self._add_intra_session_loops(s_idx)
        self._init_graph()

        with stage_timer("ltslam.optimize.initial", log):
            self._optimize()
        if save_directory:
            self._write_trajectories(save_directory, "bfr_intersession_loops")

        n_sc = 0
        all_rs_candidates = {}
        with stage_timer("ltslam.sc_loops", log):
            for s_idx in range(1, self.n_sessions):
                sc_pairs, rs_candidates, sc_yaws = self._detect_sc_loops(s_idx)
                n_sc += self._add_sc_loops(s_idx, sc_pairs, sc_yaws)
                all_rs_candidates[s_idx] = rs_candidates
            if cfg.pairwise_session_loops:
                for t_idx in range(1, self.n_sessions):
                    for s_idx in range(t_idx + 1, self.n_sessions):
                        sc_pairs, _, sc_yaws = self._detect_sc_loops(s_idx, t_idx)
                        n_sc += self._add_sc_loops(s_idx, sc_pairs, sc_yaws, target_idx=t_idx)
        with stage_timer("ltslam.optimize.sc", log):
            self._optimize()

        n_rs = 0
        if cfg.num_rs_loops_upper_bound > 0:
            with stage_timer("ltslam.rs_loops", log):
                for s_idx, rs_candidates in all_rs_candidates.items():
                    if rs_candidates:
                        n_rs += self._add_rs_loops(s_idx, rs_candidates)
            if n_rs:
                with stage_timer("ltslam.optimize.rs", log):
                    self._optimize()

        if save_directory:
            self._write_trajectories(save_directory, "aft_intersession_loops")

        return LTSlamResult(
            anchors={s.name: self.anchors[i] for i, s in enumerate(self.sessions)},
            local_poses={s.name: s.poses_local[: s.num_nodes] for s in self.sessions},
            central_poses={
                s.name: np.einsum("ij,njk->nik", self.anchors[i], s.poses_local[: s.num_nodes])
                for i, s in enumerate(self.sessions)
            },
            num_sc_loops=n_sc,
            num_rs_loops=n_rs,
            diagnostics=self.diag,
        )

    # ------------------------------------------------------------------
    # graph assembly & optimization
    # ------------------------------------------------------------------
    def _init_graph(self):
        cfg = self.cfg
        V = self.n_sessions * (1 + self.nodes_cap)
        self.poses0 = np.tile(np.eye(4, dtype=np.float32), (V, 1, 1))
        self.fixed = np.zeros(V, bool)
        self.fixed[self._anchor_var(0)] = True            # base anchor == origin
        self.priors: List = []
        self.betweens: List = []
        self.anchored: List = []
        self.anchors = [np.eye(4) for _ in range(self.n_sessions)]
        self.diag = getattr(self, "diag", {})

        for s_idx, sess in enumerate(self.sessions):
            n = sess.num_nodes
            base = self._node_var(s_idx, 0)
            self.poses0[base: base + n] = sess.poses_local[:n]
            self.fixed[base] = True              # gauge: first node pinned (1e-12 prior in the ref)
            if not sess.is_base:
                self.priors.append((self._anchor_var(s_idx), np.eye(4), cfg.large_variances))
            ef, et, er = sess.edges
            for k in range(len(ef)):
                i, j = int(ef[k]), int(et[k])
                odom = abs(j - i) == 1
                self.betweens.append((self._node_var(s_idx, i), self._node_var(s_idx, j), er[k],
                                      cfg.odom_variances if odom else cfg.robust_variances,
                                      not odom))

        self._between_capacity = max(len(self.betweens) + 8, 1)
        per_pair = cfg.num_sc_loops_upper_bound + max(cfg.num_rs_loops_upper_bound, 16)
        n_pairs = self.n_sessions - 1
        if cfg.pairwise_session_loops:
            n_pairs += (self.n_sessions - 1) * (self.n_sessions - 2) // 2
        self._anchored_capacity = max(per_pair * n_pairs, 1)

    def _build_graph(self):
        return build_graph_data(self.poses0, self.fixed, priors=self.priors,
                                betweens=self.betweens, anchored=self.anchored,
                                prior_capacity=max(self.n_sessions, 4),
                                between_capacity=self._between_capacity,
                                anchored_capacity=self._anchored_capacity, device=self.device)

    def _optimize(self):
        g = self._build_graph()
        poses, info = solve(g, self.cfg.solver)
        host = poses.cpu()
        self._estimates = host.double().numpy()
        self.poses0 = host.numpy().astype(np.float32)        # warm start next round
        self._last_graph = g
        self._last_poses = poses
        log.info("optimize: cost %.4g -> %.4g in %d LM iters",
                 float(info.cost_initial), float(info.cost_final), int(info.iterations))
        # refresh session estimates (reference updateSessionsPoses / updateKeyPoses)
        for s_idx, sess in enumerate(self.sessions):
            self.anchors[s_idx] = self._estimates[self._anchor_var(s_idx)]
            base = self._node_var(s_idx, 0)
            sess.poses_local = self._estimates[base: base + sess.num_nodes]

    # ------------------------------------------------------------------
    # SC loops
    # ------------------------------------------------------------------
    def _detect_sc_loops(self, source_idx: int = 1, target_idx: int = 0):
        target, source = self.sessions[target_idx], self.sessions[source_idx]
        loop_idx, _, yaw = sc_retrieval.detect_loops_between_sessions(
            source.descriptors, source.node_valid, target.descriptors, target.node_valid,
            **sc_retrieval.config_kwargs(self.cfg.scan_context))
        loop_idx = loop_idx.cpu().numpy()
        yaw = yaw.cpu().numpy()
        pairs = [(int(loop_idx[s]), s) for s in range(source.num_nodes) if loop_idx[s] >= 0]
        misses = [s for s in range(source.num_nodes) if loop_idx[s] < 0]
        yaws = {s: float(yaw[s]) for s in range(source.num_nodes)}
        log.info("SC retrieval %s->%s: %d loops, %d misses", source.name, target.name,
                 len(pairs), len(misses))
        self.diag[f"sc_pairs_found_{source.name}"] = len(pairs)
        return pairs, misses, yaws

    @staticmethod
    def _equisample(pairs: List, upper: int) -> List:
        """``equisampleElements`` (``LTslam.cpp:353-368``) with a float gap,
        which spreads picks over the whole trajectory."""
        n_all = len(pairs)
        n_add = min(n_all, upper)
        if n_add == 0:
            return []
        gap = n_all / n_add
        return [pairs[min(int(round(i * gap)), n_all - 1)] for i in range(n_add)]

    def _prepare_icp_pair(self, s_idx_src: int, node_src: int, s_idx_tgt: int, node_tgt: int,
                          central_coords: bool):
        """Source scan + ±search submap, both voxel-filtered, fixed shapes."""
        icp_cfg = self.cfg.icp
        src_sess = self.sessions[s_idx_src]
        tgt_sess = self.sessions[s_idx_tgt]
        # source: one keyframe scan, its pre-filtered rows capped to the
        # source capacity (``downSizeFilterICP``, ``ltslam/src/Session.cpp:109-114``)
        src_xyz, src_mask, _ = voxel_downsample_representative_capped(
            src_sess.scans_icp_xyz[node_src], src_sess.scans_icp_mask[node_src],
            icp_cfg.submap_voxel_size, icp_cfg.source_capacity)

        # target: ±history_search_num neighbours in the target node's frame
        k = icp_cfg.history_search_num
        neigh = np.arange(node_tgt - k, node_tgt + k + 1)
        valid = (neigh >= 0) & (neigh < tgt_sess.num_nodes)
        neigh_c = np.clip(neigh, 0, tgt_sess.num_nodes - 1)
        if central_coords:
            anchor_t = self.anchors[s_idx_tgt]
            T_tgt = anchor_t @ tgt_sess.poses_local[node_tgt]
            rel = np.stack([np.linalg.inv(T_tgt) @ anchor_t @ tgt_sess.poses_local[i]
                            for i in neigh_c])
        else:
            T_tgt = tgt_sess.poses_local[node_tgt]
            rel = np.stack([np.linalg.inv(T_tgt) @ tgt_sess.poses_local[i] for i in neigh_c])
        dev = self.device
        tgt_xyz, tgt_mask = assemble_submap(
            tgt_sess.scans_icp_xyz, tgt_sess.scans_icp_mask,
            torch.from_numpy(neigh_c).to(dev), torch.from_numpy(valid).to(dev),
            torch.from_numpy(rel.astype(np.float32)).to(dev),
            icp_cfg.submap_voxel_size, icp_cfg.target_capacity)
        return src_xyz, src_mask, tgt_xyz, tgt_mask

    def _log_iterations(self, it: np.ndarray) -> None:
        self.icp_iterations.extend(int(v) for v in it)
        log.info("ICP iterations over %d pairs: min %d / median %d / p90 %d / max %d",
                 len(it), it.min(), int(np.median(it)), int(np.percentile(it, 90)), it.max())

    def _run_icp_batches(self, pair_data, init_transforms, chunk: int = 8):
        """Fixed-shape ICPs in batches (the reference's OpenMP ICP farm,
        ``LTslam.cpp:389``); returns [(T, fitness, converged)]."""
        cfg = self.cfg.icp
        dev = self.device
        inits_np = np.asarray(init_transforms, np.float32)
        if cfg.coarse_iterations == 0 and len(pair_data) > 8:
            # lane-compacted farm over a sticky pow-2 lane bucket: pads are
            # EMPTY lanes (all-False masks), retired before the first segment
            B = len(pair_data)
            lanes = getattr(self, "_farm_lanes", 0)
            if B > lanes:
                lanes = 1 << max(4, (B - 1).bit_length())
                self._farm_lanes = lanes

            def pad_lanes(x, empty: bool):
                if lanes == x.shape[0]:
                    return x
                tail_shape = (lanes - x.shape[0],) + tuple(x.shape[1:])
                tail = x.new_zeros(tail_shape) if empty else x[:1].expand(tail_shape)
                return torch.cat([x, tail])

            res = icp_batch_compacted(
                pad_lanes(torch.stack([b[0] for b in pair_data]), empty=False),
                pad_lanes(torch.stack([b[1] for b in pair_data]), empty=True),
                pad_lanes(torch.stack([b[2] for b in pair_data]), empty=False),
                pad_lanes(torch.stack([b[3] for b in pair_data]), empty=True),
                pad_lanes(torch.from_numpy(inits_np).to(dev), empty=False),
                max_correspondence_distance=cfg.max_correspondence_distance,
                max_iterations=cfg.max_iterations,
                transformation_epsilon=cfg.transformation_epsilon,
                euclidean_fitness_epsilon=cfg.euclidean_fitness_epsilon,
                tile=4096, update_trim_distance=cfg.update_trim_distance,
                segment=cfg.compaction_segment)
            self._log_iterations(res.iterations.cpu().numpy()[:B])
            T = res.transform.cpu().numpy()
            fit = res.fitness.cpu().numpy()
            conv = res.converged.cpu().numpy()
            return [(T[b], float(fit[b]), bool(conv[b])) for b in range(B)]
        results = []
        iter_counts = []
        for c0 in range(0, len(pair_data), chunk):
            batch = pair_data[c0: c0 + chunk]
            inits = inits_np[c0: c0 + chunk]
            n_real = len(batch)
            if chunk - n_real:
                batch = batch + [batch[-1]] * (chunk - n_real)
                inits = np.concatenate([inits, np.repeat(inits[-1:], chunk - n_real, 0)])
            res = icp_batch(
                torch.stack([b[0] for b in batch]), torch.stack([b[1] for b in batch]),
                torch.stack([b[2] for b in batch]), torch.stack([b[3] for b in batch]),
                torch.from_numpy(inits).to(dev),
                max_correspondence_distance=cfg.max_correspondence_distance,
                max_iterations=cfg.max_iterations,
                transformation_epsilon=cfg.transformation_epsilon,
                euclidean_fitness_epsilon=cfg.euclidean_fitness_epsilon, tile=4096,
                update_trim_distance=cfg.update_trim_distance,
                coarse_iterations=cfg.coarse_iterations, coarse_stride=cfg.coarse_stride)
            T = res.transform.cpu().numpy()
            fit = res.fitness.cpu().numpy()
            conv = res.converged.cpu().numpy()
            iter_counts.extend(res.iterations.cpu().numpy()[:n_real].tolist())
            results.extend((T[b], float(fit[b]), bool(conv[b])) for b in range(n_real))
        if iter_counts:
            self._log_iterations(np.asarray(iter_counts))
        return results

    @staticmethod
    def _yaw_inits(pairs, yaws_by_src) -> np.ndarray:
        """ICP inits from the SC yaw estimates (the reference starts from
        identity, "TODO icp align with initial", ``LTslam.cpp:220``)."""
        yaws = np.asarray([-yaws_by_src[src] for (_, src) in pairs], np.float32)
        c, s = np.cos(yaws), np.sin(yaws)
        inits = np.tile(np.eye(4, dtype=np.float32), (len(pairs), 1, 1))
        inits[:, 0, 0] = c
        inits[:, 0, 1] = -s
        inits[:, 1, 0] = s
        inits[:, 1, 1] = c
        return inits

    def _accepts(self, fitness: float, conv: bool) -> bool:
        cfg = self.cfg
        return fitness < cfg.loop_fitness_score_threshold and (conv or not cfg.icp.require_converged)

    def _add_intra_session_loops(self, s_idx: int) -> int:
        """SC loop closure WITHIN one session (``detectLoopClosureID``,
        ``ltslam/src/Scancontext.cpp:327-418``), ICP-verified against the
        ±search submap in session-local coordinates, added as robust between
        factors (the g2o loop-edge form)."""
        cfg = self.cfg
        sess = self.sessions[s_idx]
        sc = cfg.scan_context
        loop_idx, _, yaw = sc_retrieval.detect_loops_intra_session(
            sess.descriptors, sess.node_valid, dist_threshold=sc.dist_threshold,
            num_exclude_recent=sc.num_exclude_recent, num_candidates=sc.num_candidates,
            full_shift_search=sc.full_shift_search, search_ratio=sc.search_ratio)
        loop_idx = loop_idx.cpu().numpy()
        yaw = yaw.cpu().numpy()
        pairs = [(int(loop_idx[s]), s) for s in range(sess.num_nodes) if loop_idx[s] >= 0]
        log.info("intra-session SC %s: %d candidate loops", sess.name, len(pairs))
        if not pairs:
            return 0
        pairs = self._equisample(pairs, cfg.num_sc_loops_upper_bound)
        data = [self._prepare_icp_pair(s_idx, src, s_idx, tgt, central_coords=False)
                for (tgt, src) in pairs]
        yaws = {s: float(yaw[s]) for s in range(sess.num_nodes)}
        results = self._run_icp_batches(data, self._yaw_inits(pairs, yaws))

        ef, et, er = sess.edges
        new_f, new_t = list(np.asarray(ef)), list(np.asarray(et))
        new_r = [np.asarray(r) for r in er]
        added = 0
        for (tgt, src), (T_icp, fitness, conv) in zip(pairs, results):
            if self._accepts(fitness, conv):
                # g2o loop-edge convention: measured = T_tgt^-1 T_src, keyed (tgt, src)
                new_f.append(tgt)
                new_t.append(src)
                new_r.append(np.asarray(T_icp, np.float64))
                added += 1
        sess.edges = (np.asarray(new_f, np.int32), np.asarray(new_t, np.int32), new_r)
        log.info("intra-session SC %s: %d/%d loops passed ICP", sess.name, added, len(pairs))
        self.diag[f"intra_loops_added_{sess.name}"] = added
        return added

    def _add_sc_loops(self, source_idx: int, sc_pairs, sc_yaws, target_idx: int = 0) -> int:
        cfg = self.cfg
        pairs = self._equisample(sc_pairs, cfg.num_sc_loops_upper_bound)
        if not pairs:
            return 0
        with stage_timer("ltslam.sc_loops.prepare", log):
            data = [self._prepare_icp_pair(source_idx, src, target_idx, tgt, central_coords=False)
                    for (tgt, src) in pairs]
        inits = self._yaw_inits(pairs, sc_yaws)
        with stage_timer("ltslam.sc_loops.icp", log):
            results = self._run_icp_batches(data, inits)

        added = 0
        for (tgt, src), (T_icp, fitness, conv) in zip(pairs, results):
            if self._accepts(fitness, conv):
                self.anchored.append((self._node_var(target_idx, tgt),
                                      self._node_var(source_idx, src),
                                      self._anchor_var(target_idx), self._anchor_var(source_idx),
                                      T_icp, cfg.robust_variances))
                added += 1
        log.info("SC loops: %d/%d passed ICP fitness < %.2f", added, len(pairs),
                 cfg.loop_fitness_score_threshold)
        self.diag[f"sc_loops_added_{self.sessions[source_idx].name}"] = added
        return added

    # ------------------------------------------------------------------
    # RS loops (info gain)
    # ------------------------------------------------------------------
    def _anchored_jacobians(self, node_t_vars, node_s_vars, source_idx: int):
        """H1, H2 of the anchored residual wrt the two node poses, one batched
        call over a pow-2-padded batch (``ltm``'s compile bucket)."""
        poses = self._last_poses
        n = len(node_t_vars)
        cap = 1 << max(0, (n - 1).bit_length())
        pad = cap - n
        dev = poses.device
        t_idx = torch.as_tensor(list(node_t_vars) + [node_t_vars[-1]] * pad, device=dev)
        s_idx = torch.as_tensor(list(node_s_vars) + [node_s_vars[-1]] * pad, device=dev)
        x1 = poses[t_idx]
        x2 = poses[s_idx]
        a1 = poses[self._anchor_var(0)].expand(x1.shape)
        a2 = poses[self._anchor_var(source_idx)].expand(x2.shape)
        H1, H2 = _anchored_jacobian_batch(x1, x2, a1, a2)
        return H1[:n], H2[:n]

    def _add_rs_loops(self, source_idx: int, rs_candidates: List[int]) -> int:
        cfg = self.cfg
        target, source = self.sessions[0], self.sessions[source_idx]
        anchor_q = self.anchors[source_idx]
        tgt_central = np.einsum("ij,njk->nik", self.anchors[0], target.poses_local)
        tgt_pos = tgt_central[:, :3, 3]

        # ball search in central coords (LTslam.cpp:467-476, radius 10 m)
        cand_pairs = []
        for s in rs_candidates:
            q_central = anchor_q @ source.poses_local[s]
            d = np.linalg.norm(tgt_pos - q_central[:3, 3], axis=1)
            in_ball = np.flatnonzero(d < cfg.rs_ball_radius)
            if len(in_ball):
                cand_pairs.append((s, in_ball))
        if not cand_pairs:
            return 0

        # marginals of every involved variable, batched
        uniq_t = sorted({int(t) for _, balls in cand_pairs for t in balls})
        uniq_s = sorted({s for s, _ in cand_pairs})
        all_vars = [self._node_var(0, t) for t in uniq_t] + \
                   [self._node_var(source_idx, s) for s in uniq_s]
        with stage_timer("ltslam.rs_loops.marginals", log):
            Sig = marginal_covariance(self._last_graph, self._last_poses, all_vars).cpu().numpy()
        sig_t = {t: Sig[i] for i, t in enumerate(uniq_t)}
        sig_s = {s: Sig[len(uniq_t) + i] for i, s in enumerate(uniq_s)}

        # info gain 0.5 log det(I + H1 Σ1 H1ᵀ + H2 Σ2 H2ᵀ)  (LTslam.cpp:441-447)
        flat = [(s, int(t)) for s, balls in cand_pairs for t in balls]
        H1, H2 = self._anchored_jacobians([self._node_var(0, t) for _, t in flat],
                                          [self._node_var(source_idx, s) for s, _ in flat],
                                          source_idx)
        H1, H2 = H1.cpu().numpy(), H2.cpu().numpy()
        gains = []
        for k, (s, t) in enumerate(flat):
            S = np.eye(6) + H1[k] @ sig_t[t] @ H1[k].T + H2[k] @ sig_s[s] @ H2[k].T
            sign, logdet = np.linalg.slogdet(S)
            gains.append(0.5 * logdet if sign > 0 else -np.inf)
        best: Dict[int, Tuple[int, float]] = {}
        for k, (s, t) in enumerate(flat):
            if s not in best or gains[k] > best[s][1]:
                best[s] = (t, gains[k])
        rs_pairs = [(t, s) for s, (t, _) in sorted(best.items())]
        rs_pairs = self._equisample(rs_pairs, cfg.num_rs_loops_upper_bound)

        with stage_timer("ltslam.rs_loops.icp", log):
            with stage_timer("ltslam.rs_loops.icp.prepare", log):
                data = [self._prepare_icp_pair(source_idx, src, 0, tgt, central_coords=True)
                        for (tgt, src) in rs_pairs]
                # start from the current relative estimate (identity error)
                inits = np.stack([
                    np.linalg.inv(self.anchors[0] @ target.poses_local[tgt])
                    @ (anchor_q @ source.poses_local[src])
                    for (tgt, src) in rs_pairs
                ]).astype(np.float32)
            with stage_timer("ltslam.rs_loops.icp.farm", log):
                results = self._run_icp_batches(data, inits)

        added = 0
        for (tgt, src), (T_icp, fitness, conv) in zip(rs_pairs, results):
            if self._accepts(fitness, conv):
                self.anchored.append((self._node_var(0, tgt), self._node_var(source_idx, src),
                                      self._anchor_var(0), self._anchor_var(source_idx),
                                      T_icp, cfg.robust_variances))
                added += 1
        log.info("RS loops: %d/%d passed ICP fitness", added, len(rs_pairs))
        self.diag["rs_loops_added"] = added
        return added

    # ------------------------------------------------------------------
    def _write_trajectories(self, save_directory: str, postfix: str):
        """``writeAllSessionsTrajectories`` (``LTslam.cpp:11-67``)."""
        os.makedirs(save_directory, exist_ok=True)
        for s_idx, sess in enumerate(self.sessions):
            local = sess.poses_local[: sess.num_nodes]
            central = np.einsum("ij,njk->nik", self.anchors[s_idx], local)
            write_kitti_poses(os.path.join(save_directory, f"{sess.name}_local_{postfix}.txt"), local)
            write_kitti_poses(os.path.join(save_directory, f"{sess.name}_central_{postfix}.txt"),
                              central)


def _anchored_resid(d1, d2, x1, x2, a1, a2, meas):
    h1 = se3.compose(a1, se3.retract(x1, d1))
    h2 = se3.compose(a2, se3.retract(x2, d2))
    return se3.local(meas, se3.between(h1, h2))


def _anchored_jacobian_batch(x1, x2, a1, a2):
    """Batched H1, H2 of the anchored between-residual at zero perturbation
    (``BetweenFactorWithAnchoring.h:86-100`` by forward-mode autodiff), with
    the measurement that makes the residual zero at the linearization
    point — the info-gain formula needs only the Jacobians."""
    meas = se3.between(se3.compose(a1, x1), se3.compose(a2, x2))
    zero = torch.zeros((x1.shape[0], 6), dtype=x1.dtype, device=x1.device)
    return vmap(jacfwd(_anchored_resid, argnums=(0, 1)))(zero, zero, x1, x2, a1, a2, meas)
