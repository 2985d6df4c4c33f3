"""Typed configuration for the two pipelines (the port's own copy of
``ltm.core.config``: same dataclasses, same field names and defaults, so a
config built for one package converts to the other field for field).

The reference scatters its knobs across two ROS param servers
(``ltslam/src/RosParamServer.cpp:4-26``, ``ltremovert/src/RosParamServer.cpp:4-63``)
plus many hard-coded constants inside algorithm bodies (ICP search num 25 at
``ltslam/src/LTslam.cpp:199``, RS ball radius 10.0 at ``:471``, ND/PD filter
resolution 2.5 at ``:1397-1410``, reprojection alpha 3.0 at
``ltremovert/include/removert/Session.h:13`` ...).  Here every knob is an
explicit dataclass field with the reference default, loadable from YAML.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

__all__ = ["ScanContextConfig", "ICPConfig", "SolverConfig", "LTSlamConfig", "RemovertConfig", "load_yaml", "save_yaml"]


@dataclass
class ScanContextConfig:
    """Scan Context geometry (reference ``ltslam/include/ltslam/Scancontext.h:84-104``)."""

    num_ring: int = 20
    num_sector: int = 60
    max_radius: float = 80.0
    lidar_height: float = 2.0
    search_ratio: float = 0.1          # ±10% column-shift window around sector-key argmin
    dist_threshold: float = 0.3        # SC_DIST_THRES
    num_candidates: int = 3            # NUM_CANDIDATES_FROM_TREE
    num_exclude_recent: int = 30       # NUM_EXCLUDE_RECENT (intra-session)
    full_shift_search: bool = False    # True: search all shifts (superset of ref pruning)


@dataclass
class ICPConfig:
    """PCL IterativeClosestPoint settings (``ltslam/src/LTslam.cpp:206-211``)."""

    max_correspondence_distance: float = 150.0
    max_iterations: int = 100
    # PCL setTransformationEpsilon: tested on the INCREMENTAL per-iteration
    # transform (rotation cos >= 1-eps AND squared step translation <= eps,
    # DefaultConvergenceCriteria as wired by icp.hpp) — see register/icp.py
    transformation_epsilon: float = 1e-6
    # require ICPResult.converged for loop acceptance, mirroring the
    # reference's ``icp.hasConverged() && fitness < thr`` accept test
    # (``ltslam/src/LTslam.cpp:222``).  ltm's converged now carries PCL
    # hasConverged() semantics — true on any criterion exit (transform
    # epsilon, absolute-MSE epsilon, or max iterations; PCL's
    # failure_after_max_iter defaults false), false only for degenerate
    # inputs — so this default-on gate matches the reference exactly
    require_converged: bool = True
    # PCL setEuclideanFitnessEpsilon (``LTslam.cpp:210``): stop when the
    # correspondence MSE changes by less than this between iterations
    euclidean_fitness_epsilon: float = 1e-6
    # non-PCL extension: trim correspondences beyond this distance from the
    # rigid update (None = strict reference behavior)
    update_trim_distance: Optional[float] = None
    # coarse-to-fine schedule: >0 enables a first phase against every
    # coarse_stride-th target point (0 = strict reference behavior)
    coarse_iterations: int = 0
    coarse_stride: int = 4
    # submap assembly (``ltslam/src/LTslam.cpp:199``, ``ltslam/src/Session.cpp:18``)
    history_search_num: int = 25
    submap_voxel_size: float = 0.3
    # padded capacities (TPU fixed shapes)
    source_capacity: int = 4096
    target_capacity: int = 32768
    # lane-compaction round length of the batched ICP farm (iterations per
    # repack; see register.icp.icp_batch_compacted).  Each 32-lane chunk
    # runs to its slowest lane within a round, so the round length should
    # sit near the iteration MEDIAN (~4-5 with the PCL criteria firing),
    # not the 100-iteration cap (straggler lanes repack together next
    # round; TPU measurements in docs/PERF.md)
    compaction_segment: int = 6


@dataclass
class SolverConfig:
    """Levenberg-Marquardt + CG settings for the pose-graph solver."""

    max_outer_iterations: int = 30
    # inexact-Newton CG budget: LM needs only a loose inner solve (the step
    # is re-damped and re-linearized anyway); tol 1e-2 / 100 iters matched
    # the 1e-7 / 250 solution quality on the 1000-node benchmark graphs at
    # a third of the wall clock (and the SciPy-f64 oracle still passes)
    cg_iterations: int = 100
    cg_tol: float = 1e-2
    # "tridiag": block-tridiagonal (odometry-chain) preconditioner — the
    # exact normal matrix of the priors+odom subgraph plus diagonal terms,
    # solved by a block-Thomas scan.  Block-Jacobi ("jacobi") left CG at its
    # iteration cap on 500-node chains (residual ~0.3-0.8 vs tol 1e-2,
    # measured round 4); the chain preconditioner converges CG in ~10-20
    # iterations and makes LM steps near-exact Gauss-Newton.
    preconditioner: str = "tridiag"
    lambda_init: float = 1e-4
    lambda_up: float = 10.0
    lambda_down: float = 0.3
    # Cauchy robust kernel k (reference Cauchy::Create(1), ``LTslam.cpp:130``)
    cauchy_k: float = 1.0
    # mesh solves only — "schur": shards linearize their factor subset,
    # ONE collective wave per LM step replicates the compact 6×6-block
    # normal system, then every device eliminates the odometry chains
    # locally (block-Thomas) and runs comm-free CG.  "allreduce": the
    # matrix-free path with 2 psums per CG iteration (kept for
    # comparison; measured collective-bound beyond n=2, PERF.md).
    dist_mode: str = "schur"
    dtype: str = "float32"


@dataclass
class LTSlamConfig:
    """Mirrors ``ltslam/config/params.yaml`` + hard-coded constants."""

    sessions_dir: str = ""
    central_sess_name: str = "01"
    query_sess_name: str = "02"
    save_directory: str = "./out/"
    is_display_debug_msgs: bool = False
    loop_fitness_score_threshold: float = 0.7   # sample yaml value (default 0.5)
    num_sc_loops_upper_bound: int = 1000
    num_rs_loops_upper_bound: int = 0
    rs_ball_radius: float = 10.0                # hard-coded 10.0 (``LTslam.cpp:471``)
    pairwise_session_loops: bool = False        # N-session: also close loops between non-base pairs
    # detect intra-session SC loops (``SCManager::detectLoopClosureID``,
    # ``ltslam/src/Scancontext.cpp:327-418``) + ICP for sessions whose g2o
    # carries no loop edges, before anchoring — the reference assumes the
    # single-session SLAM already closed its own loops; this flag covers
    # odometry-only inputs
    use_intra_session_loops: bool = False

    # noise variances, tangent order [w, w, w, v, v, v] (``LTslam.cpp:100-133``)
    # prior_variances are realized as gauge-frozen variables (1e-12 variance
    # == pinned); loop_variances mirrors the reference's ``loopNoise``, which
    # the reference defines but never attaches to a factor (``LTslam.cpp:117``)
    prior_variances: Tuple[float, ...] = (1e-12,) * 6
    odom_variances: Tuple[float, ...] = (1e-4,) * 6
    loop_variances: Tuple[float, ...] = (1e-4, 1e-4, 1e-4, 1e-3, 1e-3, 1e-3)
    large_variances: Tuple[float, ...] = (9.8696044, 9.8696044, 9.8696044, 1e8, 1e8, 1e8)
    robust_variances: Tuple[float, ...] = (0.5,) * 6

    # padded capacities.  max_nodes_per_session=None auto-sizes (pow-2
    # bucket of the largest session); explicit values escalate with a
    # warning instead of raising — nothing is silently dropped.
    # scan_capacity=None auto-sizes to a pow-2 bucket of the largest scan
    # across the loaded sessions (full density, no truncation — the same
    # discipline as RemovertConfig); an explicit value caps with a warning
    # and deterministic stride subsampling (an explicitly chosen operating
    # point, e.g. for memory-constrained chips)
    max_nodes_per_session: Optional[int] = None
    scan_capacity: Optional[int] = None

    # device mesh: shard the hot loops (SC scoring, ICP batches, LM solve)
    # across this many local devices (None/1 = single device; -1 = all).
    # The reference's analog is its default-on OpenMP (``LTslam.cpp:389,534``).
    mesh_devices: Optional[int] = None

    scan_context: ScanContextConfig = field(default_factory=ScanContextConfig)
    icp: ICPConfig = field(default_factory=ICPConfig)
    solver: SolverConfig = field(default_factory=SolverConfig)


@dataclass
class RemovertConfig:
    """Mirrors ``ltremovert/config/params_ltmapper.yaml`` + constants."""

    central_sess_scan_dir: str = ""
    central_sess_pose_path: str = ""
    query_sess_scan_dir: str = ""
    query_sess_pose_path: str = ""
    save_pcd_directory: str = "./out/"
    save_map_pcd: bool = True
    save_clean_scans_pcd: bool = True

    # FOV / range-image
    vfov: float = 50.0
    hfov: float = 360.0
    remove_resolution_list: List[float] = field(default_factory=lambda: [2.5])
    revert_resolution_list: List[float] = field(default_factory=lambda: [2.2])
    repeat_removert_iter: int = 1
    use_self_removert: bool = False   # full remove/revert loop (selfRemovert)
    save_range_image_pngs: bool = False  # PNG analog of the rviz image topics
    save_high_dyn_maps: bool = True      # *_high_dyn.pcd knn scan extraction
    # range-image color axis (rimg_color_min/max in params_ltmapper.yaml)
    rimg_color_min: float = 0.0
    rimg_color_max: float = 20.0
    reprojection_alpha: float = 3.0          # Session.h:13 kReprojectionAlpha
    nd_pd_filter_resolution: float = 2.5     # Removerter.cpp:1397,1407
    nd_pd_filter_repeats: int = 3
    diff_threshold: float = 0.1              # default in calcDescrepancy...
    # kValidDiffUpperBound / kFlagNoPOINT are compile-time constants in the
    # reference too (utility.h:93-94); here they live in kernels/projection.py

    # keyframe parsing
    start_idx: int = 0
    end_idx: int = 10_000_000
    keyframe_gap: int = 1
    roi_inplace_threshold: float = 10.0      # parseKeyframesInROI inplace_thres

    # precleaning (``Removerter.cpp:1660``, ``Session.cpp:506-533``)
    preclean_radius: float = 2.5
    preclean_z_band: float = 0.5
    # batched preclean+downsample on device (one vmapped program; transfers
    # RAW scans — best when host<->device bandwidth is plentiful and host
    # CPU scarce).  False = thread-pooled native host prep with a transfer
    # of only the downsampled rows (~8x fewer bytes; best on thin links).
    device_scan_prep: bool = False

    # density / kNN
    downsample_voxel_size: float = 0.05
    num_knn_points: int = 2                  # kNumKnnPointsToCompare
    knn_avg_sqdist_threshold: float = 0.01   # kScanKnnAndMapKnnAvgDiffThreshold (squared m)
    weak_to_strong_sqdist_threshold: float = 1.0  # Session.cpp:469

    # grid-bucketed kNN (ltm.kernels.grid_knn): O(neighborhood) instead of
    # O(map^2) — the multi-million-point-map path.  Distances clamp at
    # grid_cell_size^2; decisions stay exact while
    # grid_cell_size^2 >= num_knn_points * max(threshold) (2 m covers the
    # defaults).  Brute force (default) is faster below ~1M-point maps.
    use_grid_knn: bool = False
    grid_cell_size: float = 2.0
    grid_n_cells: int = 1 << 19
    grid_cell_capacity: int = 64

    # chunked block kNN (ltm.kernels.chunk_knn): occupancy-adaptive fast path
    # for multi-million-point maps — Morton-sorted query chunks score against
    # block-culled neighborhoods of a kNN-grained block map built per target
    # subset.  Distances clamp at sqrt(num_knn_points·max(threshold)) so
    # every pipeline decision stays exact (see kernels/chunk_knn.py); chunks
    # whose neighborhood overflows k_blocks are re-run with brute force
    # (exactness never depends on the tuning constants).  Engages when the
    # padded target map is at least chunk_knn_min_targets.  In the port the
    # scan is a CUDA kernel (ltm_torch/kernels/chunk_knn.py).
    use_chunk_knn: bool = True
    chunk_knn_min_targets: int = 1 << 17
    chunk_knn_chunk: int = 256
    chunk_knn_k_blocks: int = 384
    chunk_knn_block_cell: float = 12.5
    chunk_knn_block_capacity: int = 128
    chunk_knn_block_slack: int = 4
    chunk_knn_sort_cell: float = 4.0

    # device mesh: shard the hot loops (visibility sweeps, kNN chunks)
    # across this many local devices (None/1 = single device; -1 = all).
    # The reference's analog is its default-on OpenMP (``Session.cpp:408,491``).
    mesh_devices: Optional[int] = None

    # extrinsic lidar->base (row-major 4x4)
    extrinsic_lidar_to_base: Tuple[float, ...] = (
        1.0, 0.0, 0.0, 0.0,
        0.0, 1.0, 0.0, 0.0,
        0.0, 0.0, 1.0, 0.0,
        0.0, 0.0, 0.0, 1.0,
    )

    # padded capacities (TPU fixed shapes).  ``None`` = auto-size from the
    # data (pow-2 bucketed to bound recompiles) — nothing is ever silently
    # truncated; explicitly set values escalate with a warning if the data
    # does not fit.
    max_keyframes: Optional[int] = None
    scan_capacity: int = 16384
    map_capacity: Optional[int] = None

    # block-structured map (ltm.kernels.blocks): per-keyframe locality for
    # the visibility sweeps — the big-map fast path, ON by default.
    # ``n_blocks``/``k_blocks`` auto-size from the real point count and the
    # session viewpoints (``required_k_blocks`` keeps sweeps exact).
    # ``block_max_range=None`` (default) derives the EXACT bound per sweep:
    # max_scan_range + diff_threshold for forward discrepancy, the farthest
    # block for visibility/winner projections, and the source visibility
    # bound (+ kValidDiffUpperBound when reversed) for the ND/PD image
    # filters — every block sweep then equals the whole-map sweep
    # bit-for-bit at ANY map scale.  An explicit float applies everywhere
    # (legacy; exact only while it upper-bounds the quantities above).
    use_block_map: bool = True
    block_cell_size: float = 25.0
    n_blocks: Optional[int] = None
    block_capacity: int = 256
    k_blocks: Optional[int] = None
    block_max_range: Optional[float] = None

    # occlusion-aware block culling (ltm.kernels.occlusion): on top of the
    # range-ball bounds, skip blocks whose minimum possible range cannot beat
    # the per-pixel image maxima over their angular footprint — provably
    # exact for every sweep (see the occlusion module docstring; equality
    # with the unculled pipeline is regression-tested).  The winner
    # projections run two-phase: blocks within ``occlusion_near_range``
    # (None = auto: the session's forward sweep bound) build a provisional
    # image that culls the far blocks.  OFF by default: on open geometry
    # (the corridor benchmark) sightlines reach the map's far end and the
    # cull passes cost more than they save (TPU measurements in
    # docs/PERF.md).  Not ported yet: the port raises when it is set.
    use_occlusion_culling: bool = False
    occlusion_near_range: Optional[float] = None


# ---------------------------------------------------------------------------
# YAML round-trip
# ---------------------------------------------------------------------------

def _from_dict(cls, d: dict):
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        if dataclasses.is_dataclass(f.type) or f.name in ("scan_context", "icp", "solver"):
            sub_cls = {"scan_context": ScanContextConfig, "icp": ICPConfig, "solver": SolverConfig}[f.name]
            v = _from_dict(sub_cls, v)
        kwargs[f.name] = v
    return cls(**kwargs)


def load_yaml(path: str, kind: str = "ltslam"):
    """Load an ``LTSlamConfig``/``RemovertConfig`` from a YAML file."""
    import yaml

    with open(path) as f:
        d = yaml.safe_load(f) or {}
    # tolerate a single top-level namespace key (reference yaml style)
    if len(d) == 1 and isinstance(next(iter(d.values())), dict):
        d = next(iter(d.values()))
    cls = LTSlamConfig if kind == "ltslam" else RemovertConfig
    return _from_dict(cls, d)


def save_yaml(cfg, path: str):
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump(dataclasses.asdict(cfg), f, sort_keys=False)
