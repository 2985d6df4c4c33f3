"""Meshes of device slots, multi-process start-up, the sharded
LT-removert sweeps and kNN, and LT-SLAM's sharded Scan Context, ICP farm
and pose-graph solver (port of ``ltm.dist``)."""

from ltm_torch.dist.mesh import KF_AXIS, Mesh, make_mesh, mesh_from_config, pad_to_multiple  # noqa: F401
from ltm_torch.dist.init import initialize_multihost, is_multihost  # noqa: F401
from ltm_torch.dist.sharding import (  # noqa: F401
    icp_batch_sharded,
    knn_avg_sqdist_sharded,
    sc_distance_sharded,
    sweep_discrepancy_map_sharded,
    sweep_discrepancy_sharded,
)
from ltm_torch.dist.solver import pad_graph_for_mesh, solve_sharded  # noqa: F401
from ltm_torch.dist.removert import (  # noqa: F401
    block_fused_visibility_images_sharded,
    block_projected_scan_images_sharded,
    block_sweep_discrepancy_sharded,
    block_sweep_discrepancy_vs_images_sharded,
    block_sweep_visibility_sharded,
    chunk_knn_sqdists_sharded,
    fused_visibility_images_sharded,
    projected_scan_images_sharded,
    sweep_discrepancy_vs_images_sharded,
    sweep_visibility_sharded,
)
