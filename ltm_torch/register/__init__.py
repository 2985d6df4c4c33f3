"""Point-to-point ICP (port of ``ltm.register``)."""

from ltm_torch.register.icp import ICPResult, fitness_score, icp_batch, icp_batch_compacted, icp_point_to_point  # noqa: F401
