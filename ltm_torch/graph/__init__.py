"""Pose-graph factors and the LM solver (port of ``ltm.graph``)."""

from ltm_torch.graph.factors import GraphData, build_graph_data  # noqa: F401
from ltm_torch.graph.solver import SolveInfo, marginal_covariance, solve  # noqa: F401
