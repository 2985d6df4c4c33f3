"""LT-SLAM (port of ``ltm.slam``)."""

from ltm_torch.slam.pipeline import LTSlam, LTSlamResult  # noqa: F401
from ltm_torch.slam.session import SlamSession  # noqa: F401
