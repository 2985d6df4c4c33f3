from ltm_torch.core.config import (  # noqa: F401
    ICPConfig,
    LTSlamConfig,
    RemovertConfig,
    ScanContextConfig,
    SolverConfig,
)
from ltm_torch.core.pointcloud import PointCloud  # noqa: F401
