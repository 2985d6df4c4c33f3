from ltm_torch.core.config import (  # noqa: F401
    ICPConfig,
    LTSlamConfig,
    RemovertConfig,
    ScanContextConfig,
    SolverConfig,
)
