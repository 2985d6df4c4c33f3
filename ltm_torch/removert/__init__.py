from ltm_torch.removert.pipeline import Removerter, RemovertResult  # noqa: F401
from ltm_torch.removert.session import RemovertInput, RemovertSession  # noqa: F401
